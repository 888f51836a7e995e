"""Two Gaussian targets past the CUDA NUTS kernels' old D = 64, each made
from its seed with numpy and scipy (nothing to download):

* ``neal_100``: Neal (2011), "MCMC using Hamiltonian dynamics", Handbook
  of MCMC ch. 5: 100 independent coordinates, mean 0, standard deviations
  0.01, 0.02, ..., 1.00. The compiled-in ``DiagGaussian``
  (``ops/densities.py``), so the kernels run it at NE = 4 from a unit of
  its own (``samplers/nuts_cuda.py::wide_unit_source``).
* ``mvn_250``: Hoffman & Gelman (2014), "The No-U-Turn Sampler", JMLR 15,
  section 4.1: a 250-d zero-mean Gaussian whose precision P is a draw of
  a Wishart with identity scale and 250 degrees of freedom
  (``scipy.stats.wishart(df=250, scale=np.eye(250)).rvs(random_state=0)``,
  float64). Its logp is the user's own torch function, ``-0.5 x' P x``
  written for a batch, so the kernels run it traced (``ops/trace.py``,
  ``ops/codegen.py``) at NE = 8; P does not fit a block's shared memory,
  so each chain reads it from L2.

Neither has bounds. Each function returns ``(DensityLite, info)``, with
the numpy arrays the density is built from in ``info``.
"""

import numpy as np
import torch
from scipy.stats import wishart

from ..core.density import DensityLite
from ..ops.densities import DiagGaussian

__all__ = ['neal_100', 'mvn_250']


def neal_100():
    """Neal's 100-d Gaussian: ``DiagGaussian(0, sd^2)``, sd = 0.01 (1 ..
    100). ``info``: ``sd``."""
    sd = 0.01 * np.arange(1, 101)
    return (DensityLite(logp=DiagGaussian(np.zeros(100), sd ** 2),
                        input_size=100), {'sd': sd})


def mvn_250(seed=0):
    """Hoffman & Gelman's 250-d MVN: logp = -0.5 x' P x with P the
    Wishart(250, I) draw of ``seed``, as a user writes it in torch over a
    batch ``(..., 250)``. ``info``: ``P`` (float64)."""
    D = 250
    P_np = wishart(df=D, scale=np.eye(D)).rvs(random_state=seed)
    P = torch.as_tensor(P_np)

    def logp(x):
        return -0.5 * torch.sum((x @ P.to(x)) * x, dim=-1)

    return DensityLite(logp=logp, input_size=D), {'P': P_np}
