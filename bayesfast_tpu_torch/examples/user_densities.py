"""Five densities written as a user writes them, in torch, op for op as
the JAX scripts write them in jnp: ``bench.py:141-145``'s banana-32 and the
densities of ``examples/{banana,funnel,ring,cauchy}_gbs.py``. None of them
is compiled into the CUDA NUTS kernels: a ``DensityLite`` over one traces
it (``ops/trace.py``) and the kernels run the functor generated from the
trace (``ops/codegen.py``).

Each function returns ``(DensityLite, info)``: the bounds of its script
(``input_scales`` with ``hard_bounds=True``), ``input_size`` D, and
``info`` a dict of the script's constants (``A``, the rotation as a
float64 numpy array, for the bananas). Each logp is batched torch, ``(...,
D) -> (...)``; the JAX scripts write one point, and ``x[..., i]`` and
``dim=-1`` are their ``x[i]`` and ``jnp.sum`` on a batch. The closed-over
tensors keep the scripts' dtypes (bench.py's rotation is float32) and
follow ``x`` with ``.to(x)``.
"""

import math

import numpy as np
import torch
from scipy.stats import special_ortho_group

from ..core.density import DensityLite

__all__ = ['bench_banana', 'banana', 'funnel', 'ring', 'cauchy', 'DENSITIES']


def _bounded(logp, lower, upper):
    bound = np.stack((lower, upper)).T
    return DensityLite(logp=logp, input_size=bound.shape[0],
                       input_scales=bound, hard_bounds=True)


def _const(lower, upper):
    return float(np.sum(np.log(upper - lower)))


def bench_banana():
    """``bench.py:129-149``: the rotated banana-32 with Q = 0.01, a float32
    rotation ``special_ortho_group.rvs(32, random_state=0)``, the even-pair
    mask and ``roll``, bounds [-15, 15], less the log volume."""
    D, Q = 32, 0.01
    lower, upper = np.full(D, -15.), np.full(D, 15.)
    const = _const(lower, upper)
    A_np = special_ortho_group.rvs(D, random_state=0)
    A = torch.as_tensor(A_np, dtype=torch.float32)
    # even-pair mask formulation: same math as z[::2] / z[1::2]
    even = torch.as_tensor((np.arange(D) % 2) == 0, dtype=torch.float32)

    def logp(x):
        z = x @ A.to(x).T
        zn = torch.roll(z, -1, dims=-1)
        t = (z * z - zn) ** 2 / Q + (z - 1.0) ** 2
        return -torch.sum(t * even.to(x), dim=-1) - const

    return _bounded(logp, lower, upper), {'A': A_np, 'Q': Q, 'const': const}


def banana():
    """``examples/banana_gbs.py``: the rotated banana-32 with strided
    slices, a float64 rotation, bounds [-15, 15]."""
    D, Q = 32, 0.01
    lower, upper = np.full(D, -15.), np.full(D, 15.)
    const = _const(lower, upper)
    A_np = special_ortho_group.rvs(D, random_state=0)
    A = torch.as_tensor(A_np)

    def logp(x):
        x = x @ A.to(x).T
        return (-torch.sum((x[..., ::2] ** 2 - x[..., 1::2]) ** 2 / Q
                           + (x[..., ::2] - 1) ** 2, dim=-1) - const)

    return _bounded(logp, lower, upper), {'A': A_np, 'Q': Q, 'const': const}


def funnel():
    """``examples/funnel_gbs.py:23-29``: Neal's funnel-16 (a = 1, b =
    0.5), bounds [-4, 4] on x0 and [-30, 30] elsewhere."""
    D, a, b = 16, 1., 0.5
    lower, upper = np.full(D, -30.), np.full(D, 30.)
    lower[0], upper[0] = -4, 4
    const = _const(lower, upper)

    def logp(x):
        n = D
        _a = -0.5 * x[..., 0] ** 2 / a ** 2
        _b = -0.5 * torch.sum(x[..., 1:] ** 2, dim=-1) * torch.exp(
            -2 * b * x[..., 0])
        _c = (-0.5 * math.log(2 * math.pi * a ** 2)
              - 0.5 * (n - 1) * math.log(2 * math.pi) - (n - 1) * b
              * x[..., 0])
        return _a + _b + _c - const

    return _bounded(logp, lower, upper), {'const': const}


def ring():
    """``examples/ring_gbs.py:22-25``: the ring-64 (a = 2, b = 1), its
    neighbours by a ``cat`` of the wrapped ends, bounds [-5, 5]."""
    D, a, b = 64, 2., 1.
    lower, upper = np.full(D, -5.), np.full(D, 5.)
    const = _const(lower, upper)

    def logp(x):
        x2 = x * x
        x2s = torch.cat((x2[..., -1:], x2, x2[..., :1]), dim=-1)
        return -torch.sum((x2s[..., :-2] + x2s[..., 1:-1] - a) ** 2 / b,
                          dim=-1) - const

    return _bounded(logp, lower, upper), {'const': const}


def cauchy():
    """``examples/cauchy_gbs.py:23-27``: the bimodal Cauchy-48 (a = 5),
    bounds [-100, 100]."""
    D, a = 48, 5.
    lower, upper = np.full(D, -100.), np.full(D, 100.)
    const = _const(lower, upper)

    def logp(x):
        _a = 1 / ((x + a) ** 2 + 1)
        _b = 1 / ((x - a) ** 2 + 1)
        return (torch.sum(torch.log(_a + _b), dim=-1)
                + D * math.log(0.5 / math.pi) - const)

    return _bounded(logp, lower, upper), {'const': const}


#: the five, by name
DENSITIES = {'bench_banana': bench_banana, 'banana': banana,
             'funnel': funnel, 'ring': ring, 'cauchy': cauchy}
