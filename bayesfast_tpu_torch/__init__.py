"""bayesfast_tpu_torch: the PyTorch / CUDA port of ``bayesfast_tpu``.

Posterior sampling (NUTS, HMC, tempered TNUTS / THMC, ChEES and the
ensemble, with checkpoint and resume), the surrogate Recipe (module pipelines,
polynomial surrogates, Laplace, importance sampling) and Gaussianized
evidence (GBS, GIS, GHM on the SIT flow) on one NVIDIA GPU: the same API
and numerics as the JAX package's paths, with its Pallas kernels rewritten
as hand-written CUDA C++ for Hopper (``csrc/nuts.cu``, ``csrc/kde.cu``,
built at first use).
The entry points run on the GPU unless ``config.set_device('cpu')`` asks
for the CPU, where every kernel runs as its plain torch version. This
package imports torch, numpy and scipy, never jax.
"""

__version__ = '0.1.0'

from . import config  # turns TF32 off: keep first
from . import utils
from . import ops
from . import samplers
from . import core
from . import modules
from . import transforms
from . import evidence
from .core import recipe   # ``bt.recipe.OptimizeStep`` etc.
from .core import *        # noqa: F401,F403
from .samplers import *    # noqa: F401,F403
from .modules import *     # noqa: F401,F403
from .evidence import *    # noqa: F401,F403
