"""bayesfast_tpu_torch: the PyTorch / CUDA port of ``bayesfast_tpu``.

NUTS posterior sampling on one NVIDIA GPU: the same API and numerics as the
JAX package's sampling path, with its two Pallas chunk kernels rewritten as
hand-written CUDA C++ for Hopper (``csrc/nuts.cu``, built at first use).
On CPU tensors every kernel runs as its plain torch version. This package
imports torch, numpy and scipy, never jax.
"""

__version__ = '0.1.0'

from . import config  # turns TF32 off: keep first
from . import utils
from . import ops
from . import samplers
from . import core
from .core import *        # noqa: F401,F403
from .samplers import *    # noqa: F401,F403
