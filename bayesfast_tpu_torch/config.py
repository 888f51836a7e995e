"""Global configuration for bayesfast_tpu_torch.

Counterpart of ``bayesfast_tpu/config.py``. Three knobs:

* the floating dtype (``torch.float64`` by default, as the reference
  numpy package; the bench runs ``torch.float32``);
* the device the entry points run on: the first CUDA device unless
  ``set_device('cpu')`` asks for the CPU. Without a CUDA device,
  ``get_device()`` raises rather than run on the CPU unasked;
* which NUTS transition kernel the driver uses:
    'auto'  — CUDA tensors launch the hand-written kernels
              (``samplers/nuts_cuda.py``), CPU tensors run their plain
              torch versions;
    'cuda'  — always the kernels: a CPU tensor raises;
    'torch' — always the plain torch versions (on any device).

Matmul precision: the JAX package forces ``'highest'`` matmul precision
(``bayesfast_tpu/config.py:90-133``) because reduced-precision matmul noise
in a rotated density measured as a ~3x step-size penalty. The CUDA analog
is TF32, so both TF32 switches are turned off at import.
"""

import torch

__all__ = ['get_dtype', 'set_dtype', 'get_device', 'set_device',
           'get_nuts_kernel', 'set_nuts_kernel']

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_dtype = torch.float64
_DEFAULT_DEVICE = torch.device('cuda')
_device = _DEFAULT_DEVICE
_nuts_kernel = 'auto'


def get_dtype():
    """Active floating dtype."""
    return _dtype


def set_dtype(dtype):
    """Set the framework floating dtype (``None`` restores float64)."""
    global _dtype
    dtype = torch.float64 if dtype is None else dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError('dtype should be torch.float32 or torch.float64.')
    _dtype = dtype


def get_device():
    """Device that the entry points' tensors live on. Raises when it is a
    CUDA device and CUDA is unavailable: nothing moves to the CPU unless
    ``set_device('cpu')`` asked for it."""
    if _device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'bayesfast_tpu_torch runs on the GPU by default, and no CUDA '
            'device is available: call '
            "bayesfast_tpu_torch.config.set_device('cpu') to run on the CPU.")
    return _device


def set_device(device):
    """Set the device (``None`` restores the default, ``'cuda'``); returns
    the previous setting."""
    global _device
    old = _device
    _device = _DEFAULT_DEVICE if device is None else torch.device(device)
    return old


def set_nuts_kernel(mode):
    """Select the NUTS transition kernel: 'auto', 'cuda' or 'torch'."""
    global _nuts_kernel
    if mode not in ('auto', 'cuda', 'torch'):
        raise ValueError("nuts kernel should be 'auto', 'cuda' or 'torch'.")
    _nuts_kernel = mode


def get_nuts_kernel():
    return _nuts_kernel
