"""Global configuration for bayesfast_tpu_torch.

Counterpart of ``bayesfast_tpu/config.py``. Four knobs:

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
    'torch' — always the plain torch versions (on any device);
* where the SIT fit's KDE-cdf sums run (``kde_on_device``,
  ``kde_device_route``): off, on the host library ``native/`` (C and
  OpenMP); on, on the device route, for data on a CUDA device at every
  size, and for data on the CPU (where the device route is the KDE
  kernel's plain version) from ``KDE_DEVICE_MIN`` elements up, as the JAX
  package chooses. Auto turns it on when the configured device is a CUDA
  device.

Matmul precision: the JAX package forces ``'highest'`` matmul precision
(``bayesfast_tpu/config.py:90-133``) because reduced-precision matmul noise
in a rotated density measured as a ~3x step-size penalty. The CUDA analog
is TF32, so both TF32 switches are turned off at import;
``set_matmul_precision`` switches them (``None``: back to what was active
before the import).
"""

import torch

__all__ = ['get_dtype', 'set_dtype', 'asarray', 'default_int', 'get_device',
           'set_device', 'get_nuts_kernel', 'set_nuts_kernel',
           'set_matmul_precision', 'kde_on_device', 'set_kde_device',
           'kde_device_route']


def _precision():
    # torch refuses to read it after the legacy matmul switch was set
    # following the new API; then there is no mode to restore
    try:
        return torch.get_float32_matmul_precision()
    except RuntimeError:
        return None


# what was active before this package set it
_prior_matmul = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32, _precision())
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def set_matmul_precision(mode='highest'):
    """Set the float32 matmul precision: ``'highest'`` (TF32 off in matmuls
    and cuDNN, the import's setting), ``'high'`` or ``'medium'`` (TF32 on),
    through ``torch.set_float32_matmul_precision`` and the cuDNN switch.
    ``None`` restores what was active before this package was
    imported."""
    if mode is None:
        cuda_tf32, cudnn_tf32, precision = _prior_matmul
        if precision is None:
            torch.backends.cuda.matmul.allow_tf32 = cuda_tf32
        else:
            torch.set_float32_matmul_precision(precision)
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        return
    mode = str(mode)
    if mode not in ('highest', 'high', 'medium'):
        raise ValueError("matmul precision should be 'highest', 'high', "
                         "'medium' or None.")
    torch.set_float32_matmul_precision(mode)
    torch.backends.cudnn.allow_tf32 = mode != 'highest'


_dtype = torch.float64
_DEFAULT_DEVICE = torch.device('cuda')
_device = _DEFAULT_DEVICE
_nuts_kernel = 'auto'
_kde_device = None  # None = auto (on when the configured device is CUDA)
#: the fewest elements (a SIT layer's rows x dimensions, a ``kde.cdf``
#: call's points x data) on the CPU that take the device route when
#: ``kde_on_device()`` (the JAX package's threshold)
KDE_DEVICE_MIN = 100_000


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


def asarray(x):
    """``x`` as a tensor of the configured dtype on the configured
    device."""
    return torch.as_tensor(x, dtype=get_dtype(), device=get_device())


def default_int():
    return torch.int32


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


def kde_on_device():
    """Whether the SIT fit's bulk KDE-cdf sums may run on the device (the
    KDE-cdf kernel) instead of the host library: ``set_kde_device``'s
    setting, or under auto whether ``get_device()`` is a CUDA device."""
    if _kde_device is not None:
        return _kde_device
    return get_device().type == 'cuda'


def set_kde_device(mode):
    """Force (True / False) or restore auto (None) the device KDE-cdf
    route."""
    global _kde_device
    _kde_device = None if mode is None else bool(mode)


def kde_device_route(n, device):
    """Whether KDE-cdf work of ``n`` elements on ``device`` takes the
    device route. Data on a CUDA device stays there at every size (on the
    H100 the device fit was the faster at every size measured,
    ``chip_smoke.py`` [19b]); on the CPU both routes run on the host, and
    the JAX package's threshold ``KDE_DEVICE_MIN`` chooses between them."""
    if not kde_on_device():
        return False
    return torch.device(device).type == 'cuda' or n >= KDE_DEVICE_MIN
