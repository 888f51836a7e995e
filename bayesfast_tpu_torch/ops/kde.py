"""Weighted Gaussian-KDE cdf: the CUDA kernel and its plain torch version.

Counterpart of ``bayesfast_tpu/ops/kde_pallas.py``. The SIT flow fit
evaluates ``cdf(x) = sum_n w_n Phi((x - d_n) / h)`` at every spline knot of
every dimension and flow layer, an O(n_x * n_data) reduction.
``kde_cdf_batch`` computes it for a batch of columns with shared weights:
on CUDA tensors it launches the hand-written kernel ``csrc/kde.cu`` (which
replaces the Pallas kernel ``kde_pallas.py:50``); on CPU tensors it runs
the plain version ``kde_cdf_batch_plain``, blocked over the data like
``kde_pallas._cdf_batch_impl``. Both sum in float64 whatever the input
dtype, and both take Phi in one of two forms: ``'exact'`` (the erf, the
SIT fit's form) or ``'as'`` (the Abramowitz & Stegun 7.1.26 erf of the
Pallas kernel).
"""

import torch

__all__ = ['kde_cdf_batch', 'kde_cdf_device', 'kde_cdf_batch_plain']

_SQRT1_2 = 0.7071067811865476
_BLK_N = 1024
_ERFS = ('exact', 'as')


def _erf_as(x):
    """Abramowitz & Stegun 7.1.26 rational erf (|err| < 1.5e-7), as
    ``kde_pallas._erf_approx`` and ``csrc/kde.cu::erf_as`` compute it."""
    a1, a2, a3, a4, a5 = (0.254829592, -0.284496736, 1.421413741,
                          -1.453152027, 1.061405429)
    p = 0.3275911
    sign = torch.sign(x)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + p * ax)
    poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t
    return sign * (1.0 - poly * torch.exp(-ax * ax))


def _phi(z, erf):
    z = z * _SQRT1_2
    e = torch.special.erf(z) if erf == 'exact' else _erf_as(z)
    return 0.5 * (1.0 + e)


def kde_cdf_batch_plain(x, data, w, h, erf='exact'):
    """The kernel's plain torch version: ``x`` (D, M) queries, ``data``
    (D, N) per-column points, ``w`` (N,) shared weights, ``h`` (D,)
    bandwidths, one dtype. Blocked over N, each Phi in the input dtype, the
    sum in float64; returns (D, M) in the input dtype."""
    D, M = x.shape
    acc = torch.zeros((D, M), dtype=torch.float64, device=x.device)
    for j in range(0, data.shape[1], _BLK_N):
        z = (x[:, :, None] - data[:, None, j:j + _BLK_N]) / h[:, None, None]
        acc += _phi(z, erf).double() @ w[j:j + _BLK_N].double()
    return acc.to(x.dtype)


def _check(x, data, w, h):
    x = torch.as_tensor(x)
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f'kde_cdf: x should be float32 or float64, got '
                         f'{x.dtype}.')
    if x.dim() != 2 or data.dim() != 2 or w.dim() != 1 or h.dim() != 1:
        raise ValueError('kde_cdf: expected x (D, M), data (D, N), w (N,), '
                         'h (D,).')
    D, M = x.shape
    N = data.shape[1]
    if data.shape[0] != D or w.shape[0] != N or h.shape[0] != D:
        raise ValueError(f'kde_cdf: inconsistent shapes x {tuple(x.shape)}, '
                         f'data {tuple(data.shape)}, w {tuple(w.shape)}, '
                         f'h {tuple(h.shape)}.')
    for name, t in (('data', data), ('w', w), ('h', h)):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f'kde_cdf: {name} is {t.dtype} on {t.device}, '
                             f'x is {x.dtype} on {x.device}.')
    return x


def _splits(D, M, N, device):
    """Splits of the points (grid z) so that about 8 blocks of 128 queries
    run on each SM, with at least 1024 points in a split."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = D * -(-M // 128)
    return max(1, min(-(-8 * sms // blocks), -(-N // 1024), 65535))


def _launch(x, data, w, h, erf):
    from .._build import load_library
    D, M = x.shape
    N = data.shape[1]
    S = _splits(D, M, N, x.device)
    x, data, w, h = (t.contiguous() for t in (x, data, w, h))
    part = torch.empty((S, D, M), dtype=torch.float64, device=x.device)
    out = torch.empty((D, M), dtype=x.dtype, device=x.device)
    lib = load_library('kde')
    err = lib.kde_cdf_launch(
        1 if x.dtype == torch.float64 else 0, 1 if erf == 'exact' else 0,
        D, M, N, S, x.data_ptr(), data.data_ptr(), w.data_ptr(),
        h.data_ptr(), part.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'kde_cdf_launch failed: CUDA error {err} '
                           f'({lib.kde_error_string(err).decode()}).')
    return out


def kde_cdf_batch(x, data, w, h, erf='exact'):
    """Weighted KDE cdf of D columns: ``out[d, m] = sum_n w[n]
    Phi((x[d, m] - data[d, n]) / h[d])``. ``x`` (D, M), ``data`` (D, N),
    ``w`` (N,), ``h`` (D,), tensors of one dtype on one device. CUDA
    tensors launch ``csrc/kde.cu`` (counted in ``kde_cdf_batch.launches``);
    CPU tensors run ``kde_cdf_batch_plain``."""
    if erf not in _ERFS:
        raise ValueError(f"erf should be 'exact' or 'as', got {erf!r}.")
    x = _check(x, data, w, h)
    if x.shape[0] == 0 or x.shape[1] == 0 or data.shape[1] == 0:
        return torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    if x.is_cuda:
        out = _launch(x, data, w, h, erf)
        kde_cdf_batch.launches += 1
        return out
    return kde_cdf_batch_plain(x, data, w, h, erf)


kde_cdf_batch.launches = 0


def kde_cdf_device(x, data, w, h, erf='exact'):
    """The weighted 1-d KDE cdf, the D = 1 case of ``kde_cdf_batch``:
    ``x`` (M,), ``data`` (N,), ``w`` (N,), ``h`` a scalar. ``erf='as'``
    computes what the Pallas kernel ``kde_pallas._pallas_kernel``
    computes."""
    x = torch.as_tensor(x)
    h = torch.as_tensor(h, dtype=x.dtype, device=x.device).reshape(1)
    return kde_cdf_batch(x.reshape(1, -1), data.reshape(1, -1), w, h,
                         erf)[0]
