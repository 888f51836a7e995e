"""Weighted Gaussian-KDE cdf: the CUDA kernel and its plain torch version.

Counterpart of ``bayesfast_tpu/ops/kde_pallas.py``. The SIT flow fit
evaluates ``cdf(x) = sum_n w_n Phi((x - d_n) / h)`` at every spline knot of
every dimension and flow layer, an O(n_x * n_data) reduction.
``kde_cdf_batch`` computes it for a batch of columns with shared weights:
on CUDA tensors it launches the hand-written kernel ``csrc/kde.cu`` (which
replaces the Pallas kernel ``kde_pallas.py:50``); on CPU tensors it runs
the plain version ``kde_cdf_batch_plain``. Both take every term as
``(w / 2) * (1 + erf((x - d) * c))`` with ``c = sqrt(1/2) / h``, sum the
terms in the input dtype in groups of ``_GROUP`` consecutive points, add
the groups into float64 sums over splits of the points (``_plan``), and
add the splits in order, so on the card the two agree bit for bit. Phi
takes one of two forms: ``'exact'`` (the erf, the SIT fit's form) or
``'as'`` (the Abramowitz & Stegun 7.1.26 erf of the Pallas kernel).
"""

import torch

__all__ = ['kde_cdf_batch', 'kde_cdf_device', 'kde_cdf_batch_plain']

_SQRT1_2 = 0.7071067811865476
_ERFS = ('exact', 'as')
# terms summed in the input dtype before a float64 add (``kG`` in
# csrc/kde.cu), and the most points of one split
_GROUP = 16
_SPLIT_N = 512
# elements of one (S, D, M, chunk) intermediate of the plain version
_PLAIN_CHUNK = 1 << 22


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


def _plan(N):
    """``(S, P)``: the points in S splits of P (the last one may be short),
    P a multiple of ``_GROUP`` and at most ``_SPLIT_N``. It depends on N
    alone, so the result does not depend on the device."""
    P = min(_SPLIT_N, -(-N // _GROUP) * _GROUP)
    return -(-N // P), P


def _scales(w, h):
    """The kernel's per-point and per-column factors: ``w / 2`` and
    ``sqrt(1/2) / h`` (a tensor division, correctly rounded on the CPU and
    on the card alike)."""
    return w * 0.5, torch.full_like(h, _SQRT1_2) / h


def kde_cdf_batch_plain(x, data, w, h, erf='exact'):
    """The kernel's plain torch version: ``x`` (D, M) queries, ``data``
    (D, N) per-column points, ``w`` (N,) shared weights, ``h`` (D,)
    bandwidths, one dtype; returns (D, M) in that dtype. Every term and
    every sum as ``csrc/kde.cu`` takes them: the points padded with zero
    weights to S splits of P, each split's terms added in the input dtype
    in groups of ``_GROUP``, the groups into a float64 sum per split, the
    splits in order."""
    D, M = x.shape
    N = data.shape[1]
    S, P = _plan(N)
    G = _GROUP
    hw, c = _scales(w, h)
    pad = S * P - N
    dp = torch.nn.functional.pad(data, (0, pad)).reshape(D, S, P)
    dp = dp.transpose(0, 1)[:, :, None, :]                 # (S, D, 1, P)
    wp = torch.nn.functional.pad(hw, (0, pad)).reshape(S, 1, 1, P)
    xs, cs = x[None, :, :, None], c[None, :, None, None]
    erf_fn = torch.special.erf if erf == 'exact' else _erf_as
    # points per step: a multiple of G that keeps the intermediates small
    step = G * max(1, min(P // G, _PLAIN_CHUNK // (S * D * M * G)))
    acc = torch.zeros((S, D, M), dtype=torch.float64, device=x.device)
    for j in range(0, P, step):
        z = (xs - dp[..., j:j + step]) * cs
        t = wp[..., j:j + step] * (1.0 + erf_fn(z))
        t = t.reshape(S, D, M, -1, G)
        g = torch.zeros(t.shape[:-1], dtype=x.dtype, device=x.device)
        for k in range(G):
            g = g + t[..., k]
        for i in range(g.shape[-1]):
            acc = acc + g[..., i].double()
    out = torch.zeros((D, M), dtype=torch.float64, device=x.device)
    for s_ in range(S):
        out = out + acc[s_]
    return out.to(x.dtype)


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


def _launch(x, data, w, h, erf):
    from .._build import load_library
    D, M = x.shape
    N = data.shape[1]
    S, P = _plan(N)
    x, data = x.contiguous(), data.contiguous()
    hw, c = (t.contiguous() for t in _scales(w, h))
    part = torch.empty((S, D, M), dtype=torch.float64, device=x.device)
    out = torch.empty((D, M), dtype=x.dtype, device=x.device)
    lib = load_library('kde')
    err = lib.kde_cdf_launch(
        1 if x.dtype == torch.float64 else 0, 1 if erf == 'exact' else 0,
        D, M, N, S, P, x.data_ptr(), data.data_ptr(),
        hw.data_ptr(), c.data_ptr(), part.data_ptr(), out.data_ptr(),
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
