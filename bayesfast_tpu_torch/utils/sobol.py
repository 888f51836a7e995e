"""Sobol quasi-Monte-Carlo sequence in torch.

Counterpart of ``bayesfast_tpu/utils/sobol.py``: the same Joe-Kuo (2008)
direction numbers (``joe_kuo_6.npz``, copied beside this file) and the same
closed form over the Gray code ``g(i) = i ^ (i >> 1)``:
``X_i = XOR_{b: bit b of g(i)} V[b]``. torch on the CPU has no ``>>`` for
uint32, so the integers are carried in int64 (all values stay below 2^32).
"""

import os

import numpy as np
import torch

from ..config import get_device, get_dtype

__all__ = ['uniform', 'multivariate_normal', 'sobol_uint32',
           'direction_numbers']

_TABLE_PATH = os.path.join(os.path.dirname(__file__), 'joe_kuo_6.npz')
_table = None
_V_cache = {}  # d -> np.ndarray (d, 32) uint32
_MAX_BITS = 32


def _load_table():
    global _table
    if _table is None:
        _table = np.load(_TABLE_PATH)
    return _table


def direction_numbers(d):
    """Dense direction-number matrix ``V`` of shape ``(d, 32)`` (uint32).

    ``V[j, b]`` is the direction number of dimension ``j`` for bit ``b``
    (scaled by 2^32); host numpy, identical to the JAX package's.
    """
    d = int(d)
    for cached_d in _V_cache:
        if cached_d >= d:
            return _V_cache[cached_d][:d]
    tab = _load_table()
    s_all, a_all, m_all, off = tab['s'], tab['a'], tab['m'], tab['off']
    if d - 1 > len(s_all):
        raise NotImplementedError(
            f'd = {d} is not supported: direction table has '
            f'{len(s_all) + 1} dimensions.')
    V = np.zeros((d, _MAX_BITS), dtype=np.uint32)
    V[0] = np.uint32(1) << (np.uint32(31)
                            - np.arange(_MAX_BITS, dtype=np.uint32))
    if d > 1:
        s = s_all[:d - 1].astype(np.int64)
        a = a_all[:d - 1].astype(np.uint32)
        for sv in np.unique(s):
            idx = np.nonzero(s == sv)[0]
            sv = int(sv)
            m = np.zeros((len(idx), sv), dtype=np.uint32)
            for row, j in enumerate(idx):
                o = int(off[j])
                m[row] = m_all[o:o + sv]
            Vg = np.zeros((len(idx), _MAX_BITS), dtype=np.uint32)
            ncopy = min(sv, _MAX_BITS)
            shifts = (np.uint32(32)
                      - np.arange(1, ncopy + 1, dtype=np.uint32))
            Vg[:, :ncopy] = m[:, :ncopy] << shifts[None, :]
            ag = a[idx]
            for i in range(sv, _MAX_BITS):
                v = Vg[:, i - sv] ^ (Vg[:, i - sv] >> np.uint32(sv))
                for k in range(1, sv):
                    bit = (ag >> np.uint32(sv - 1 - k)) & np.uint32(1)
                    v ^= bit * Vg[:, i - k]
                Vg[:, i] = v
            V[idx + 1] = Vg
    _V_cache.clear()
    _V_cache[d] = V
    return V


def _sobol_kernel(V, i0, n):
    """Gray-code Sobol integers for indices ``i0 .. i0+n-1``; (n, d) int64.

    ``V`` is an int64 (d, 32) tensor of direction numbers.
    """
    i = (torch.arange(n, dtype=torch.int64, device=V.device) + int(i0)) \
        & 0xFFFFFFFF
    g = i ^ (i >> 1)
    X = torch.zeros((n, V.shape[0]), dtype=torch.int64, device=V.device)
    for b in range(_MAX_BITS):
        mask = (g >> b) & 1
        X = X ^ (mask[:, None] * V[None, :, b])
    return X


def sobol_uint32(n, d, skip=0, device=None):
    """Raw Sobol integers (scaled by 2^32), as an int64 tensor (n, d) on
    ``device`` (default: ``config.get_device()``)."""
    V = torch.as_tensor(direction_numbers(d).astype(np.int64),
                        device=device or get_device())
    return _sobol_kernel(V, skip, int(n))


def _unit_points(size, d, skip, dtype):
    """Sobol points in ``[0, 1)`` as a (size, d) tensor of ``dtype`` on the
    configured device, the first ``skip`` points dropped."""
    return sobol_uint32(size, d, skip).to(dtype) * (2.0 ** -32)


def uniform(low, high, size, skip=1):
    """Sobol points rescaled to ``[low, high)``; numpy, shape ``(size, d)``.

    The first ``skip`` points (including the all-zero point 0) are dropped.
    """
    low = np.atleast_1d(low)
    high = np.atleast_1d(high)
    if not (low.ndim == 1 and low.shape == high.shape):
        raise ValueError('low and high should be 1-d arrays with the same '
                         f'shape, got {low.shape} and {high.shape}.')
    d = low.shape[0]
    size = int(size)
    skip = int(skip)
    if size <= 0:
        raise ValueError(f'size should be a positive int, instead of {size}.')
    if skip < 0:
        raise ValueError(f'skip should be a non-negative int, instead of '
                         f'{skip}.')
    dtype = get_dtype()
    pts = _unit_points(size, d, skip, dtype)
    pts = (torch.as_tensor(low, dtype=dtype, device=pts.device)
           + torch.as_tensor(high - low, dtype=dtype, device=pts.device)
           * pts)
    return pts.cpu().numpy()


def multivariate_normal(mean, cov, size, skip=1, chunk=1 << 18):
    """Sobol-QMC multivariate normal draws (eigh-factor scaling of
    ``ndtri``-mapped points), produced in chunks of at most ``chunk``."""
    mean = np.atleast_1d(mean)
    cov = np.atleast_2d(cov)
    d = mean.shape[0]
    if not (mean.shape == (d,) and cov.shape == (d, d)):
        raise ValueError('the shape of mean is not consistent with the shape '
                         'of cov.')
    size = int(size)
    a, w = np.linalg.eigh(np.asarray(cov, np.float64))
    a = np.clip(a, 0.0, None)
    dtype, device = get_dtype(), get_device()

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    out = np.empty((size, d), torch.empty((), dtype=dtype).numpy().dtype)
    for off in range(0, size, chunk):
        n = min(chunk, size - off)
        z = torch.special.ndtri(_unit_points(n, d, skip + off, dtype))
        res = t(mean) + (z * t(a ** 0.5)) @ t(w.T)
        out[off:off + n] = res.cpu().numpy()
    return out
