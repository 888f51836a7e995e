"""Bounded <-> unbounded constraint transforms in torch.

Counterpart of ``bayesfast_tpu/ops/constraint.py``. With
``t = (x - lo) / (hi - lo)`` and bound flags (lower, upper):
  * both bounds:  y = logit(t)
  * lower only:   y = log(t)
  * upper only:   y = log(1 - t)
  * no bounds:    y = t   (pure affine rescale)
and ``to_original`` is the inverse mapped back through the affine rescale.

Out-of-bound inputs produce nan/inf instead of raising; the sampler treats a
non-finite logp as a divergence. ``scales`` is ``None`` (identity) or an
``(n, 2)`` array of [lo, hi]; ``hard_bounds`` is a bool, or an
``(n,)``/``(n, 2)`` bool array.

The six torch transforms take tensors; their numpy twins serve the host-side
trace bookkeeping. ``to_original_with_logdet`` is the sampler hot path: a
``torch.autograd.Function`` whose backward is the rational map of the JAX
package's custom JVP.
"""

import numpy as np
import torch

from ..config import get_dtype

__all__ = [
    'normalize_scales', 'normalize_bounds',
    'from_original', 'from_original_grad', 'from_original_grad2',
    'to_original', 'to_original_grad', 'to_original_grad2',
    'np_from_original', 'np_from_original_grad', 'np_from_original_grad2',
    'np_to_original', 'np_to_original_grad', 'np_to_original_grad2',
    'to_original_with_logdet', 'fused_params',
]


def normalize_scales(scales):
    """Return scales as an (n, 2) float array, or None."""
    if scales is None:
        return None
    scales = np.asarray(scales, dtype=np.float64)
    if scales.ndim == 1:
        scales = np.stack([np.zeros_like(scales), scales], axis=-1)
    if not (scales.ndim == 2 and scales.shape[-1] == 2):
        raise ValueError('I do not know how to interpret the shape of '
                         'input_scales.')
    return scales


def normalize_bounds(bounds, n):
    """Return hard_bounds as an (n, 2) bool array."""
    if isinstance(bounds, bool):
        return np.full((n, 2), bounds)
    bounds = np.atleast_1d(bounds).astype(bool)
    if bounds.ndim == 1:
        bounds = np.stack([bounds, bounds], axis=-1)
    if not (bounds.ndim == 2 and bounds.shape[-1] == 2):
        raise ValueError('I do not know how to interpret the shape of '
                         'hard_bounds.')
    return bounds


def _prep(x, scales, bounds):
    x = torch.as_tensor(x, dtype=get_dtype())
    lo = torch.as_tensor(scales[:, 0], dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(scales[:, 1], dtype=x.dtype, device=x.device)
    b = normalize_bounds(bounds, scales.shape[0])
    has_lo = torch.as_tensor(b[:, 0], device=x.device)
    has_hi = torch.as_tensor(b[:, 1], device=x.device)
    return x, lo, hi - lo, has_lo, has_hi


def from_original(x, scales, bounds):
    """Map original (bounded) coordinates to unbounded sampling coordinates."""
    if scales is None:
        return torch.as_tensor(x, dtype=get_dtype())
    x, lo, width, has_lo, has_hi = _prep(x, scales, bounds)
    t = (x - lo) / width
    y = torch.where(has_lo & has_hi, torch.log(t) - torch.log1p(-t), t)
    y = torch.where(has_lo & ~has_hi, torch.log(t), y)
    y = torch.where(~has_lo & has_hi, torch.log1p(-t), y)
    return y


def from_original_grad(x, scales, bounds):
    """d(from_original)/dx, elementwise (the Jacobian is diagonal)."""
    if scales is None:
        return torch.ones_like(torch.as_tensor(x, dtype=get_dtype()))
    x, lo, width, has_lo, has_hi = _prep(x, scales, bounds)
    t = (x - lo) / width
    g = torch.where(has_lo & has_hi, 1.0 / (t * (1.0 - t)),
                    torch.ones_like(t))
    g = torch.where(has_lo & ~has_hi, 1.0 / t, g)
    g = torch.where(~has_lo & has_hi, 1.0 / (t - 1.0), g)
    return g / width


def from_original_grad2(x, scales, bounds):
    """d2(from_original)/dx2, elementwise."""
    if scales is None:
        return torch.zeros_like(torch.as_tensor(x, dtype=get_dtype()))
    x, lo, width, has_lo, has_hi = _prep(x, scales, bounds)
    t = (x - lo) / width
    omt = 1.0 - t
    g = torch.where(has_lo & has_hi, (2.0 * t - 1.0) / (t * t * omt * omt),
                    torch.zeros_like(t))
    g = torch.where(has_lo & ~has_hi, -1.0 / (t * t), g)
    g = torch.where(~has_lo & has_hi, 1.0 / ((t - 1.0) * omt), g)
    return g / (width * width)


def to_original(x, scales, bounds):
    """Map unbounded sampling coordinates back to original coordinates."""
    if scales is None:
        return torch.as_tensor(x, dtype=get_dtype())
    x, lo, width, has_lo, has_hi = _prep(x, scales, bounds)
    t = torch.where(has_lo & has_hi, 1.0 / (1.0 + torch.exp(-x)), x)
    t = torch.where(has_lo & ~has_hi, torch.exp(x), t)
    t = torch.where(~has_lo & has_hi, 1.0 - torch.exp(x), t)
    return lo + t * width


def to_original_grad(x, scales, bounds):
    """d(to_original)/dx, elementwise."""
    if scales is None:
        return torch.ones_like(torch.as_tensor(x, dtype=get_dtype()))
    x, lo, width, has_lo, has_hi = _prep(x, scales, bounds)
    sig = 1.0 / (1.0 + torch.exp(-x))
    g = torch.where(has_lo & has_hi, sig * (1.0 - sig), torch.ones_like(x))
    g = torch.where(has_lo & ~has_hi, torch.exp(x), g)
    g = torch.where(~has_lo & has_hi, -torch.exp(x), g)
    return g * width


def to_original_grad2(x, scales, bounds):
    """d2(to_original)/dx2, elementwise."""
    if scales is None:
        return torch.zeros_like(torch.as_tensor(x, dtype=get_dtype()))
    x, lo, width, has_lo, has_hi = _prep(x, scales, bounds)
    ex = torch.exp(x)
    g = torch.where(has_lo & has_hi,
                    -ex * (ex - 1.0) / ((ex + 1.0) ** 3),
                    torch.zeros_like(x))
    g = torch.where(has_lo & ~has_hi, ex, g)
    g = torch.where(~has_lo & has_hi, -ex, g)
    return g * width


# ---------------------------------------------------------------------------
# Numpy twins of the six transforms, for host-side trace bookkeeping.

def _np_prep(x, scales, bounds):
    dtype = torch.empty((), dtype=get_dtype()).numpy().dtype
    x = np.asarray(x, dtype)
    lo = np.asarray(scales[:, 0], dtype)
    hi = np.asarray(scales[:, 1], dtype)
    b = normalize_bounds(bounds, scales.shape[0])
    return x, lo, hi - lo, b[:, 0], b[:, 1]


def np_from_original(x, scales, bounds):
    if scales is None:
        return np.asarray(x)
    x, lo, width, has_lo, has_hi = _np_prep(x, scales, bounds)
    with np.errstate(divide='ignore', invalid='ignore'):
        t = (x - lo) / width
        y = np.where(has_lo & has_hi, np.log(t) - np.log1p(-t), t)
        y = np.where(has_lo & ~has_hi, np.log(t), y)
        y = np.where(~has_lo & has_hi, np.log1p(-t), y)
    return y


def np_from_original_grad(x, scales, bounds):
    if scales is None:
        return np.ones_like(np.asarray(x))
    x, lo, width, has_lo, has_hi = _np_prep(x, scales, bounds)
    with np.errstate(divide='ignore', invalid='ignore'):
        t = (x - lo) / width
        g = np.where(has_lo & has_hi, 1.0 / (t * (1.0 - t)),
                     np.ones_like(t))
        g = np.where(has_lo & ~has_hi, 1.0 / t, g)
        g = np.where(~has_lo & has_hi, 1.0 / (t - 1.0), g)
    return g / width


def np_from_original_grad2(x, scales, bounds):
    if scales is None:
        return np.zeros_like(np.asarray(x))
    x, lo, width, has_lo, has_hi = _np_prep(x, scales, bounds)
    with np.errstate(divide='ignore', invalid='ignore'):
        t = (x - lo) / width
        omt = 1.0 - t
        g = np.where(has_lo & has_hi, (2.0 * t - 1.0) / (t * t * omt * omt),
                     np.zeros_like(t))
        g = np.where(has_lo & ~has_hi, -1.0 / (t * t), g)
        g = np.where(~has_lo & has_hi, 1.0 / ((t - 1.0) * omt), g)
    return g / (width * width)


def np_to_original(x, scales, bounds):
    if scales is None:
        return np.asarray(x)
    x, lo, width, has_lo, has_hi = _np_prep(x, scales, bounds)
    with np.errstate(over='ignore'):
        t = np.where(has_lo & has_hi, 1.0 / (1.0 + np.exp(-x)), x)
        t = np.where(has_lo & ~has_hi, np.exp(np.where(
            has_lo & ~has_hi, x, 0.0)), t)
        t = np.where(~has_lo & has_hi, 1.0 - np.exp(np.where(
            ~has_lo & has_hi, x, 0.0)), t)
    return lo + t * width


def np_to_original_grad(x, scales, bounds):
    if scales is None:
        return np.ones_like(np.asarray(x))
    x, lo, width, has_lo, has_hi = _np_prep(x, scales, bounds)
    with np.errstate(over='ignore'):
        sig = 1.0 / (1.0 + np.exp(-x))
        one_sided = (has_lo ^ has_hi)
        ex = np.exp(np.where(one_sided, x, 0.0))
        g = np.where(has_lo & has_hi, sig * (1.0 - sig), np.ones_like(x))
        g = np.where(has_lo & ~has_hi, ex, g)
        g = np.where(~has_lo & has_hi, -ex, g)
    return g * width


def np_to_original_grad2(x, scales, bounds):
    if scales is None:
        return np.zeros_like(np.asarray(x))
    x, lo, width, has_lo, has_hi = _np_prep(x, scales, bounds)
    with np.errstate(over='ignore'):
        one_sided = (has_lo ^ has_hi)
        ex = np.exp(np.where(one_sided | (has_lo & has_hi), x, 0.0))
        g = np.where(has_lo & has_hi,
                     -ex * (ex - 1.0) / ((ex + 1.0) ** 3),
                     np.zeros_like(x))
        g = np.where(has_lo & ~has_hi, ex, g)
        g = np.where(~has_lo & has_hi, -ex, g)
    return g * width


# ---------------------------------------------------------------------------
# The fused transform.

# exp-argument clamp: e^85 = 8.2e36 stays below float32 max (no inf, so no
# 0*inf NaN under arithmetic masking) and 1/(1+e^85) stays a normal float32.
# Beyond the clamp the two-sided branch saturates; the one-sided logdet stays
# exact at any x because log|exp(x)| == x analytically.
_FUSED_CLAMP = 85.0


def _fused_core(x, lo, width, m_lohi, m_lo, m_hi):
    """Primal math shared by the forward and the backward. Branches combine
    by ARITHMETIC masking over 0/1 mask operands (as the JAX package does,
    so float64 results agree to the last bits)."""
    m_none = 1.0 - m_lohi - m_lo - m_hi
    xc = torch.clamp(x, -_FUSED_CLAMP, _FUSED_CLAMP)
    em = torch.exp(-xc)
    ep = 1.0 / em
    s = 1.0 / (1.0 + em)
    t = m_lohi * s + m_lo * ep + m_hi * (1.0 - ep) + m_none * x
    x_o = lo + t * width
    s1s = s * (1.0 - s)
    return ep, s, s1s, x_o, m_none


def _tangent(x, lo, width, m_lohi, m_lo, m_hi):
    """The fused transform's rational tangent map (g, h) at x."""
    ep, s, s1s, _, m_none = _fused_core(x, lo, width, m_lohi, m_lo, m_hi)
    g = (m_lohi * s1s + (m_lo - m_hi) * ep + m_none) * width
    h = m_lohi * (1.0 - 2.0 * s) + m_lo + m_hi
    return g, h


class _FusedToOriginal(torch.autograd.Function):
    """(to_original(x), sum log|d to_original/dx|) with one exp and one log;
    the backward is the rational tangent map
    ``g = (m_lohi s(1-s) + (m_lo - m_hi) e^x + m_none) width`` and
    ``h = m_lohi (1 - 2s) + m_lo + m_hi``, recomputed from x with torch
    operations, so that it is differentiable in turn (second derivatives,
    for the Laplace Hessian)."""

    @staticmethod
    def forward(ctx, x, lo, width, m_lohi, m_lo, m_hi, logw):
        ep, s, s1s, x_o, m_none = _fused_core(x, lo, width,
                                              m_lohi, m_lo, m_hi)
        arg = m_lohi * s1s + (1.0 - m_lohi)
        logdet = torch.sum(torch.log(arg) + (m_lo + m_hi) * x, dim=-1) + logw
        ctx.save_for_backward(x, lo, width, m_lohi, m_lo, m_hi)
        return x_o, logdet

    @staticmethod
    def backward(ctx, gx_o, glogdet):
        g, h = _tangent(*ctx.saved_tensors)
        gx = gx_o * g + glogdet.unsqueeze(-1) * h
        return gx, None, None, None, None, None, None


def fused_params(scales, bounds, dtype, device='cpu'):
    """The fused transform's parameters: ``lo``, ``width``, the three 0/1
    masks (each (n,)) and ``logw``, the constant sum of log|width|."""
    b = normalize_bounds(bounds, scales.shape[0])
    has_lo, has_hi = b[:, 0], b[:, 1]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)

    width = scales[:, 1] - scales[:, 0]
    return dict(lo=t(scales[:, 0]), width=t(width),
                m_lohi=t(has_lo & has_hi), m_lo=t(has_lo & ~has_hi),
                m_hi=t(~has_lo & has_hi),
                logw=float(np.sum(np.log(np.abs(width)))))


def to_original_with_logdet(x, scales, bounds):
    """Fused ``(to_original(x), log|det d to_original/dx|)``, differentiable
    through the rational backward of ``_FusedToOriginal``. A floating
    tensor keeps its dtype; anything else becomes ``get_dtype()``."""
    if not (torch.is_tensor(x) and x.is_floating_point()):
        x = torch.as_tensor(x, dtype=get_dtype())
    if scales is None:
        return x, torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    fp = fused_params(scales, bounds, x.dtype, x.device)
    return _FusedToOriginal.apply(x, fp['lo'], fp['width'], fp['m_lohi'],
                                  fp['m_lo'], fp['m_hi'], fp['logw'])
