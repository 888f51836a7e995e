"""Numpy-only converters from the JAX package's state into the port's.

The port's tests hold it against the JAX package on the same inputs; these
helpers build the port's objects from numpy parameters and numpy leaves
(``np.asarray`` of the JAX state), so that both compute the same thing.
Nothing here imports jax.
"""

import numpy as np
import torch

from .config import get_device, get_dtype
from .core.density import DensityLite
from .ops.densities import (CauchyPair, NealFunnel, RingDensity,
                            RotatedBanana)
from .samplers.chain import ChainCarry
from .samplers.metrics import DiagMetricState, FullMetricState, _Welford
from .samplers.step_size import StepSizeState

__all__ = ['banana_density', 'funnel_density', 'ring_density',
           'cauchy_density', 'carry_from_numpy', 'metric_from_numpy',
           'sit_from_numpy', 'poly_from_numpy', 'density_decay_from_numpy']


def banana_density(A, Q=0.01, bounds=None, const=0.0, hard_bounds=True,
                   dtype=None):
    """A ``DensityLite`` over the rotated banana ``RotatedBanana(A, Q,
    const)`` with ``bounds`` an (D, 2) array of [lo, hi] (None: unbounded),
    as ``bench.py`` builds it."""
    A = np.asarray(A, np.float64)
    return DensityLite(
        logp=RotatedBanana(A, Q, const, dtype=dtype or get_dtype()),
        input_size=A.shape[0],
        input_scales=None if bounds is None else np.asarray(bounds),
        hard_bounds=hard_bounds)



def _anchor(logp, lower, upper):
    """A ``DensityLite`` over ``logp`` with the hard bounds [lower, upper],
    as ``benchmarks/suite.py:_density`` builds the GBS anchors."""
    bound = np.stack((lower, upper)).T
    return DensityLite(logp=logp, input_size=bound.shape[0],
                       input_scales=bound, hard_bounds=True)


def _log_width(lower, upper):
    return float(np.sum(np.log(upper - lower)))


def funnel_density(D=16, a=1., b=0.5):
    """The funnel-16 anchor (``benchmarks/suite.py:60-74``): bounds [-4, 4]
    on x0 and [-30, 30] elsewhere, ``const`` the sum of the log widths.
    Returns ``(density, extra)``, ``extra`` the sampler options of the
    anchor (``target_accept=0.95`` for the funnel's neck)."""
    lower, upper = np.full(D, -30.), np.full(D, 30.)
    lower[0], upper[0] = -4., 4.
    den = _anchor(NealFunnel(D, a, b, _log_width(lower, upper)), lower,
                  upper)
    return den, {'target_accept': 0.95}


def ring_density(D=64, a=2., b=1.):
    """The ring-64 anchor (``benchmarks/suite.py:75-84``): bounds [-5, 5],
    ``const`` the sum of the log widths. Returns ``(density, {})``."""
    lower, upper = np.full(D, -5.), np.full(D, 5.)
    return _anchor(RingDensity(D, a, b, _log_width(lower, upper)), lower,
                   upper), {}


def cauchy_density(D=48, a=5.):
    """The bimodal cauchy-48 anchor (``benchmarks/suite.py:85-95``): bounds
    [-100, 100], ``const`` the sum of the log widths. Returns ``(density,
    {})``."""
    lower, upper = np.full(D, -100.), np.full(D, 100.)
    return _anchor(CauchyPair(D, a, _log_width(lower, upper)), lower,
                   upper), {}

def _tensor(a, dtype, device):
    return torch.as_tensor(np.asarray(a), dtype=dtype or get_dtype(),
                           device=device or get_device())


def metric_from_numpy(metric, dtype=None, device=None):
    """A ``DiagMetricState`` or, for an object with a ``cov`` field, a
    ``FullMetricState`` from numpy leaves (per-chain or pooled); the window
    counters may be per-chain arrays, all equal, and become host ints."""
    def t(a):
        return _tensor(a, dtype, device)

    def i(a):
        return int(np.asarray(a).ravel()[0])

    fg = _Welford(t(metric.fg.mean), t(metric.fg.raw), t(metric.fg.weight))
    bg = _Welford(t(metric.bg.mean), t(metric.bg.raw), t(metric.bg.weight))
    ints = (i(metric.n_samples), i(metric.prev_update),
            i(metric.adapt_window))
    if hasattr(metric, 'cov'):
        return FullMetricState(t(metric.cov), t(metric.chol), fg, bg, *ints)
    return DiagMetricState(t(metric.var), fg, bg, *ints)


def carry_from_numpy(seed, q, step, metric, dtype=None, device=None):
    """A ``ChainCarry`` from numpy leaves.

    ``seed`` is the int32 kernel seed (the JAX package derives it from the
    carry's first key, ``nuts_pallas.py:1152-1153``); ``q`` is (C, D);
    ``step`` has the ``StepSizeState`` fields as attributes (the JAX state
    under ``np.asarray``) and ``metric`` is as ``metric_from_numpy`` takes
    it.
    """
    st = StepSizeState(*[_tensor(getattr(step, f), dtype, device)
                         for f in StepSizeState._fields])
    return ChainCarry(int(seed), _tensor(q, dtype, device), st,
                      metric_from_numpy(metric, dtype, device))


def sit_from_numpy(A, B, m, logdetA, splines, data=None, flow_dtype=None,
                   **options):
    """A fitted ``transforms.SIT`` from a JAX ``SIT``'s layers as numpy
    arrays: ``A``, ``B`` (L, D, D), ``m`` (L, D), ``logdetA`` (L,) (its
    ``_A``, ``_B``, ``_m``, ``_logdetA``) and ``splines``, one list per
    layer of ``(x, y, c)`` per dimension (each spline's ``_x``, ``_y``,
    ``_c``). ``data`` (n, D) becomes the SIT's data (default: none, an
    empty (0, D) array); ``options`` go to ``SIT``."""
    from .transforms import SIT
    from .utils.cubic import CubicSplineSet, cubic_spline
    A = np.asarray(A, np.float64)
    L, D = A.shape[0], A.shape[-1]
    sit = SIT(n_iter=L, flow_dtype=flow_dtype, **options)
    sit._data = (np.zeros((0, D)) if data is None
                 else np.asarray(data, np.float64))
    sit._data_init = sit._data.copy()
    sit._weights = np.ones(sit._data.shape[0]) / max(sit._data.shape[0], 1)
    sit._A = A
    sit._B = np.asarray(B, np.float64)
    sit._m = np.asarray(m, np.float64)
    sit._logdetA = np.asarray(logdetA, np.float64)
    for layer in splines:
        objs = []
        for x, y, c in layer:
            s = cubic_spline.__new__(cubic_spline)
            s._x = np.asarray(x, np.float64)
            s._y = np.asarray(y, np.float64)
            s._c = np.asarray(c, np.float64)
            s._n = s._x.shape[0]
            objs.append(s)
        sit._spline_sets.append(CubicSplineSet(objs, dtype=sit.flow_dtype))
    return sit


def poly_from_numpy(configs, mu, hess, alpha, f_mu, bound_options=None,
                    **kwargs):
    """A fitted ``modules.PolyModel`` from a JAX ``PolyModel``'s state as
    numpy: ``configs`` a list of ``(order, input_mask, output_mask, a)``
    per config (its ``_input_mask``, ``_output_mask`` and ``_a``), then its
    ``_mu``, ``_hess``, ``_alpha`` (None before a fit) and ``_f_mu``;
    ``bound_options`` and ``kwargs`` (``input_size``, ``output_size``,
    ``input_vars``, ``input_scales``, ...) go to ``PolyModel``. Any order
    carries across, cubic-2 and cubic-3 included; the bound is in the
    scaled inputs, as the JAX model fitted it."""
    from .modules import PolyConfig, PolyModel
    pcs = [PolyConfig(o, im, om) for o, im, om, _ in configs]
    model = PolyModel(pcs, bound_options, **kwargs)
    for pc, (_, _, _, a) in zip(model.configs, configs):
        pc._a = np.array(a, np.float64)
    model._mu = np.array(mu, np.float64)
    model._hess = np.array(hess, np.float64)
    model._alpha = None if alpha is None else float(alpha)
    model._f_mu = np.array(f_mu, np.float64)
    return model


def density_decay_from_numpy(density, mu, hess, alpha_2):
    """Set a ``Density``'s decay state from a JAX ``Density``'s ``_mu``,
    ``_hess`` and ``_alpha_2_val`` (numpy; None for ``mu``/``hess`` before a
    fit); returns the density."""
    density._mu = None if mu is None else np.array(mu, np.float64)
    density._hess = None if hess is None else np.array(hess, np.float64)
    density._alpha_2_val = float(alpha_2)
    return density
