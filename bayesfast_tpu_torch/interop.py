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
from .ops.densities import RotatedBanana
from .samplers.chain import ChainCarry
from .samplers.metrics import DiagMetricState, _Welford
from .samplers.step_size import StepSizeState

__all__ = ['banana_density', 'carry_from_numpy']


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


def carry_from_numpy(seed, q, step, metric, dtype=None, device=None):
    """A ``ChainCarry`` from numpy leaves.

    ``seed`` is the int32 kernel seed (the JAX package derives it from the
    carry's first key, ``nuts_pallas.py:1152-1153``); ``q`` is (C, D);
    ``step`` has the ``StepSizeState`` fields and ``metric`` the
    ``DiagMetricState`` fields as attributes (per-chain leaves, numpy); the
    window counters may be per-chain arrays, all equal.
    """
    dtype = dtype or get_dtype()
    device = device or get_device()

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def i(a):
        return int(np.asarray(a).ravel()[0])

    st = StepSizeState(*[t(getattr(step, f)) for f in StepSizeState._fields])
    ms = DiagMetricState(
        var=t(metric.var),
        fg=_Welford(t(metric.fg.mean), t(metric.fg.raw), t(metric.fg.weight)),
        bg=_Welford(t(metric.bg.mean), t(metric.bg.raw), t(metric.bg.weight)),
        n_samples=i(metric.n_samples), prev_update=i(metric.prev_update),
        adapt_window=i(metric.adapt_window))
    return ChainCarry(int(seed), t(q), st, ms)
