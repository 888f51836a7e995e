"""NUTS statistics and the Hamiltonian integrator pieces, in torch.

Counterpart of ``bayesfast_tpu/samplers/nuts.py:81-183``: ``NutsStats``, the
metric payload, the integrator state and the Kahan-compensated leapfrog.
The JAX package keeps these lane-minor (``(D, C)``, for the TPU's 128-lane
tiling); the port keeps chains on the leading axis (``(C, D)``), PyTorch's
habit, under the same names. The step probe (``core/sample.py``) uses
them; whole transitions run in ``nuts_cuda.py``.
"""

from typing import Any, NamedTuple

import torch

from .metrics import DiagMetricState

__all__ = ['NutsStats', 'TIntegratorState', 'compute_state_t', 'leapfrog_t']


class NutsStats(NamedTuple):
    logp: Any
    energy: Any
    tree_depth: Any
    tree_size: Any
    mean_tree_accept: Any
    energy_change: Any
    max_energy_change: Any
    diverging: Any


class TIntegratorState(NamedTuple):
    """Hamiltonian state: vectors (C, D), scalars (C,). ``cq``/``cp`` are
    the Kahan residuals of the position and momentum accumulators."""
    q: Any
    p: Any
    v: Any
    grad: Any
    energy: Any
    logp: Any
    cq: Any
    cp: Any


def _metric_t(metric):
    """The diag metric's payload, ``('diag', var)`` with var (C, D) or
    (D,)."""
    if not isinstance(metric, DiagMetricState):
        raise NotImplementedError('the port supports the diag metric only.')
    return ('diag', metric.var)


def _velocity_t(metric_t, p):
    return metric_t[1] * p


def compute_state_t(metric_t, lpg_t, q, p):
    """Hamiltonian state; ``lpg_t`` maps (C, D) -> ((C,), (C, D))."""
    logp, grad = lpg_t(q)
    v = _velocity_t(metric_t, p)
    energy = 0.5 * torch.sum(p * v, dim=-1) - logp
    zero = torch.zeros_like(q)
    return TIntegratorState(q, p, v, grad, energy, logp, zero, zero)


def _kahan_add(x, c, delta):
    """One compensated accumulation ``x += delta`` with residual ``c``."""
    y = delta - c
    t = x + y
    c_new = (t - x) - y
    return t, c_new


def leapfrog_t(metric_t, lpg_t, eps, s):
    """Leapfrog step; ``eps`` is (C,) signed per-chain steps."""
    eps = eps[:, None]
    dt = 0.5 * eps
    p_half, cp = _kahan_add(s.p, s.cp, dt * s.grad)
    v_half = _velocity_t(metric_t, p_half)
    q_new, cq = _kahan_add(s.q, s.cq, eps * v_half)
    logp, grad = lpg_t(q_new)
    p_new, cp = _kahan_add(p_half, cp, dt * grad)
    v_new = _velocity_t(metric_t, p_new)
    energy = 0.5 * torch.sum(p_new * v_new, dim=-1) - logp
    return TIntegratorState(q_new, p_new, v_new, grad, energy, logp, cq, cp)
