"""Continuously tempered HMC and NUTS (THMC / TNUTS), batched over chains.

Counterpart of ``bayesfast_tpu/samplers/tempered.py``. The state gains a
temperature coordinate ``u`` with a unit-mass momentum ``vu``; the
Hamiltonian interpolates the target potential ``phi = -logp`` and a base
potential ``psi = -logp_base`` through ``beta(u) = sigmoid(u)``, plus the
temperature prior ``U(u) = u + 2 log(1 + e^-u)``. Each sample carries the
importance weight ``delta / expm1(delta)``, ``delta = phi - psi``. The
U-turn checks use the q-space momenta only; ``(u, vu)`` ride along.

The JAX package writes a per-chain form (``t_compute_state``,
``t_leapfrog``, used by THMC under vmap) and a lane-minor form (the ``_t``
twins, used by TNUTS). Here both take (C, D) vectors and (C,) scalars; the
plain names take a metric state, the ``_t`` names the tree loop's metric
payload (``nuts._metric_t``). TNUTS runs on the tree loop of
``nuts.nuts_core_batched`` with its own step and proposal. Everything is
plain torch on the chains' device, as it is XLA in the JAX package.

``thmc_transition`` draws the momenta, ``vu`` and the accept uniforms from
one generator, then calls ``thmc_core``, which is deterministic in them.
"""

from typing import Any, NamedTuple

import torch

from .hmc import mh_accept
from .metrics import sample_momentum_b, velocity
from .nuts import _make_vel_fn, _metric_t, nuts_core_batched

__all__ = ['TState', 'TnutsStats', 'ThmcStats', 't_compute_state',
           't_leapfrog', 't_compute_state_t', 't_leapfrog_t', 'thmc_core',
           'thmc_transition', 'tnuts_transition_batched']


class TState(NamedTuple):
    q: Any        # (C, D)
    p: Any        # (C, D) q-space momentum
    v: Any        # (C, D) q-space velocity (M^-1 p)
    u: Any        # (C,) temperature coordinate
    vu: Any       # (C,) temperature momentum (unit mass)
    weight: Any   # (C,) importance weight
    energy: Any
    logp: Any


class TnutsStats(NamedTuple):
    u: Any
    weight: Any
    logp: Any
    energy: Any
    tree_depth: Any
    tree_size: Any
    mean_tree_accept: Any
    energy_change: Any
    max_energy_change: Any
    diverging: Any


class ThmcStats(NamedTuple):
    u: Any
    weight: Any
    logp: Any
    energy: Any
    n_int_step: Any
    accept_stat: Any
    accepted: Any
    energy_change: Any
    diverging: Any


def _beta(u):
    return 1.0 / (1.0 + torch.exp(-u))


def _d_beta(u):
    e = torch.exp(-u)
    return e / (1.0 + e) ** 2


def _temp_potential(u):
    return u + 2.0 * torch.log1p(torch.exp(-u))


def _d_temp_potential(u):
    e = torch.exp(u)
    return (e - 1.0) / (e + 1.0)


def _weight(delta):
    """``delta / expm1(delta)``, with the delta -> 0 limit of 1."""
    small = torch.abs(delta) < 1e-12
    safe = torch.where(small, torch.ones_like(delta), delta)
    return torch.where(small, torch.ones_like(delta),
                       safe / torch.expm1(safe))


def _energy(p, v, u, vu, phi, psi):
    kinetic = 0.5 * torch.sum(p * v, dim=-1) + 0.5 * vu * vu
    beta = _beta(u)
    return kinetic + beta * phi + (1.0 - beta) * psi + _temp_potential(u)


def _state(vel, lpg_target, lpg_base, q, p, u, vu):
    lp_t, _ = lpg_target(q)
    lp_b, _ = lpg_base(q)
    phi, psi = -lp_t, -lp_b
    v = vel(p)
    return TState(q, p, v, u, vu, _weight(phi - psi),
                  _energy(p, v, u, vu, phi, psi), -phi)


def _step(vel, lpg_target, lpg_base, eps, s):
    """Position-Verlet step of the tempered Hamiltonian: half drift, full
    kick, half drift, then a fresh evaluation at the end point."""
    eps = torch.as_tensor(eps, dtype=s.q.dtype, device=s.q.device)
    eps_q = eps[:, None] if eps.dim() == 1 else eps
    dt, dt_q = 0.5 * eps, 0.5 * eps_q
    u = s.u + s.vu * dt
    q = s.q + s.v * dt_q
    lp_t, g_t = lpg_target(q)
    lp_b, g_b = lpg_base(q)
    phi, psi = -lp_t, -lp_b
    beta = _beta(u)
    d_pot_du = _d_beta(u) * (phi - psi) + _d_temp_potential(u)
    d_pot_dq = beta[:, None] * -g_t + (1.0 - beta)[:, None] * -g_b
    vu = s.vu - d_pot_du * eps
    p = s.p - d_pot_dq * eps_q
    u = u + vu * dt
    v = vel(p)
    q = q + v * dt_q
    lp_t2, _ = lpg_target(q)
    lp_b2, _ = lpg_base(q)
    phi2, psi2 = -lp_t2, -lp_b2
    return TState(q, p, v, u, vu, _weight(phi2 - psi2),
                  _energy(p, v, u, vu, phi2, psi2), -phi2)


def t_compute_state(metric, lpg_target, lpg_base, q, p, u, vu):
    """Extended Hamiltonian state under a metric state; ``lpg_*`` map
    (C, D) -> ((C,), (C, D))."""
    return _state(lambda x: velocity(metric, x), lpg_target, lpg_base, q, p,
                  u, vu)


def t_leapfrog(metric, lpg_target, lpg_base, eps, s):
    """One tempered step under a metric state; ``eps`` a scalar or
    (C,)."""
    return _step(lambda x: velocity(metric, x), lpg_target, lpg_base, eps, s)


def t_compute_state_t(metric_t, lpg_target, lpg_base, q, p, u, vu):
    """``t_compute_state`` under the tree loop's metric payload."""
    return _state(_make_vel_fn(metric_t), lpg_target, lpg_base, q, p, u, vu)


def t_leapfrog_t(metric_t, lpg_target, lpg_base, eps, s):
    """``t_leapfrog`` under the tree loop's metric payload; ``eps`` (C,)
    signed steps."""
    return _step(_make_vel_fn(metric_t), lpg_target, lpg_base, eps, s)


def thmc_core(q0, u0, p0, vu0, u_acc, metric, step_size, lpg_target,
              lpg_base, n_int_step, max_change):
    """One THMC transition of every chain from momenta ``p0`` (C, D),
    temperature momenta ``vu0`` (C,) and accept uniforms ``u_acc`` (C,);
    returns ``(q_new, u_new, ThmcStats)``. The stats' u, weight, logp and
    energy are the kept state's: the JAX package records the trajectory
    end's, accepted or not, which pairs a rejected chain's sample with its
    proposal's importance weight."""
    start = t_compute_state(metric, lpg_target, lpg_base, q0, p0, u0, vu0)
    state = start
    for _ in range(int(n_int_step)):
        state = t_leapfrog(metric, lpg_target, lpg_base, step_size, state)
    energy_change, diverging, accept_stat, accepted = mh_accept(
        start.energy, state.energy, u_acc, max_change)
    q_new = torch.where(accepted[:, None], state.q, start.q)
    u_new = torch.where(accepted, state.u, start.u)
    stats = ThmcStats(
        u=u_new, weight=torch.where(accepted, state.weight, start.weight),
        logp=torch.where(accepted, state.logp, start.logp),
        energy=torch.where(accepted, state.energy, start.energy),
        n_int_step=torch.full_like(accepted, int(n_int_step),
                                   dtype=torch.int32),
        accept_stat=accept_stat, accepted=accepted,
        energy_change=energy_change, diverging=diverging)
    return q_new, u_new, stats


def _draw(generator, shape, dtype, device, normal):
    f = torch.randn if normal else torch.rand
    return f(shape, generator=generator, dtype=dtype,
             device=generator.device).to(device)


def thmc_transition(generator, q0, u0, metric, step_size, lpg_target,
                    lpg_base, n_int_step, max_change):
    """One THMC transition of every chain ``q0`` (C, D), ``u0`` (C,):
    momenta, then ``vu``, then one uniform per chain, from
    ``generator``."""
    C, D = q0.shape
    p0 = sample_momentum_b(metric, generator, (C, D), q0.dtype)
    vu0 = _draw(generator, C, q0.dtype, q0.device, True)
    u_acc = _draw(generator, C, q0.dtype, q0.device, False)
    return thmc_core(q0, u0, p0, vu0, u_acc, metric, step_size, lpg_target,
                     lpg_base, n_int_step, max_change)


def tnuts_transition_batched(generator, q0, u0, metric, step_size,
                             lpg_target, lpg_base, max_treedepth,
                             max_change):
    """One TNUTS transition of every chain on the tree loop; returns
    ``(q_new, u_new, TnutsStats)``. Momenta, then ``vu``, then the tree's
    draws come from ``generator``."""
    C, D = q0.shape
    dtype = q0.dtype
    p0 = sample_momentum_b(metric, generator, (C, D), dtype)
    vu0 = _draw(generator, C, dtype, q0.device, True)
    metric_t = _metric_t(metric)
    start = t_compute_state_t(metric_t, lpg_target, lpg_base, q0, p0, u0,
                              vu0)
    step_size = torch.as_tensor(step_size, dtype=dtype,
                                device=q0.device).expand(C)
    out = nuts_core_batched(
        generator, start,
        lambda eps, s: t_leapfrog_t(metric_t, lpg_target, lpg_base, eps, s),
        lambda s: (s.q, s.u, s.weight, s.energy, s.logp), step_size,
        max_treedepth, max_change, _make_vel_fn(metric_t))
    q, u, weight, energy, logp = out['prop']
    n_prop = torch.clamp(out['n_prop'], min=1).to(dtype)
    stats = TnutsStats(
        u=u, weight=weight, logp=logp, energy=energy,
        tree_depth=out['depth'], tree_size=out['n_prop'],
        mean_tree_accept=out['accept_sum'] / n_prop,
        energy_change=energy - start.energy,
        max_energy_change=out['max_de'], diverging=out['diverging'])
    return q, u, stats
