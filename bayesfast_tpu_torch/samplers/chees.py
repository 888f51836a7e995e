"""ChEES-HMC: HMC with one jittered trajectory length shared by all chains.

Counterpart of ``bayesfast_tpu/samplers/chees.py`` (Hoffman, Radul &
Sountsov, AISTATS 2021). Every chain runs the same number of leapfrogs an
iteration, so the chains step in lockstep with no tree bookkeeping:

* trajectory time ``t = h T``, ``h`` the base-2 Halton point of the
  iteration counter; the shared leapfrog count ``n = ceil(t / eps)``,
  clipped to ``[1, max_leapfrogs]``;
* a full momentum refresh, ``n`` leapfrogs, a per-chain MH accept;
* in warmup, Adam ascent of ``log T`` on the ChEES criterion's gradient
  over chains, and dual averaging of the one shared step size on the
  harmonic-mean acceptance (target 0.651 by default).

The JAX package runs it as an XLA ``fori_loop``; here it is plain torch on
the chains' device with the leapfrogs of the tree loop
(``nuts.compute_state_t`` / ``leapfrog_t``, Kahan-compensated, as in the
JAX package). The adaptation state's leaves are 0-d tensors and its
iteration counter a host int.

``chees_transition_batched`` draws the momenta and the accept uniforms
from one generator, then calls ``chees_core``, which is deterministic in
them.
"""

import math
from typing import Any, NamedTuple

import torch

from .metrics import sample_momentum_b
from .nuts import _metric_t, compute_state_t, leapfrog_t
from .step_size import StepSizeState, init_step_size, update_step_size

__all__ = ['CheesAdaptState', 'CheesStats', 'init_chees_adapt', 'halton2',
           'chees_core', 'chees_transition_batched', 'chees_adapt_update']


class CheesAdaptState(NamedTuple):
    step: StepSizeState   # the shared dual-averaging state, 0-d leaves
    log_T: Any            # log trajectory time, 0-d
    adam_m: Any
    adam_v: Any
    count: int            # iteration counter (drives the jitter)


class CheesStats(NamedTuple):
    logp: Any
    energy: Any
    n_int_step: Any
    accept_stat: Any
    accepted: Any
    traj_len: Any
    energy_change: Any
    diverging: Any


def init_chees_adapt(initial_step, initial_traj_len, dtype=torch.float64,
                     device=None):
    """Initial shared state: step ``initial_step``, trajectory time
    ``initial_traj_len``, zero Adam moments, counter 0."""
    step = init_step_size(float(initial_step), dtype, device)
    zero = torch.zeros((), dtype=dtype, device=step.log_step.device)
    return CheesAdaptState(
        step=step, log_T=torch.log(torch.full_like(zero,
                                                   float(initial_traj_len))),
        adam_m=zero, adam_v=zero.clone(), count=0)


_M32 = 0xFFFFFFFF


def halton2(i):
    """Base-2 radical inverse of the counter ``i + 1`` in (0, 1): its 32
    bits reversed, times 2^-32. ``i`` is an int (returns a float) or an
    integer tensor (returns float64); exact in integers."""
    x = (i + 1) & _M32
    x = ((x & 0x55555555) << 1) | ((x & 0xAAAAAAAA) >> 1)
    x = ((x & 0x33333333) << 2) | ((x & 0xCCCCCCCC) >> 2)
    x = ((x & 0x0F0F0F0F) << 4) | ((x & 0xF0F0F0F0) >> 4)
    x = ((x & 0x00FF00FF) << 8) | ((x & 0xFF00FF00) >> 8)
    x = ((x << 16) | (x >> 16)) & _M32
    if torch.is_tensor(x):
        return x.to(torch.float64) * 2.0 ** -32
    return x * 2.0 ** -32


def _n_leapfrogs(h, traj_len, eps, max_leapfrogs):
    """The shared leapfrog count ``clip(ceil(h T / eps), 1, max)``, a host
    int: reading it is the transition's one device-to-host copy."""
    n = float(torch.ceil(h * traj_len / eps))
    if not math.isfinite(n):
        n = max_leapfrogs
    return int(min(max(n, 1), int(max_leapfrogs)))


def chees_core(q0, p0, u, metric, eps, traj_len, h, logp_and_grad,
               max_leapfrogs, max_change):
    """One ChEES iteration of every chain from momenta ``p0`` (C, D) and
    accept uniforms ``u`` (C,); ``eps``, ``traj_len`` and ``h`` are shared
    scalars. Returns ``(q_new, CheesStats, (q_prop, v_prop,
    accept_prob))``, the last three feeding ``chees_adapt_update``."""
    C, D = q0.shape
    dtype = q0.dtype
    metric_t = _metric_t(metric)
    eps = torch.as_tensor(eps, dtype=dtype, device=q0.device)
    traj_len = torch.as_tensor(traj_len, dtype=dtype, device=q0.device)
    start = compute_state_t(metric_t, logp_and_grad, q0, p0)
    # the shared count is a host int: read once per transition
    n_step = _n_leapfrogs(h, traj_len, eps, max_leapfrogs)
    eps_c = eps.expand(C)
    end = start
    for _ in range(n_step):
        end = leapfrog_t(metric_t, logp_and_grad, eps_c, end)

    d_energy = end.energy - start.energy
    d_energy = torch.where(torch.isnan(d_energy),
                           torch.full_like(d_energy, float('inf')), d_energy)
    diverging = ~(torch.abs(d_energy) < max_change)
    accept_prob = torch.where(diverging, torch.zeros_like(d_energy),
                              torch.clamp(torch.exp(-d_energy), max=1.0))
    accepted = u < accept_prob
    q_new = torch.where(accepted[:, None], end.q, start.q)
    stats = CheesStats(
        logp=torch.where(accepted, end.logp, start.logp),
        energy=torch.where(accepted, end.energy, start.energy),
        n_int_step=torch.full((C,), n_step, dtype=torch.int32,
                              device=q0.device),
        accept_stat=accept_prob, accepted=accepted,
        traj_len=traj_len.expand(C), energy_change=d_energy,
        diverging=diverging)
    return q_new, stats, (end.q, end.v, accept_prob)


def chees_transition_batched(generator, q0, metric, eps, traj_len, h,
                             logp_and_grad, max_leapfrogs, max_change):
    """One ChEES iteration of every chain ``q0`` (C, D): momenta, then one
    uniform per chain, from ``generator``; see ``chees_core``."""
    C, D = q0.shape
    p0 = sample_momentum_b(metric, generator, (C, D), q0.dtype)
    u = torch.rand(C, generator=generator, dtype=q0.dtype,
                   device=generator.device).to(q0.device)
    return chees_core(q0, p0, u, metric, eps, traj_len, h, logp_and_grad,
                      max_leapfrogs, max_change)


def chees_adapt_update(adapt, q_old, q_prop, v_prop, accept_prob, h, eps,
                       warmup, target=0.651, gamma=0.05, k=0.75, t_0=10.,
                       adapt_step_size=True, adapt_traj_len=True,
                       lr=0.025, max_leapfrogs=1024):
    """The shared adaptation step; ``warmup`` is a host bool. Outside
    warmup only the counter and the acceptance accumulators move."""
    # ---- the ChEES gradient for the trajectory length ----
    m_old = torch.mean(q_old, dim=0)
    m_prop = torch.mean(q_prop, dim=0)
    a = (torch.sum((q_prop - m_prop) ** 2, dim=-1)
         - torch.sum((q_old - m_old) ** 2, dim=-1))
    b = torch.sum((q_prop - m_prop) * v_prop, dim=-1)
    w = accept_prob
    w_sum = torch.clamp(torch.sum(w), min=1e-10)
    grad = torch.sum(w * a * b, dim=0) * h / w_sum

    log_T, adam_m, adam_v = adapt.log_T, adapt.adam_m, adapt.adam_v
    if warmup and adapt_traj_len:
        t_adam = float(adapt.count + 1)
        b1, b2 = 0.9, 0.999
        adam_m = b1 * adapt.adam_m + (1 - b1) * grad
        adam_v = b2 * adapt.adam_v + (1 - b2) * grad ** 2
        m_hat = adam_m / (1 - b1 ** t_adam)
        v_hat = adam_v / (1 - b2 ** t_adam)
        step_T = lr * m_hat / (torch.sqrt(v_hat) + 1e-8)
        # at least one leapfrog, at most the budget
        eps = torch.as_tensor(eps, dtype=log_T.dtype, device=log_T.device)
        log_T_new = torch.clamp(adapt.log_T + step_T, torch.log(eps),
                                torch.log(eps * max_leapfrogs))
        # a non-finite gradient (every proposal rejected) keeps T
        log_T = torch.where(torch.isfinite(log_T_new), log_T_new,
                            adapt.log_T)

    # ---- the shared step size: dual averaging on the harmonic mean ----
    hm_accept = 1.0 / torch.mean(1.0 / torch.clamp(accept_prob, min=1e-4))
    step = update_step_size(adapt.step, hm_accept, warmup, target, gamma, k,
                            t_0, adapt_step_size)
    return CheesAdaptState(step=step, log_T=log_T, adam_m=adam_m,
                           adam_v=adam_v, count=adapt.count + 1)
