"""Fixed-length HMC, batched over chains.

Counterpart of ``bayesfast_tpu/samplers/hmc.py``: ``n_int_step`` leapfrogs
then a Metropolis-Hastings accept; a transition diverges when its energy
error exceeds ``max_change`` or its final energy is not finite (which
forces a rejection). The JAX package runs it per chain under vmap as an XLA
``fori_loop``; here all chains step together as plain torch on their
device, a host loop of leapfrogs that reads nothing back.

``hmc_transition`` draws the momenta and the accept uniforms from one
generator, then calls ``hmc_core``, which is deterministic in them.
"""

from typing import Any, NamedTuple

import torch

from .integration import compute_state, leapfrog
from .metrics import sample_momentum_b

__all__ = ['HmcStats', 'hmc_core', 'hmc_transition', 'mh_accept']


class HmcStats(NamedTuple):
    logp: Any
    energy: Any
    n_int_step: Any
    accept_stat: Any
    accepted: Any
    energy_change: Any
    diverging: Any


def mh_accept(start_energy, end_energy, u, max_change):
    """The fixed-trajectory accept of HMC and THMC: ``(energy_change,
    diverging, accept_stat, accepted)`` per chain, the energy change
    ``-inf`` where the end energy is not finite."""
    finite = torch.isfinite(end_energy)
    energy_change = torch.where(finite, start_energy - end_energy,
                                torch.full_like(end_energy, -float('inf')))
    diverging = ~finite | (torch.abs(energy_change) > max_change)
    accept_stat = torch.clamp(torch.exp(energy_change), max=1.0)
    accepted = ~diverging & (u < accept_stat)
    return energy_change, diverging, accept_stat, accepted


def hmc_core(q0, p0, u, metric, step_size, logp_and_grad, n_int_step,
             max_change):
    """One HMC transition of every chain from its momenta ``p0`` (C, D)
    and accept uniforms ``u`` (C,); returns ``(q_new (C, D), HmcStats)``.
    The stats' logp and energy are the kept state's (the JAX package
    records the trajectory end's, accepted or not, so a rejected chain's
    logp there is not its sample's)."""
    start = compute_state(metric, logp_and_grad, q0, p0)
    state = start
    for _ in range(int(n_int_step)):
        state = leapfrog(metric, logp_and_grad, step_size, state)
    energy_change, diverging, accept_stat, accepted = mh_accept(
        start.energy, state.energy, u, max_change)
    q_new = torch.where(accepted[:, None], state.q, start.q)
    stats = HmcStats(
        logp=torch.where(accepted, state.logp, start.logp),
        energy=torch.where(accepted, state.energy, start.energy),
        n_int_step=torch.full_like(accepted, int(n_int_step),
                                   dtype=torch.int32),
        accept_stat=accept_stat, accepted=accepted,
        energy_change=energy_change, diverging=diverging)
    return q_new, stats


def hmc_transition(generator, q0, metric, step_size, logp_and_grad,
                   n_int_step, max_change):
    """One HMC transition of every chain ``q0`` (C, D); the metric may be
    per chain or shared, ``step_size`` a scalar or (C,). Momenta, then one
    uniform per chain, come from ``generator``."""
    C, D = q0.shape
    p0 = sample_momentum_b(metric, generator, (C, D), q0.dtype)
    u = torch.rand(C, generator=generator, dtype=q0.dtype,
                   device=generator.device).to(q0.device)
    return hmc_core(q0, p0, u, metric, step_size, logp_and_grad, n_int_step,
                    max_change)
