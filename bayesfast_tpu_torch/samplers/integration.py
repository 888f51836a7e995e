"""The leapfrog integrator of fixed-length HMC, batched over chains.

Counterpart of ``bayesfast_tpu/samplers/integration.py``: half kick, drift,
half kick, one ``logp_and_grad`` evaluation a step. The JAX package writes
it for one chain and vmaps it; here every chain steps at once, with
vectors (C, D) and scalars (C,), and ``eps`` a scalar or (C,). Unlike the
tree loop's ``nuts.leapfrog_t`` it carries no Kahan residuals, as in the
JAX package.
"""

from typing import Any, NamedTuple

import torch

from .metrics import velocity, kinetic_energy

__all__ = ['IntegratorState', 'leapfrog', 'compute_state']


class IntegratorState(NamedTuple):
    q: Any        # position (C, D)
    p: Any        # momentum (C, D)
    v: Any        # velocity M^-1 p (C, D)
    grad: Any     # d logp / dq (C, D)
    energy: Any   # H = K - logp (C,)
    logp: Any     # (C,)


def _per_chain(eps, like):
    """``eps`` as a tensor that broadcasts against (C, D) vectors."""
    eps = torch.as_tensor(eps, dtype=like.dtype, device=like.device)
    return eps[:, None] if eps.dim() == 1 else eps


def compute_state(metric, logp_and_grad, q, p):
    """Hamiltonian state at (q, p); ``logp_and_grad`` maps (C, D) ->
    ((C,), (C, D))."""
    logp, grad = logp_and_grad(q)
    v = velocity(metric, p)
    energy = kinetic_energy(p, v) - logp
    return IntegratorState(q, p, v, grad, energy, logp)


def leapfrog(metric, logp_and_grad, eps, s):
    """One leapfrog step of every chain."""
    eps = _per_chain(eps, s.q)
    dt = 0.5 * eps
    p_half = s.p + dt * s.grad
    v_half = velocity(metric, p_half)
    q_new = s.q + eps * v_half
    logp, grad = logp_and_grad(q_new)
    p_new = p_half + dt * grad
    v_new = velocity(metric, p_new)
    energy = kinetic_energy(p_new, v_new) - logp
    return IntegratorState(q_new, p_new, v_new, grad, energy, logp)
