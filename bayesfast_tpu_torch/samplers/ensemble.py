"""Affine-invariant ensemble sampler (emcee-style stretch moves).

Counterpart of ``bayesfast_tpu/samplers/ensemble.py`` (Goodman & Weare
2010, emcee's parallel variant): the walkers split into two halves; each
walker ``x_k`` of the active half draws a walker ``x_j`` of the other half
and a stretch ``z ~ g(z) ~ 1/sqrt(z)`` on ``[1/a, a]``, proposes ``y = x_j
+ z (x_k - x_j)`` and accepts with probability ``min(1, z^(D-1)
exp(logp(y) - logp(x_k)))``. No gradients. The JAX package scans it in
XLA; here each half-update is a gather and an elementwise accept in plain
torch on the walkers' device.

``run_ensemble`` keys iteration ``i0 + i``'s generator by ``(seed, i0 +
i)``, so how a run is cut into calls never changes its stream.
``_half_update`` draws ``z``, ``j`` and the accept uniforms, then calls
``_half_update_core``, which is deterministic in them.
"""

from typing import Any, NamedTuple

import numpy as np
import torch

from ..utils.random import generator_from_seed

__all__ = ['EnsembleStats', 'ensemble_step', 'run_ensemble']


class EnsembleStats(NamedTuple):
    logp: Any         # (n_walker,)
    accept_stat: Any
    accepted: Any
    warmup: Any


def _half_update_core(active, other, logp_active, logp_fn, z, j, u):
    """The stretch move of one half (n_act, D) against the other, from the
    stretches ``z``, partner indices ``j`` and accept uniforms ``u`` (each
    (n_act,)); returns ``(new, new_logp, accepted, accept_prob)``."""
    dim = active.shape[1]
    xj = other[j]
    prop = xj + z[:, None] * (active - xj)
    logp_prop = logp_fn(prop)
    log_accept = (dim - 1) * torch.log(z) + logp_prop - logp_active
    log_accept = torch.where(torch.isnan(log_accept),
                             torch.full_like(log_accept, -float('inf')),
                             log_accept)
    accept = torch.log(u) < log_accept
    new = torch.where(accept[:, None], prop, active)
    new_logp = torch.where(accept, logp_prop, logp_active)
    p_acc = torch.clamp(torch.exp(log_accept), max=1.0)
    return new, new_logp, accept, p_acc


def _half_update(generator, active, other, logp_active, logp_fn, a):
    """Draw the stretches (``z = ((a - 1) u + 1)^2 / a``), the partners
    and the accept uniforms of one half from ``generator``, then move
    it."""
    n_act = active.shape[0]
    dtype, dev = active.dtype, active.device

    def draw(f, *args, **kw):
        return f(*args, generator=generator, device=generator.device,
                 **kw).to(dev)

    u_z = draw(torch.rand, n_act, dtype=dtype)
    z = ((a - 1.0) * u_z + 1.0) ** 2 / a
    j = draw(torch.randint, 0, other.shape[0], (n_act,))
    u = draw(torch.rand, n_act, dtype=dtype)
    return _half_update_core(active, other, logp_active, logp_fn, z, j, u)


def ensemble_step(generator, x, logp_x, logp_fn, a=2.0):
    """One ensemble iteration (both halves) of the walkers ``x`` (n, D)
    with log densities ``logp_x`` (n,)."""
    half = x.shape[0] // 2
    x0, lp0, acc0, p0 = _half_update(generator, x[:half], x[half:],
                                     logp_x[:half], logp_fn, a)
    x1, lp1, acc1, p1 = _half_update(generator, x[half:], x0,
                                     logp_x[half:], logp_fn, a)
    return (torch.cat([x0, x1]), torch.cat([lp0, lp1]),
            torch.cat([acc0, acc1]), torch.cat([p0, p1]))


def run_ensemble(seed, x, lp, logp_fn, warmup_flags, a=2.0, i0=0):
    """``len(warmup_flags)`` iterations from walkers ``x`` (n, D) with log
    densities ``lp`` (n,); iteration ``i`` draws from a generator keyed by
    ``(seed, i0 + i)``. Returns ``(x, lp, samples (K, n, D), stats)`` with
    (K, n) stat leaves."""
    samples, stats = [], []
    for i, w in enumerate(warmup_flags):
        gen = generator_from_seed(
            np.random.SeedSequence([int(seed), int(i0) + i]), x.device)
        x, lp, accepted, p_acc = ensemble_step(gen, x, lp, logp_fn, a)
        samples.append(x)
        stats.append(EnsembleStats(
            logp=lp, accept_stat=p_acc, accepted=accepted,
            warmup=torch.full_like(accepted, bool(w))))
    return x, lp, torch.stack(samples), EnsembleStats(
        *[torch.stack(v) for v in zip(*stats)])
