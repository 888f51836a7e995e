"""Mass-matrix states and their Welford adaptation, in torch.

Counterpart of ``bayesfast_tpu/samplers/metrics.py``. Two metric families:

* diag: ``var`` (D,); velocity ``var * p``, momenta ``p ~ N(0, diag(1/var))``;
* full: ``cov`` (D, D) with its lower Cholesky factor ``chol``; velocity
  ``cov @ p``, momenta ``p ~ N(0, cov^-1)``.

The states are plain ``NamedTuple``s of tensors. Per-chain states carry a
leading chain axis (leaves ``(C, D)``, ``(C, D, D)``, ``(C,)``); a pooled
state (one metric fed by all chains) has none. The window counters
(``n_samples``, ``prev_update``, ``adapt_window``) are host ints, so every
window decision is made on the host and no update reads the device back.

This module holds the per-transition adaptation of the per-transition
path (``ChainDriver.run``): ``update_metric`` for per-chain states,
batched over the chain axis where the JAX package vmaps it, and
``update_metric_pooled`` with the exact batch Welford merge. The warmup
chunk kernel runs the diag update inside ``nuts_cuda.py``.
"""

from typing import Any, NamedTuple

import torch

__all__ = ['DiagMetricState', 'FullMetricState', 'init_diag_metric',
           'init_full_metric', 'velocity', 'kinetic_energy',
           'sample_momentum', 'sample_momentum_b', 'update_metric',
           'update_metric_pooled']


class _Welford(NamedTuple):
    mean: Any    # (..., D)
    raw: Any     # (..., D) diag, (..., D, D) full
    weight: Any  # (...)


class DiagMetricState(NamedTuple):
    var: Any            # (..., D) current metric diagonal covariance
    fg: _Welford
    bg: _Welford
    n_samples: Any      # int
    prev_update: Any    # int
    adapt_window: Any   # int (doubles over warmup)


class FullMetricState(NamedTuple):
    cov: Any            # (..., D, D)
    chol: Any           # (..., D, D) lower Cholesky factor of cov
    fg: _Welford
    bg: _Welford
    n_samples: Any
    prev_update: Any
    adapt_window: Any


def _init_welford(mean, cov, initial_weight):
    w = torch.full(mean.shape[:-1], float(initial_weight), dtype=mean.dtype,
                   device=mean.device)
    wb = w.reshape(w.shape + (1,) * (cov.dim() - mean.dim() + 1))
    fg = _Welford(mean.clone(), cov * wb, w)
    bg = _Welford(torch.zeros_like(mean), torch.zeros_like(cov),
                  torch.zeros_like(w))
    return fg, bg


def init_diag_metric(initial_mean, initial_var, initial_weight=10.,
                     adapt_window=60):
    """Initial diag metric state; ``initial_mean`` may carry a leading
    chain axis, ``initial_var`` broadcasts against it."""
    mean = torch.as_tensor(initial_mean)
    var = torch.as_tensor(initial_var, dtype=mean.dtype,
                          device=mean.device).expand_as(mean).clone()
    fg, bg = _init_welford(mean, var, initial_weight)
    return DiagMetricState(var=var, fg=fg, bg=bg, n_samples=0,
                           prev_update=0, adapt_window=int(adapt_window))


def init_full_metric(initial_mean, initial_cov, initial_weight=10.,
                     adapt_window=60):
    """Initial full metric state; ``initial_mean`` (..., D) may carry a
    leading chain axis, ``initial_cov`` (D, D) broadcasts against it."""
    mean = torch.as_tensor(initial_mean)
    D = mean.shape[-1]
    cov = torch.as_tensor(initial_cov, dtype=mean.dtype,
                          device=mean.device).expand(
        mean.shape[:-1] + (D, D)).clone()
    fg, bg = _init_welford(mean, cov, initial_weight)
    return FullMetricState(cov=cov, chol=torch.linalg.cholesky(cov), fg=fg,
                           bg=bg, n_samples=0, prev_update=0,
                           adapt_window=int(adapt_window))


def velocity(metric, p):
    """``M^-1 p`` for momenta ``p`` (C, D) or (D,)."""
    if isinstance(metric, DiagMetricState):
        return metric.var * p
    return (metric.cov @ p.unsqueeze(-1)).squeeze(-1)


def kinetic_energy(p, v):
    """``0.5 p . v`` over the last axis: (C,) for (C, D) momenta."""
    return 0.5 * torch.sum(p * v, dim=-1)


def _momentum_from_normal(metric, z):
    """``p ~ N(0, M)`` from standard normals ``z``: ``z / sqrt(var)`` for a
    diag metric, ``L^-T z`` for a full one (``cov(p) = L^-T L^-1 =
    cov^-1``)."""
    if isinstance(metric, DiagMetricState):
        return z.to(metric.var.device) / torch.sqrt(metric.var)
    z = z.to(metric.chol.device)
    return torch.linalg.solve_triangular(
        metric.chol.mT, z.unsqueeze(-1), upper=True).squeeze(-1)


def sample_momentum(metric, generator):
    """Draw one momentum (D,) ``p ~ N(0, M)`` from a single (unbatched)
    metric state, in the metric's dtype."""
    leaf = metric.var if isinstance(metric, DiagMetricState) else metric.cov
    z = torch.randn(leaf.shape[-1], generator=generator, dtype=leaf.dtype,
                    device=generator.device)
    return _momentum_from_normal(metric, z)


def sample_momentum_b(metric, generator, shape, dtype):
    """Draw (C, D) momenta ``p ~ N(0, M)`` with ``M = cov^-1`` from one
    generator, on the generator's device, then moved to the metric's; the
    metric may be per-chain or shared."""
    z = torch.randn(shape, generator=generator, dtype=dtype,
                    device=generator.device)
    return _momentum_from_normal(metric, z)


def _welford_add(w, x, full):
    """Add one sample per state (``x`` (..., D), a leading chain axis
    batches it)."""
    n = w.weight + 1.0
    old_diff = x - w.mean
    mean = w.mean + old_diff / n.unsqueeze(-1)
    new_diff = x - mean
    if full:
        raw = w.raw + new_diff.unsqueeze(-1) * old_diff.unsqueeze(-2)
    else:
        raw = w.raw + old_diff * new_diff
    return _Welford(mean, raw, n)


def _welford_add_batch(w, xb, full):
    """Exact parallel Welford merge (Chan et al.) of a whole batch ``xb``
    (C, D) into one state: algebraically the same as adding its rows one
    by one."""
    cb = float(xb.shape[0])
    mean_b = torch.mean(xb, dim=0)
    xc = xb - mean_b
    raw_b = xc.T @ xc if full else torch.sum(xc * xc, dim=0)
    n_new = w.weight + cb
    delta = mean_b - w.mean
    mean_new = w.mean + delta * cb / n_new
    corr = w.weight * cb / n_new
    if full:
        raw_new = w.raw + raw_b + corr * torch.outer(delta, delta)
    else:
        raw_new = w.raw + raw_b + corr * delta * delta
    return _Welford(mean_new, raw_new, n_new)


def _zero_welford(w):
    return _Welford(torch.zeros_like(w.mean), torch.zeros_like(w.raw),
                    torch.zeros_like(w.weight))


def _update(metric, fg, bg, update_window, doubling):
    """The window logic shared by the per-chain and the pooled update:
    refresh the metric from the foreground every ``update_window`` samples,
    with Stan-style shrinkage toward 1e-3 x identity at pseudo-count 5, and
    switch windows (background to foreground, window doubled) once
    ``adapt_window`` samples have gone by. On a failed Cholesky of a
    refreshed full covariance the previous factor is kept."""
    delta = metric.n_samples - metric.prev_update
    do_refresh = ((delta + 1) % update_window) == 0
    do_switch = delta >= metric.adapt_window
    full = isinstance(metric, FullMetricState)
    if full:
        cov, chol = metric.cov, metric.chol
        if do_refresh:
            D = cov.shape[-1]
            eye = torch.eye(D, dtype=cov.dtype, device=cov.device)
            w5 = (fg.weight + 5.0).unsqueeze(-1).unsqueeze(-1)
            cov = (fg.raw + 5e-3 * eye) / w5
            chol_new, info = torch.linalg.cholesky_ex(cov)
            ok = (info == 0) & torch.isfinite(chol_new).all(-1).all(-1)
            chol = torch.where(ok.unsqueeze(-1).unsqueeze(-1), chol_new,
                               chol)
        payload = (cov, chol)
    else:
        var = metric.var
        if do_refresh:
            var = (fg.raw + 5e-3) / (fg.weight + 5.0).unsqueeze(-1)
        payload = (var,)
    if do_switch:
        fg, bg = bg, _zero_welford(bg)
    prev_update = metric.n_samples if do_switch else metric.prev_update
    adapt_window = (metric.adapt_window * 2 if do_switch and doubling
                    else metric.adapt_window)
    return type(metric)(*payload, fg, bg, metric.n_samples + 1, prev_update,
                        adapt_window)


def update_metric(metric, sample, warmup, update_window=1, doubling=True):
    """One adaptation step of per-chain states from ``sample`` (C, D), the
    chains' new positions (the JAX package's vmapped ``update_metric``);
    unchanged when ``warmup`` is False."""
    if not warmup:
        return metric
    full = isinstance(metric, FullMetricState)
    return _update(metric, _welford_add(metric.fg, sample, full),
                   _welford_add(metric.bg, sample, full), update_window,
                   doubling)


def update_metric_pooled(metric, samples, warmup, update_window=1,
                         doubling=True):
    """One adaptation step of one shared state from ALL chains' new
    positions ``samples`` (C, D); the windows stay iteration-counted, so the
    switching schedule is the per-chain one. Unchanged when ``warmup`` is
    False."""
    if not warmup:
        return metric
    full = isinstance(metric, FullMetricState)
    return _update(metric, _welford_add_batch(metric.fg, samples, full),
                   _welford_add_batch(metric.bg, samples, full),
                   update_window, doubling)
