"""Diagonal mass-matrix state and Welford adaptation, in torch.

Counterpart of the diagonal part of ``bayesfast_tpu/samplers/metrics.py``
(``:32-127``). ``var`` is the metric's diagonal covariance: velocity is
``var * p`` and momenta are drawn as ``p ~ N(0, diag(1/var))``. The states
are plain ``NamedTuple``s of tensors; the driver batches them over chains
(leaves ``(C, D)`` and ``(C,)``). The per-transition adaptation itself runs
inside the warmup chunk (``nuts_cuda.py``), as in the JAX package.
"""

from typing import Any, NamedTuple

import torch

__all__ = ['DiagMetricState', 'init_diag_metric', 'sample_momentum_b']


class _Welford(NamedTuple):
    mean: Any    # (..., D)
    raw: Any     # (..., D)
    weight: Any  # (...)


class DiagMetricState(NamedTuple):
    var: Any            # (..., D) current metric diagonal covariance
    fg: _Welford
    bg: _Welford
    n_samples: Any      # int
    prev_update: Any    # int
    adapt_window: Any   # int (doubles over warmup)


def init_diag_metric(initial_mean, initial_var, initial_weight=10.,
                     adapt_window=60):
    """Initial diag metric state; ``initial_mean`` may carry a leading
    chain axis, ``initial_var`` broadcasts against it."""
    mean = torch.as_tensor(initial_mean)
    var = torch.as_tensor(initial_var, dtype=mean.dtype,
                          device=mean.device).expand_as(mean).clone()
    w = torch.full(mean.shape[:-1], float(initial_weight), dtype=mean.dtype,
                   device=mean.device)
    fg = _Welford(mean.clone(), var * w[..., None], w)
    bg = _Welford(torch.zeros_like(mean), torch.zeros_like(mean),
                  torch.zeros_like(w))
    return DiagMetricState(var=var, fg=fg, bg=bg, n_samples=0,
                           prev_update=0, adapt_window=int(adapt_window))


def sample_momentum_b(metric, generator, shape, dtype):
    """Draw (C, D) momenta ``p ~ N(0, diag(1/var))`` from a generator."""
    z = torch.randn(shape, generator=generator, dtype=dtype)
    return z.to(metric.var.device) / torch.sqrt(metric.var)
