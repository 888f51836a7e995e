"""Nesterov dual-averaging step-size state, in torch.

Counterpart of ``bayesfast_tpu/samplers/step_size.py``: the state, its
initialisation, the per-transition update of the per-transition path
(``ChainDriver.run``; the warmup chunk kernel runs the same update inside
``nuts_cuda.py``) and the host-side post-warmup acceptance check. The state's
leaves are per-chain tensors ``(C,)``; ``warmup`` is a host bool (the JAX
package masks with a traced one), so the update reads nothing back.
"""

from typing import Any, NamedTuple

import numpy as np
import torch
from scipy import stats as _sp_stats

from ..config import get_device

__all__ = ['StepSizeState', 'init_step_size', 'current_step_size',
           'update_step_size', 'check_acceptance']


class StepSizeState(NamedTuple):
    log_step: Any      # warmup (noisy) log step size
    log_bar: Any       # averaged log step size, used after warmup
    hbar: Any
    count: Any         # float, starts at 1
    mu: Any            # log(10 * initial_step)
    accept_sum: Any    # post-warmup acceptance accumulator
    accept_count: Any


def init_step_size(initial_step, dtype=torch.float64, device=None):
    """State for per-chain initial steps (a tensor of shape (C,) or a
    scalar), on ``device`` (default: ``config.get_device()``)."""
    step = torch.as_tensor(initial_step, dtype=dtype,
                           device=device or get_device())
    log_step = torch.log(step)
    zero = torch.zeros_like(step)
    return StepSizeState(
        log_step=log_step, log_bar=log_step.clone(), hbar=zero.clone(),
        count=torch.ones_like(step), mu=torch.log(10.0 * step),
        accept_sum=zero.clone(), accept_count=zero.clone())


def current_step_size(state, warmup):
    """The noisy step during warmup, the averaged one after it."""
    return torch.exp(state.log_step if warmup else state.log_bar)


def update_step_size(state, accept_stat, warmup, target=0.8, gamma=0.05,
                     k=0.75, t_0=10., adapt=True):
    """One dual-averaging update in warmup (``step_size.py:45-66``); after
    warmup only the acceptance accumulators move."""
    if not warmup:
        return state._replace(accept_sum=state.accept_sum + accept_stat,
                              accept_count=state.accept_count + 1)
    if not adapt:
        return state
    w = 1.0 / (state.count + t_0)
    hbar = (1.0 - w) * state.hbar + w * (target - accept_stat)
    log_step = state.mu - hbar * torch.sqrt(state.count) / gamma
    mk = state.count ** (-k)
    log_bar = mk * log_step + (1.0 - mk) * state.log_bar
    return state._replace(log_step=log_step, log_bar=log_bar, hbar=hbar,
                          count=state.count + 1)


def check_acceptance(state, target, chain_id=None):
    """Post-hoc beta-interval acceptance check; a warning string or None."""
    n = float(np.asarray(state.accept_count))
    if n <= 0:
        return None
    mean_accept = float(np.asarray(state.accept_sum)) / n
    n_bound = min(100.0, n)
    n_good, n_bad = mean_accept * n_bound, (1.0 - mean_accept) * n_bound
    lower, upper = _sp_stats.beta(n_good + 1, n_bad + 1).interval(0.95)
    if target < lower or target > upper:
        msg_0 = f'for chain #{chain_id}, ' if chain_id is not None else ''
        return (msg_0 + 'the acceptance probability does not match the '
                f'target. It is {mean_accept}, but should be close to '
                f'{target}. Try to increase the number of tuning steps.')
    return None
