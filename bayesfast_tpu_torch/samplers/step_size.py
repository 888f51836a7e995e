"""Nesterov dual-averaging step-size state, in torch.

Counterpart of ``bayesfast_tpu/samplers/step_size.py``. The per-transition
update runs inside the warmup chunk (``nuts_cuda.py``); this module holds
the state, its initialisation and the host-side post-warmup acceptance
check.
"""

from typing import Any, NamedTuple

import numpy as np
import torch
from scipy import stats as _sp_stats

from ..config import get_device

__all__ = ['StepSizeState', 'init_step_size', 'check_acceptance']


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
