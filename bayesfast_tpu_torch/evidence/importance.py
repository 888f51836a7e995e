"""Importance-sampling estimate of a log normalizer ratio.

Parity target: ``bayesfast/evidence/importance.py:8-33``. Given draws from
a proposal q with known density and the unnormalized target logp evaluated
on them, ``log r = log mean(exp(logp - logq))`` estimates ``log Z``; the
draws are treated as independent (the proposal here is always an exactly
sampled flow), so the error bar carries no autocorrelation correction.

A numpy copy of ``bayesfast_tpu/evidence/importance.py`` (the port imports
nothing of the JAX package).
"""

import numpy as np
from scipy.special import logsumexp

from ._errors import as_log_weight_pair, iid_rel_var, quote_error

__all__ = ['importance']


def importance(logp_q, logq_q):
    """Return ``(logr, logr_err)`` from proposal-sample log densities.

    Parameters are the target and proposal log densities on the SAME
    proposal draws, shape (n,) or (chain, iteration).
    """
    lp, lq = as_log_weight_pair(logp_q, logq_q, 'logp_q', 'logq_q')
    log_w = (lp - lq).ravel()
    logr = float(logsumexp(log_w) - np.log(log_w.size))
    w_rel = np.exp(log_w - logr)  # weights in units of their mean
    rel_var = iid_rel_var(w_rel)
    err = quote_error(rel_var, rel_var)
    return logr, err
