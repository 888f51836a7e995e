"""Optimal bridge sampling estimator of a log normalizer ratio.

Parity target: ``bayesfast/evidence/bridge.py:10-76`` (Meng & Wong optimal
bridge). Inputs are the four cross evaluations — target and proposal log
densities on posterior draws (``*_p``) and on proposal draws (``*_q``).
The optimal-bridge fixed point is found as the root of the 1-d score
``score(logr) = 0``; the error combines the i.i.d. proposal-side term with
the autocorrelation-deflated posterior-side term through the shared
``_errors`` protocol (per-chain vs flattened tau, quote the larger).

A numpy copy of ``bayesfast_tpu/evidence/bridge.py`` (the port imports
nothing of the JAX package).
"""

import numpy as np
from scipy.special import logsumexp
from scipy.optimize import root_scalar

from ._errors import (as_log_weight_pair, iid_rel_var, chain_rel_var,
                      quote_error)

__all__ = ['bridge']


def _log_sigmoid(x):
    """log(1/(1+exp(-x))), stably, elementwise."""
    return -np.logaddexp(0.0, -x)


def bridge(logp_p, logp_q, logq_p, logq_q):
    """Return ``(logr, logr_err)`` from the four cross log densities.

    ``logp_p``/``logq_p`` share the posterior-draw shape ((n,) or
    (chain, iter)); ``logp_q``/``logq_q`` share the proposal-draw shape.
    """
    lpp, lqp = as_log_weight_pair(logp_p, logq_p, 'logp_p', 'logq_p')
    lpq, lqq = as_log_weight_pair(logp_q, logq_q, 'logp_q', 'logq_q')

    n_p, n_q = lpp.size, lqq.size
    log_s = np.log(n_p / n_q)
    # log importance ratios entering the optimal bridge, flat
    a = (lqp - lpp).ravel() - log_s   # posterior side
    b = (lpq - lqq).ravel() + log_s   # proposal side

    def score(logr):
        # logsumexp of sigmoid terms on each side; root at the fixed point
        pos = logsumexp(_log_sigmoid(logr + a))
        neg = logsumexp(_log_sigmoid(b - logr))
        return pos - neg

    logr = float(root_scalar(score, x0=0.0, x1=5.0).root)

    # error estimate: optimal-bridge weight functions at the solution
    log_np = np.log(n_p / (n_p + n_q))
    log_nq = np.log(n_q / (n_p + n_q))
    lpq_f = lpq.ravel()
    lqq_f = lqq.ravel()
    lpp_f = lpp.ravel()
    lqp_f = lqp.ravel()
    f_q = np.exp(lpq_f - logr - np.logaddexp(lpq_f - logr + log_np,
                                             lqq_f + log_nq))
    f_p = np.exp(lqp_f - np.logaddexp(lpp_f - logr + log_np,
                                      lqp_f + log_nq))
    rel_var_q = iid_rel_var(f_q)
    rel_chained, rel_flat = chain_rel_var(f_p, lpp.shape)
    err = quote_error(rel_chained, rel_flat, extra_rel_var=rel_var_q)
    return logr, err
