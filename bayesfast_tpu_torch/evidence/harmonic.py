"""Harmonic-mean estimate of a log normalizer ratio.

Parity target: ``bayesfast/evidence/harmonic.py:9-46``. Given POSTERIOR
draws with an auxiliary normalized density q evaluated on them,
``log r = -log mean(exp(logq - logp))`` estimates ``log Z``. Because the
draws come from MCMC chains, the error bar is deflated by the integrated
autocorrelation time of the weight series, estimated both per chain and
flattened (see ``_errors``).

A numpy copy of ``bayesfast_tpu/evidence/harmonic.py`` (the port imports
nothing of the JAX package).
"""

import numpy as np
from scipy.special import logsumexp

from ._errors import as_log_weight_pair, chain_rel_var, quote_error

__all__ = ['harmonic']


def harmonic(logp_p, logq_p):
    """Return ``(logr, logr_err)`` from posterior-sample log densities.

    Parameters are the target and auxiliary log densities on the SAME
    posterior draws, shape (n,) or (chain, iteration).
    """
    lp, lq = as_log_weight_pair(logp_p, logq_p, 'logp_p', 'logq_p')
    log_w = (lq - lp).ravel()
    logr = float(np.log(log_w.size) - logsumexp(log_w))
    w_rel = np.exp(log_w + logr)  # weights in units of their mean
    rel_chained, rel_flat = chain_rel_var(w_rel, lp.shape)
    err = quote_error(rel_chained, rel_flat)
    return logr, err
