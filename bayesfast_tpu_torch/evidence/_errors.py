"""Shared error-bar machinery for the ratio-of-normalizers estimators.

All three estimators (``bridge``, ``importance``, ``harmonic``) reduce to a
log-mean-exp of some weight array and quote its relative Monte-Carlo error
``var(w) / mean(w)^2 / n_effective``. When the weights come from MCMC
chains, ``n_effective`` must be deflated by the integrated autocorrelation
time tau; following the reference protocol
(``bayesfast/evidence/bridge.py:60-79``) tau is estimated twice — once per
chain ("chained") and once on the flattened series — and the LARGER of the
two resulting error bars is quoted, with a consistency warning when they
disagree by more than 25%.

A numpy copy of ``bayesfast_tpu/evidence/_errors.py`` (the port imports
nothing of the JAX package).
"""

import warnings

import numpy as np

from ..utils.acor import integrated_time

__all__ = ['as_log_weight_pair', 'iid_rel_var', 'chain_rel_var',
           'quote_error']

#: relative-error threshold above which the estimate is flagged
ERR_RELIABLE_MAX = 0.25
#: flat-vs-chained tau discrepancy threshold for the consistency warning
TAU_CONSISTENCY_MAX = 0.25


def as_log_weight_pair(log_num, log_den, num_name, den_name):
    """Validate a (numerator, denominator) pair of log-value arrays.

    Both must share a common shape of rank 1 (flat draws) or 2
    (chain, iteration). Returns float64 arrays.
    """
    a = np.asarray(log_num, dtype=np.float64)
    b = np.asarray(log_den, dtype=np.float64)
    if a.ndim not in (1, 2):
        raise ValueError(f'{num_name} should be 1-d (flat draws) or 2-d '
                         f'(chain, iteration), got ndim={a.ndim}.')
    if a.shape != b.shape:
        raise ValueError(f'{num_name} {a.shape} and {den_name} {b.shape} '
                         'must have the same shape.')
    return a, b


def iid_rel_var(w):
    """``var(w)/mean(w)^2/n`` for independent draws; ``w`` any shape."""
    w = np.ravel(w)
    return np.var(w) / np.mean(w) ** 2 / w.size


def chain_rel_var(w, chain_shape):
    """Autocorrelation-deflated relative variance of chain-ordered weights.

    ``w`` is the flat weight series, ``chain_shape`` its original
    (chain, iteration) or (iteration,) shape. Returns the pair
    ``(rel_var_chained, rel_var_flat)``: tau estimated per chain vs on the
    single concatenated series.
    """
    base = np.var(w) / np.mean(w) ** 2 / w.size
    tau_chained = integrated_time(
        w.reshape(chain_shape)[..., None], quiet=True)[0]
    tau_flat = integrated_time(w[..., None], quiet=True)[0]
    return base * tau_chained, base * tau_flat


def quote_error(rel_var_chained, rel_var_flat, extra_rel_var=0.0):
    """Combine the two tau conventions into the quoted error bar.

    Adds ``extra_rel_var`` (e.g. an independent proposal-side term) to both
    variants, quotes the larger error, and issues the reference's two
    reliability warnings.
    """
    err_chained = float(np.sqrt(rel_var_chained + extra_rel_var))
    err_flat = float(np.sqrt(rel_var_flat + extra_rel_var))
    err = max(err_chained, err_flat)
    spread = abs(err_flat - err_chained) / max(min(err_flat, err_chained),
                                               np.finfo(np.float64).tiny)
    if spread > TAU_CONSISTENCY_MAX:
        warnings.warn(
            'chained vs flattened autocorrelation times give error bars '
            f'differing by {100 * spread:.0f}% (> 25%); the quoted logr '
            'error may be unreliable.', RuntimeWarning)
    if err > ERR_RELIABLE_MAX:
        warnings.warn(
            f'estimated logr error {err:.3g} exceeds 0.25; the estimate '
            'may be unreliable.', RuntimeWarning)
    return err
