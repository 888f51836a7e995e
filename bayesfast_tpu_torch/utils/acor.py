"""Integrated autocorrelation time (``bayesfast/utils/acor.py``, an
emcee-derived estimator: FFT autocorrelation + Sokal auto-windowing).

Used for evidence error bars; runs on host numpy (cheap), with the FFT
convolution vectorized across walkers and dimensions instead of the
reference's per-dimension Python loop.
"""

import logging

import numpy as np

__all__ = ['integrated_time', 'effective_sample_size', 'rhat',
           'AutocorrError']


def next_pow_two(n):
    i = 1
    while i < n:
        i <<= 1
    return i


def function_1d(x):
    """Normalized autocorrelation function of a 1-d series."""
    x = np.atleast_1d(x)
    if x.ndim != 1:
        raise ValueError('invalid dimensions for 1D autocorrelation function')
    n = next_pow_two(len(x))
    f = np.fft.fft(x - np.mean(x), n=2 * n)
    acf = np.fft.ifft(f * np.conjugate(f))[:len(x)].real
    acf /= acf[0]
    return acf


def auto_window(taus, c):
    m = np.arange(len(taus)) < c * taus
    if np.any(m):
        return np.argmin(m)
    return len(taus) - 1


def integrated_time(x, c=5, tol=50, quiet=False):
    """Sokal-windowed integrated autocorrelation time.

    ``x`` has shape (n_t,), (n_t, n_d), or (n_w, n_t, n_d) — walker axis
    first, time axis second, parameter axis last (reference convention).
    """
    x = np.atleast_1d(x)
    if x.ndim == 1:
        x = x[np.newaxis, :, np.newaxis]
    if x.ndim == 2:
        x = x[np.newaxis, :, :]
    if x.ndim != 3:
        raise ValueError('invalid dimensions.')

    n_w, n_t, n_d = x.shape
    # vectorized FFT autocorrelation over (walker, dim)
    n = next_pow_two(n_t)
    xc = x - x.mean(axis=1, keepdims=True)
    f = np.fft.fft(xc, n=2 * n, axis=1)
    acf = np.fft.ifft(f * np.conjugate(f), axis=1)[:, :n_t].real
    acf /= acf[:, :1, :]
    f_mean = acf.mean(axis=0)  # (n_t, n_d)

    taus = 2.0 * np.cumsum(f_mean, axis=0) - 1.0
    tau_est = np.empty(n_d)
    for d in range(n_d):
        w = auto_window(taus[:, d], c)
        tau_est[d] = taus[w, d]

    flag = tol * tau_est > n_t
    if np.any(flag):
        msg = (
            'The chain is shorter than {0} times the integrated '
            'autocorrelation time for {1} parameter(s). Use this estimate '
            'with caution and run a longer chain!\n'
        ).format(tol, np.sum(flag))
        msg += 'N/{0} = {1:.0f};\ntau: {2}'.format(tol, n_t / tol, tau_est)
        if not quiet:
            raise AutocorrError(tau_est, msg)
        logging.warning(msg)
    return tau_est


class AutocorrError(Exception):
    """Chain too short to estimate the autocorrelation time."""

    def __init__(self, tau, *args, **kwargs):
        self.tau = tau
        super().__init__(*args, **kwargs)


def effective_sample_size(x, c=5, tol=50):
    """Effective sample size from the integrated autocorrelation time.

    ``x`` has shape (n_chain, n_iter, dim) (or lower-dim variants accepted
    by ``integrated_time``); returns an (dim,) array of ESS estimates
    ``n_chain * n_iter / tau``.
    """
    x = np.atleast_1d(x)
    if x.ndim == 1:
        x = x[np.newaxis, :, np.newaxis]
    if x.ndim == 2:
        x = x[np.newaxis, :, :]
    tau = integrated_time(x, c=c, tol=tol, quiet=True)
    n_w, n_t, _ = x.shape
    return n_w * n_t / np.maximum(tau, 1.0)


def rhat(x, split=True, rank_normalized=True):
    """Potential-scale-reduction diagnostic (split-R-hat).

    ``x`` has shape (n_chain, n_iter, dim) or (n_chain, n_iter); returns an
    (dim,) array (or scalar for 2-d input). Implements the rank-normalized
    split-R-hat of Vehtari et al. (2021): chains are split in half, values
    are (optionally) replaced by normal scores of their pooled ranks, and
    R-hat = sqrt((W (n-1)/n + B/n) / W) over the 2*n_chain half-chains.
    Values close to 1 indicate convergence (< 1.01 is the usual threshold).

    The reference ships no convergence diagnostic at all; this plus
    ``effective_sample_size`` covers the standard post-sampling checks.
    """
    from scipy.special import ndtri as _ndtri

    x = np.asarray(x, np.float64)
    scalar_out = x.ndim == 2
    if x.ndim == 2:
        x = x[:, :, np.newaxis]
    if x.ndim != 3:
        raise ValueError('x should be (n_chain, n_iter, dim).')
    m, n, d = x.shape
    if split:
        half = n // 2
        if half < 2:
            raise ValueError('need at least 4 iterations for split-rhat.')
        x = np.concatenate([x[:, :half], x[:, half:2 * half]], axis=0)
        m, n = 2 * m, half
    if rank_normalized:
        flat = x.reshape(m * n, d)
        ranks = np.argsort(np.argsort(flat, axis=0), axis=0) + 1.0
        z = _ndtri((ranks - 0.375) / (m * n + 0.25))  # Blom offsets
        x = z.reshape(m, n, d)
    chain_mean = x.mean(axis=1)                    # (m, d)
    chain_var = x.var(axis=1, ddof=1)              # (m, d)
    W = chain_var.mean(axis=0)
    B = n * chain_mean.var(axis=0, ddof=1)
    var_plus = W * (n - 1) / n + B / n
    out = np.sqrt(var_plus / np.maximum(W, 1e-300))
    return float(out[0]) if scalar_out else out
