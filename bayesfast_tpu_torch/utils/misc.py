"""Misc host-side utilities (``bayesfast/utils/misc.py``).

A copy of ``bayesfast_tpu/utils/misc.py``, which imports no framework: the
port keeps its own copy rather than import the JAX package.
"""

import warnings

import numpy as np

__all__ = ['make_positive', 'SystematicResampler']


def make_positive(A, max_cond=1e5):
    """Clip eigenvalues so the matrix is positive definite with bounded
    condition number (``misc.py:12-18``)."""
    a, w = np.linalg.eigh(A)
    if a[-1] <= 0:
        raise ValueError('all the eigenvalues are non-positive.')
    i = np.argmax(a > a[-1] / max_cond)
    a[:i] = a[i]
    return w @ np.diag(a) @ w.T


class SystematicResampler:
    """Systematic resampling by rank between percentile nodes
    (``misc.py:21-110``)."""

    def __init__(self, nodes=(1., 100.), weights=None, require_unique=True):
        nodes = np.asarray(nodes, dtype=np.float64)
        if not (nodes.ndim == 1 and nodes.size > 1 and
                np.all(np.diff(nodes) > 0) and nodes[0] >= 0 and
                nodes[-1] <= 100):
            raise ValueError('invalid value for nodes.')
        self._nodes = nodes
        self._n_node = nodes.size
        if weights is None:
            self._weights = np.ones(self._n_node - 1) / (self._n_node - 1)
        else:
            weights = np.asarray(weights, dtype=np.float64)
            if not (weights.ndim == 1 and weights.size == self._n_node - 1 and
                    np.all(weights > 0)):
                raise ValueError('invalid value for weights.')
            self._weights = weights / np.sum(weights)
        self._require_unique = bool(require_unique)

    def run(self, a, n):
        a = np.asarray(a, dtype=np.float64)
        if a.ndim != 1:
            raise ValueError('invalid value for a.')
        n = int(n)
        if n <= 0:
            raise ValueError('invalid value for n.')

        n_w = (n * self._weights).astype(int)
        n_w[-1] += n - np.sum(n_w)
        n_c = np.cumsum(np.insert(n_w, 0, 0))
        i_all = np.empty(n, dtype=int)
        m = len(a)
        for j in range(self._n_node - 1):
            endpoint = (j == self._n_node - 2)
            i_j = np.linspace(self._nodes[j] * (m - 1) / 100,
                              self._nodes[j + 1] * (m - 1) / 100, n_w[j],
                              endpoint)
            i_all[n_c[j]:n_c[j + 1]] = i_j.astype(int)
        if np.unique(i_all).size < i_all.size:
            message = ('{:.1f}% of the resampled points are not unique. '
                       'Please consider giving me more points.'.format(
                           100 - np.unique(i_all).size / i_all.size * 100))
            if self._require_unique:
                raise RuntimeError(message)
            warnings.warn(message, RuntimeWarning)
        return np.argsort(a)[i_all]

    __call__ = run
