"""Weighted Gaussian kernel density estimation.

Counterpart of ``bayesfast_tpu/utils/kde.py``: weighted Scott/Silverman
bandwidth with a ``bw_factor`` multiplier and the n-d ``logpdf`` (host
numpy, as in the JAX package), the 1-d ``cdf`` on one of the JAX package's
two routes (the KDE-cdf kernel, ``ops/kde.py``, on ``config.get_device()``
in ``config.get_dtype()``, or the windowed sum of the host library
``native/`` in float64), and ``resample`` from an explicit numpy or torch
generator.
"""

import numpy as np
import torch
from scipy.special import logsumexp

from ..config import get_device, get_dtype, kde_device_route
from .random import get_generator

__all__ = ['kde']


class kde:
    """Gaussian KDE with optional weights.

    Parameters
    ----------
    dataset : (n,) or (n, d) array
        Data points (rows are points).
    bw_method : 'scott' | 'silverman' | float
        Bandwidth rule.
    bw_factor : float
        Extra multiplicative factor on the bandwidth.
    weights : (n,) array or None
        Point weights (normalized internally).
    """

    def __init__(self, dataset, bw_method='scott', bw_factor=1.,
                 weights=None):
        dataset = np.asarray(dataset, np.float64)
        if dataset.ndim == 1:
            dataset = dataset[:, None]
        if dataset.ndim != 2 or dataset.shape[0] < 2:
            raise ValueError('dataset should have at least 2 points.')
        self.dataset = dataset
        self.n, self.d = dataset.shape
        if weights is None:
            self._weights = np.full(self.n, 1.0 / self.n)
        else:
            weights = np.asarray(weights, np.float64)
            if weights.shape != (self.n,):
                raise ValueError('invalid shape for weights.')
            self._weights = weights / np.sum(weights)
        self._neff = 1.0 / np.sum(self._weights ** 2)
        self._bw_factor = float(bw_factor)
        self._cdf_cache = None   # the host route's sorted data
        self.set_bandwidth(bw_method)

    @property
    def weights(self):
        return self._weights

    @property
    def neff(self):
        return self._neff

    def scotts_factor(self):
        return self._neff ** (-1.0 / (self.d + 4))

    def silverman_factor(self):
        return (self._neff * (self.d + 2) / 4.0) ** (-1.0 / (self.d + 4))

    def set_bandwidth(self, bw_method):
        if bw_method == 'scott':
            factor = self.scotts_factor()
        elif bw_method == 'silverman':
            factor = self.silverman_factor()
        elif np.isscalar(bw_method):
            factor = float(bw_method)
        else:
            raise ValueError('invalid bw_method.')
        factor *= self._bw_factor
        mean = self._weights @ self.dataset
        diff = self.dataset - mean
        cov = (diff * self._weights[:, None]).T @ diff / (
            1.0 - np.sum(self._weights ** 2))
        self.covariance = np.atleast_2d(cov) * factor ** 2
        self.inv_cov = np.linalg.inv(self.covariance)
        self._norm_factor = np.sqrt(
            np.linalg.det(2 * np.pi * self.covariance))
        self._dev_cache = None

    def _diff(self, x):
        x = np.asarray(x, np.float64)
        if self.d == 1 and x.ndim <= 1:
            x = np.atleast_1d(x)[:, None]
        elif x.ndim == 1:
            x = x[None, :]
        return x[:, None, :] - self.dataset[None, :, :]

    def logpdf(self, x):
        diff = self._diff(x)
        energy = np.einsum('lmi,ij,lmj->lm', diff, self.inv_cov / 2, diff)
        return logsumexp(-energy, b=self._weights / self._norm_factor,
                         axis=1)

    def pdf(self, x):
        return np.exp(self.logpdf(x))

    __call__ = pdf

    def cdf(self, x):
        """1-d cdf, the weighted sum of normal cdfs; numpy float64 out. On
        the device route (``config.kde_device_route`` of ``x.size * n``
        on the configured device) the KDE-cdf kernel
        (``ops.kde.kde_cdf_device``) on that device and the configured
        dtype sums it, else the host library (``_cdf_host``)."""
        if self.d != 1:
            raise NotImplementedError('currently only supports cdf for 1-d '
                                      'kde')
        x = np.atleast_1d(np.asarray(x, np.float64))
        if kde_device_route(x.size * self.n, get_device()):
            return self._cdf_device(x)
        return self._cdf_host(x)

    def _cdf_device(self, x):
        from ..ops.kde import kde_cdf_device
        dtype, device = get_dtype(), get_device()
        if self._dev_cache is None or self._dev_cache[0] != (dtype, device):
            self._dev_cache = ((dtype, device), tuple(
                torch.as_tensor(a, dtype=dtype, device=device)
                for a in (self.dataset[:, 0], self._weights,
                          np.sqrt(self.covariance[0, 0]))))
        data, w, h = self._dev_cache[1]
        out = kde_cdf_device(torch.as_tensor(x, dtype=dtype, device=device),
                             data, w, h)
        return out.cpu().numpy().astype(np.float64)

    def _cdf_host(self, x):
        """The cdf by the host library's windowed sum
        (``native.bindings.kde_cdf_sorted``), float64: the data sorted
        once per kde (each spline fit evaluates the cdf several times), and
        each point sums only the +-8h window of the sorted data above the
        prefix weight below it."""
        from ..native import bindings as native
        if self._cdf_cache is None:
            order = np.argsort(self.dataset[:, 0], kind='stable')
            sdata = np.ascontiguousarray(self.dataset[order, 0])
            sw = np.ascontiguousarray(self._weights[order])
            prefix = np.concatenate(([0.0], np.cumsum(sw)))
            self._cdf_cache = (sdata, sw, prefix)
        sdata, sw, prefix = self._cdf_cache
        return native.kde_cdf_sorted(sdata, sw, prefix,
                                     np.sqrt(self.covariance[0, 0]), x)

    def resample(self, size=None, random_generator=None):
        """Draw samples from the estimated density: pick a data point by
        weight, add kernel noise.

        Parameters
        ----------
        size : int, optional
            Number of draws; defaults to the effective sample size.
        random_generator : np.random.Generator or torch.Generator, optional
            Defaults to a numpy generator seeded from the port's global
            generator (``utils.random``).

        Returns
        -------
        (size, d) ndarray of draws.
        """
        if size is None:
            size = int(self.neff)
        if random_generator is None:
            random_generator = get_generator()
        if isinstance(random_generator, torch.Generator):
            seed = int(torch.randint(0, 2 ** 62, (),
                                     generator=random_generator))
            random_generator = np.random.default_rng(seed)
        indices = random_generator.choice(self.n, size=size, p=self._weights)
        noise = random_generator.multivariate_normal(
            np.zeros(self.d), self.covariance, size=size)
        return self.dataset[indices] + noise
