"""(Truncated) multivariate normal log-pdf module.

Counterpart of ``bayesfast_tpu/modules/gaussian.py:20-164``. The quadratic
form runs batched in torch; the truncation normalization constants are
computed once on the host (scipy) and kept as constants.
"""

import numpy as np
import torch
from scipy.stats import multivariate_normal as _sp_mvn
from scipy.stats import norm as _sp_norm

from ..core.module import ModuleBase

__all__ = ['Gaussian']


class Gaussian(ModuleBase):
    """Univariate or multivariate Gaussian log-density node; a diagonal
    ``cov`` is given as a 1-d array of variances."""

    _output_min_length = 1
    _output_max_length = 1

    def __init__(self, mean, cov, input_vars='__var__', output_vars='__var__',
                 delete_vars=(), lower=None, upper=None, label=None):
        self.mean = mean
        self.cov = cov
        self.lower = lower
        self.upper = upper
        super().__init__(
            input_vars=input_vars, output_vars=output_vars,
            delete_vars=delete_vars, input_shapes=-1, output_shapes=None,
            input_scales=None, label=label)

    def _reset_norm(self):
        self._norm_0 = None
        self._norm_1 = None

    def _compute_norm(self):
        """Normalization incl. truncation (``gaussian.py:41-65``)."""
        dim = self._mean.shape[0]
        lower = (np.full(dim, -np.inf) if self._lower is None else self._lower)
        upper = (np.full(dim, np.inf) if self._upper is None else self._upper)
        if not np.all(lower <= upper):
            raise ValueError('lower should be <= upper.')
        if self._var is None:
            self._norm_0 = float(_sp_mvn.logpdf(
                x=self._mean, mean=self._mean, cov=self._cov))
            if np.all(np.isinf(lower)) and np.all(np.isinf(upper)):
                self._norm_1 = 0.0
            else:
                self._norm_1 = -np.log(_box_prob(self._mean, self._cov,
                                                 lower, upper))
        else:
            scale = np.sqrt(self._var)
            self._norm_0 = float(np.sum(_sp_norm.logpdf(
                x=self._mean, loc=self._mean, scale=scale)))
            cdf_1 = _sp_norm.cdf(x=upper, loc=self._mean, scale=scale)
            cdf_0 = _sp_norm.cdf(x=lower, loc=self._mean, scale=scale)
            self._norm_1 = -float(np.sum(np.log(cdf_1 - cdf_0)))

    def norms(self):
        """``(norm_0, norm_1)``: the normal's log normalization and the
        truncation correction."""
        if self._norm_0 is None or self._norm_1 is None:
            self._compute_norm()
        return self._norm_0, self._norm_1

    @property
    def mean(self):
        return self._mean

    @mean.setter
    def mean(self, m):
        m = np.atleast_1d(np.asarray(m, np.float64))
        if m.ndim != 1:
            raise ValueError('invalid value for mean.')
        self._mean = m
        self._reset_norm()

    @property
    def cov(self):
        return self._cov

    @cov.setter
    def cov(self, c):
        c = np.atleast_1d(np.asarray(c, np.float64))
        if c.ndim == 2:
            if c.shape[0] != c.shape[1]:
                raise ValueError('invalid value for cov.')
            self._cov = c
            self._cov_inv = np.linalg.inv(c)
            self._var = None
            self._var_inv = None
        elif c.ndim == 1:
            self._var = c
            self._var_inv = 1.0 / c
            self._cov = np.diag(c)
            self._cov_inv = np.diag(self._var_inv)
        else:
            raise ValueError('invalid value for cov.')
        self._reset_norm()

    @property
    def var_inv(self):
        """The diagonal precision (None for a full covariance)."""
        return self._var_inv

    @property
    def cov_inv(self):
        """The precision matrix."""
        return self._cov_inv

    @property
    def lower(self):
        return self._lower

    @lower.setter
    def lower(self, l):
        self._lower = None if l is None else np.atleast_1d(
            np.asarray(l, np.float64))
        self._reset_norm()

    @property
    def upper(self):
        return self._upper

    @upper.setter
    def upper(self, u):
        self._upper = None if u is None else np.atleast_1d(
            np.asarray(u, np.float64))
        self._reset_norm()

    def _fun(self, x):
        norm_0, norm_1 = self.norms()

        def t(a):
            return torch.as_tensor(a, dtype=x.dtype, device=x.device)

        delta = x - t(self._mean)
        if self._var_inv is None:
            dcd = torch.sum((delta @ t(self._cov_inv)) * delta, dim=-1)
        else:
            dcd = torch.sum(delta * t(self._var_inv) * delta, dim=-1)
        return -0.5 * dcd + norm_0 + norm_1


def _box_prob(mean, cov, lower, upper, n=2 ** 15):
    """Probability of a box under a correlated normal: inclusion-exclusion
    over the box corners with scipy's cdf up to 10 dimensions, Sobol QMC
    above."""
    dim = len(mean)
    if dim <= 10:
        d = _sp_mvn(mean=mean, cov=cov, allow_singular=False)
        p = 0.0
        for mask in range(2 ** dim):
            corner = np.where(
                [(mask >> i) & 1 for i in range(dim)], lower, upper)
            if np.any(np.isinf(corner) & (corner < 0)):
                continue
            sign = (-1) ** bin(mask).count('1')
            p += sign * d.cdf(corner)
        return max(min(p, 1.0), 0.0)
    from ..utils.sobol import multivariate_normal as sobol_mvn
    pts = sobol_mvn(mean, cov, n)
    inside = np.all((pts >= lower) & (pts <= upper), axis=-1)
    return float(np.mean(inside))
