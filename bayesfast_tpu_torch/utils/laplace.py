"""MAP + Laplace approximation.

Counterpart of ``bayesfast_tpu/utils/laplace.py``. scipy's Newton-CG finds
the maximum; when a torch function of the density is given (``traceable``)
its gradient and Hessian come from autograd in float64 on the configured
device, otherwise from central finite differences of ``logp``.
"""

from collections import namedtuple
import warnings

import numpy as np
import torch
from scipy.optimize import minimize

from ..config import get_device
from .sobol import multivariate_normal
from .misc import make_positive

__all__ = ['Laplace', 'LaplaceResult']

LaplaceResult = namedtuple('LaplaceResult',
                           'x_max, f_max, samples, cov, beta, opt_result')


def _autograd_derivatives(traceable):
    """Host ``grad(x)`` and ``hess(x)`` of a torch scalar function of a (D,)
    tensor, evaluated in float64 on the configured device."""
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=torch.float64,
                               device=get_device())

    def grad(x):
        with torch.enable_grad():
            xt = t(x).requires_grad_(True)
            (g,) = torch.autograd.grad(traceable(xt), xt)
        return g.cpu().numpy()

    def hess(x):
        with torch.enable_grad():
            h = torch.autograd.functional.hessian(traceable, t(x))
        return h.cpu().numpy()

    return grad, hess


class Laplace:
    """Evaluate and sample the Laplace approximation of a target density."""

    def __init__(self, optimize_method='Newton-CG', optimize_tol=1e-5,
                 optimize_options=None, max_cond=1e5, n_sample=2000, beta=1.,
                 mvn_generator=None):
        self._optimize_method = optimize_method
        if optimize_tol is not None:
            optimize_tol = float(optimize_tol)
            if optimize_tol <= 0:
                raise ValueError('invalid value for optimize_tol.')
        self._optimize_tol = optimize_tol
        self._optimize_options = dict(optimize_options or {})
        max_cond = float(max_cond)
        if max_cond <= 0:
            raise ValueError('max_cond should be a positive float.')
        self._max_cond = max_cond
        if n_sample is not None:
            n_sample = int(n_sample)
            if n_sample <= 0:
                raise ValueError('invalid value for n_sample.')
        self._n_sample = n_sample
        beta = float(beta)
        if beta <= 0:
            raise ValueError('beta should be a positive float.')
        self._beta = beta
        self._mvn_generator = (multivariate_normal if mvn_generator is None
                               else mvn_generator)

    @property
    def beta(self):
        return self._beta

    def run(self, logp, x_0, grad=None, hess=None, traceable=None):
        """Optimize and draw tempered Laplace samples.

        Parameters
        ----------
        logp : callable
            Host-side ``logp(x_1d) -> float``.
        x_0 : 1-d array
            Optimization start.
        grad, hess : callable or None
            Explicit derivatives. If None and ``traceable`` is given, they
            come from autograd through it.
        traceable : callable or None
            Torch function of a (D,) tensor to a scalar, equivalent to
            ``logp``; evaluated in float64.
        """
        if not callable(logp):
            raise ValueError('logp should be callable.')
        x_0 = np.atleast_1d(np.asarray(x_0, np.float64))
        dim = x_0.shape[-1]
        n_sample = (min(1000, dim * 10) if self._n_sample is None
                    else self._n_sample)

        if traceable is not None:
            g_ad, h_ad = _autograd_derivatives(traceable)
            grad = g_ad if grad is None else grad
            hess = h_ad if hess is None else hess
        if grad is None or hess is None:
            # finite-difference fallback
            def _fd_grad(x, eps=1e-6):
                x = np.asarray(x, np.float64)
                g = np.empty_like(x)
                for i in range(x.size):
                    dx = np.zeros_like(x)
                    dx[i] = eps * max(1.0, abs(x[i]))
                    g[i] = (logp(x + dx) - logp(x - dx)) / (2 * dx[i])
                return g
            if grad is None:
                grad = _fd_grad
            if hess is None:
                hess = lambda x: _fd_jac(_fd_grad, x)

        opt = minimize(fun=lambda x: -logp(x), x0=x_0,
                       method=self._optimize_method,
                       jac=lambda x: -grad(x), hess=lambda x: -hess(x),
                       tol=self._optimize_tol, options=self._optimize_options)
        if not opt.success:
            warnings.warn(f'the optimization stopped at {opt.x}, but maybe it '
                          'has not converged yet.', RuntimeWarning)
        x_max = opt.x
        f_max = -opt.fun
        cov = np.linalg.inv(make_positive(-hess(x_max), self._max_cond))
        samples = self._mvn_generator(x_max, cov / self._beta, n_sample)
        return LaplaceResult(x_max, f_max, samples, cov, self._beta, opt)

    @staticmethod
    def untemper_laplace_samples(laplace_result):
        """Rescale tempered samples back to beta=1 (``laplace.py:119-126``)."""
        if not isinstance(laplace_result, LaplaceResult):
            raise ValueError('laplace_result should be a LaplaceResult.')
        delta = laplace_result.samples - laplace_result.x_max
        delta = delta * laplace_result.beta ** 0.5
        return laplace_result.x_max + delta


def _fd_jac(grad, x, eps=1e-5):
    x = np.asarray(x, np.float64)
    n = x.size
    out = np.empty((n, n))
    for i in range(n):
        dx = np.zeros_like(x)
        dx[i] = eps * max(1.0, abs(x[i]))
        out[:, i] = (grad(x + dx) - grad(x - dx)) / (2 * dx[i])
    return (out + out.T) / 2
