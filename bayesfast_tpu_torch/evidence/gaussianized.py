"""Gaussianized evidence estimators: GBS / GIS / GHM.

Counterpart of ``bayesfast_tpu/evidence/gaussianized.py``. Each estimator
fits a SIT normalizing flow (``transforms.SIT``, on ``config.get_device()``)
to posterior samples and combines the flow's tractable density q with the
target p: GBS bridges between q-draws and held-out chains, GIS
importance-samples q-draws, GHM harmonic-means held-out chains. The target
logp is evaluated in one batched call: a torch logp (an ``nn.Module``, as
the port's densities are) gets the flattened batch as a tensor on the
device, any other callable gets it as a numpy array (``DensityLite.logp``
takes numpy and evaluates on the device itself).
"""

import time
import warnings

import numpy as np
import torch

from ..config import get_device, get_dtype
from ..samplers.sample_trace import TraceTuple
from ..transforms import SIT
from .bridge import bridge
from .harmonic import harmonic
from .importance import importance

__all__ = ['GBS', 'GIS', 'GHM']


def _as_chain_array(x_p):
    """Coerce x_p to a (chain, iter, dim) or (iter, dim) sample array,
    also returning the trace's exact call count when one is available."""
    n_call = None
    if isinstance(x_p, TraceTuple):
        n_call = x_p.n_call
        x_p = x_p.get(flatten=False)
    else:
        x_p = np.asarray(x_p)
        if not 2 <= x_p.ndim <= 3:
            raise ValueError('x_p should be a TraceTuple or an array with '
                             '2 or 3 dims (chains x iters x dim).')
    if x_p.shape[-1] <= 1 or np.prod(x_p.shape[:-1]) <= 1:
        raise ValueError('x_p needs more than one sample and more than one '
                         'dimension.')
    if x_p.shape[0] == 1:
        x_p = x_p[0]  # collapse a singleton chain axis
    return x_p, n_call


def _batched_logp(logp, x):
    """Evaluate a logp callable over any leading shape in one batched call:
    a torch logp (``nn.Module``) on the device, anything else on numpy."""
    lead = x.shape[:-1]
    flat = x.reshape((-1, x.shape[-1]))
    if isinstance(logp, torch.nn.Module):
        with torch.no_grad():
            out = logp(torch.as_tensor(flat, dtype=get_dtype(),
                                       device=get_device())).cpu().numpy()
    else:
        out = np.asarray(logp(flat))
    return out.reshape(lead)


def _split_or_recompute_logp_p(logp, x_p, logp_p, n_half):
    """Use caller-supplied logp_p values for the held-out half when their
    shape matches; otherwise recompute them."""
    if logp_p is not None:
        logp_p = np.asarray(logp_p)
        if logp_p.shape == x_p.shape[:-1]:
            return logp_p[n_half:]
        warnings.warn('ignoring logp_p: its shape does not match x_p; '
                      'recomputing from the logp callable.', RuntimeWarning)
    return _batched_logp(logp, x_p[n_half:])


class _SITEstimator:
    """Common SIT-flow plumbing for the three estimators."""

    def __init__(self, sit=None):
        if sit is None or isinstance(sit, dict):
            sit = SIT(**(sit or {}))
        elif not isinstance(sit, SIT):
            raise ValueError('sit should be None, an options dict, or a SIT '
                             'instance.')
        self._sit = sit

    @property
    def sit(self):
        return self._sit

    def run(self, x_p, logp, logp_p=None):
        raise NotImplementedError('abstract method.')

    def __call__(self, *args, **kwargs):
        return self.run(*args, **kwargs)


class _ProposalSized(_SITEstimator):
    """The proposal-count policy shared by GBS and GIS: n_q explicit, or
    f_call x the trace's true-model call count, optionally capped."""

    def __init__(self, sit=None, n_q=None, f_call=0.05, n_q_max=None):
        super().__init__(sit)
        if n_q is not None:
            n_q = int(n_q)
            if n_q <= 0:
                raise ValueError('n_q should be a positive int or None.')
        self._n_q = n_q
        if f_call is not None:
            f_call = float(f_call)
            if f_call <= 0:
                raise ValueError('f_call should be a positive float or '
                                 'None.')
        self._f_call = f_call
        if n_q_max is not None:
            n_q_max = int(n_q_max)
            if n_q_max <= 0:
                raise ValueError('n_q_max should be a positive int or None.')
        self.n_q_max = n_q_max

    n_q = property(lambda self: self._n_q)
    f_call = property(lambda self: self._f_call)

    def _proposal_count(self, x_p, n_call):
        if self._n_q is not None:
            n_q = self._n_q
        elif self._f_call is not None and n_call is not None:
            n_q = int(n_call * self._f_call)
        else:
            if self._f_call is not None:
                warnings.warn('f_call sizing needs a TraceTuple (for its '
                              'call count); matching the posterior sample '
                              'count instead.', RuntimeWarning)
            n_q = int(np.prod(x_p.shape[:-1]))
        if self.n_q_max is not None:
            n_q = min(n_q, self.n_q_max)
        return n_q

    def run(self, x_p, logp, logp_p=None):
        if not callable(logp):
            raise ValueError('logp should be callable.')
        x_p, n_call = _as_chain_array(x_p)
        return self._estimate(logp, x_p, logp_p,
                              self._proposal_count(x_p, n_call))

    def _estimate(self, logp, x_p, logp_p, n_q):
        raise NotImplementedError('abstract method.')


class GBS(_ProposalSized):
    """Gaussianized Bridge Sampling: fit the flow on the first half of the
    chains, bridge between n_q flow draws and the held-out half.
    ``last_profile`` holds the last run's host seconds per phase (each
    phase ends in host numpy arrays, so the device work is in them)."""

    def _estimate(self, logp, x_p, logp_p, n_q):
        prof = {}

        def lap(name, t0):
            t1 = time.time()
            prof[name] = t1 - t0
            return t1

        n_half = x_p.shape[0] // 2
        t0 = time.time()
        self.sit.fit(data=x_p[:n_half])
        t0 = lap('sit_fit_s', t0)
        x_q = self.sit.sample(n_q)[0]
        t0 = lap('flow_sample_s', t0)
        logp_p = _split_or_recompute_logp_p(logp, x_p, logp_p, n_half)
        logp_q = _batched_logp(logp, x_q)
        t0 = lap('logp_batches_s', t0)
        logq_p = self.sit.logq(x_p[n_half:])
        logq_q = self.sit.logq(x_q)
        t0 = lap('flow_logq_s', t0)
        out = bridge(logp_p, logp_q, logq_p, logq_q)
        lap('bridge_s', t0)
        self.last_profile = prof
        return out


class GIS(_ProposalSized):
    """Gaussianized Importance Sampling: fit the flow on all samples,
    importance-sample n_q flow draws."""

    def _estimate(self, logp, x_p, logp_p, n_q):
        self.sit.fit(data=x_p)
        x_q = self.sit.sample(n_q)[0]
        return importance(_batched_logp(logp, x_q), self.sit.logq(x_q))


class GHM(_SITEstimator):
    """Gaussianized Harmonic Mean: fit the flow on the first half of the
    chains, harmonic-mean the held-out half (no proposal draws, so logp may
    be omitted when logp_p is given)."""

    def run(self, x_p, logp=None, logp_p=None):
        x_p, _ = _as_chain_array(x_p)
        n_half = x_p.shape[0] // 2

        if logp_p is not None:
            logp_p = np.asarray(logp_p)
            if logp_p.shape == x_p.shape[:-1]:
                logp_p = logp_p[n_half:]
            else:
                warnings.warn('ignoring logp_p: its shape does not match '
                              'x_p; recomputing from the logp callable.',
                              RuntimeWarning)
                logp_p = None
        if logp_p is None:
            if not callable(logp):
                raise ValueError('GHM needs either matching logp_p values '
                                 'or a callable logp.')
            logp_p = _batched_logp(logp, x_p[n_half:])

        self.sit.fit(data=x_p[:n_half])
        return harmonic(logp_p, self.sit.logq(x_p[n_half:]))
