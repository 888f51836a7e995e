"""Trace configuration and result objects, one trace type per sampler.

Counterpart of ``bayesfast_tpu/samplers/sample_trace.py``: a trace holds
all chains as stacked host arrays; ``TraceTuple`` and ``ChainTrace`` give
the per-chain views. The random generator is a ``torch.Generator``
(``utils/random.py``) in place of a jax key. ``save`` / ``load`` (on a
trace and on ``TraceTuple``) go through ``utils/checkpoint.py``; the
sampler's carry rides along, so a loaded trace continues where it stopped.
"""

from collections import OrderedDict

import numpy as np
import torch

from ..utils.random import generator_from_seed, get_generator

__all__ = ['SampleTrace', 'NTrace', 'HTrace', 'TNTrace', 'THTrace', 'ETrace',
           'CTrace', 'TraceTuple', 'ChainTrace', 'StatsView']


nstats_items = ('logp', 'energy', 'tree_depth', 'tree_size',
                'mean_tree_accept', 'step_size', 'step_size_bar', 'warmup',
                'energy_change', 'max_energy_change', 'diverging')

hstats_items = ('logp', 'energy', 'n_int_step', 'accept_stat', 'accepted',
                'step_size', 'step_size_bar', 'warmup', 'energy_change',
                'diverging')

tnstats_items = ('u', 'weight') + nstats_items

thstats_items = ('u', 'weight') + hstats_items

cstats_items = ('logp', 'energy', 'n_int_step', 'accept_stat', 'accepted',
                'traj_len', 'step_size', 'step_size_bar', 'warmup',
                'energy_change', 'diverging')

estats_items = ('logp', 'accept_stat', 'accepted', 'warmup')


class StatsView:
    """Per-iteration statistics; ``arrays`` maps stat name -> ndarray with
    iteration as the LAST axis (``(n_iter,)`` or ``(n_chain, n_iter)``)."""

    def __init__(self, items, arrays, n_warmup):
        self._items = items
        self._arrays = arrays
        self._n_warmup = n_warmup
        for k, v in arrays.items():
            setattr(self, '_' + k, v)

    @property
    def stats_items(self):
        return self._items

    @property
    def n_iter(self):
        return self._arrays['logp'].shape[-1]

    @property
    def n_warmup(self):
        return self._n_warmup

    def get(self, since_iter=None, include_warmup=False):
        if since_iter is None:
            since_iter = 0 if include_warmup else self._n_warmup
        since_iter = int(since_iter)
        return OrderedDict(
            (k, self._arrays[k][..., since_iter:]) for k in self._items)

    __call__ = get


class SampleTrace:
    """Shared config for all trace types."""

    def __init__(self, n_chain=4, n_iter=1500, n_warmup=500, x_0=None,
                 random_generator=None):
        self._chain_initialized = False
        self._i_iter = 0
        self.n_chain = n_chain
        self.n_iter = n_iter
        self.n_warmup = n_warmup
        self.x_0 = x_0
        self.random_generator = random_generator
        self._x_0_transformed = False

    @property
    def chain_initialized(self):
        return self._chain_initialized

    @property
    def n_chain(self):
        return self._n_chain

    @n_chain.setter
    def n_chain(self, n):
        if self._chain_initialized:
            raise RuntimeError('you should not change n_chain once the chain '
                               'is initialized.')
        n = int(n)
        if n <= 0:
            raise ValueError(f'n_chain should be a positive int, instead of '
                             f'{n}.')
        self._n_chain = n

    @property
    def n_iter(self):
        return getattr(self, '_n_iter', 0)

    @n_iter.setter
    def n_iter(self, n):
        n = int(n)
        if n <= 0:
            raise ValueError(f'n_iter should be a positive int, instead of '
                             f'{n}.')
        if n < self.i_iter:
            raise ValueError(
                f'you have already run {self.i_iter} iterations, so n_iter '
                'should not be smaller than this number.')
        if n < self.n_warmup:
            raise ValueError(f'n_warmup is {self.n_warmup}, so n_iter should '
                             'not be smaller than this number.')
        self._n_iter = n

    @property
    def i_iter(self):
        return self._i_iter

    @property
    def n_warmup(self):
        return getattr(self, '_n_warmup', 0)

    @n_warmup.setter
    def n_warmup(self, n):
        n = int(n)
        if n <= 0:
            raise ValueError(f'n_warmup should be a positive int, instead of '
                             f'{n}.')
        if n >= self.n_iter:
            raise ValueError(f'n_iter is {self.n_iter}, so n_warmup should '
                             'be smaller than this number.')
        self._n_warmup = n

    def add_iter(self, n):
        self.n_iter = self.n_iter + n

    def add_warmup(self, n):
        self.n_warmup = self.n_warmup + n

    def __getstate__(self):
        # the driver cache holds the density's callables: rebuilt on use
        d = dict(self.__dict__)
        d.pop('_driver_cache', None)
        return d

    def save(self, path):
        """Checkpoint this trace (config, samples and the sampler's
        carry)."""
        from ..utils.checkpoint import save as _save
        _save(self, path)

    @staticmethod
    def load(path):
        """Load a trace saved with ``save``; sampling continues exactly
        where it stopped, on the configured device."""
        from ..utils.checkpoint import load as _load
        return _load(path)

    @property
    def x_0(self):
        return self._x_0

    @x_0.setter
    def x_0(self, x):
        if self._chain_initialized:
            raise RuntimeError('you should not change x_0 once the chain is '
                               'initialized.')
        self._x_0 = None if x is None else np.atleast_1d(np.asarray(x)).copy()

    @property
    def x_0_transformed(self):
        return self._x_0_transformed

    @property
    def input_size(self):
        return None if self.x_0 is None else self.x_0.shape[-1]

    @property
    def random_generator(self):
        if self._random_gen is None:
            return get_generator()
        return self._random_gen

    @random_generator.setter
    def random_generator(self, generator):
        if generator is None or isinstance(generator, torch.Generator):
            self._random_gen = generator
        elif isinstance(generator, (int, np.integer)):
            self._random_gen = generator_from_seed(int(generator))
        else:
            raise ValueError('random_generator should be None, an int or a '
                             'torch.Generator.')


class _HTrace(SampleTrace):
    """Shared config/storage for Hamiltonian traces."""

    _stats_items = hstats_items

    def __init__(self, n_chain=4, n_iter=1500, n_warmup=500, x_0=None,
                 random_generator=None, step_size=None, adapt_step_size=True,
                 metric='diag', adapt_metric=True, max_change=1000.,
                 target_accept=0.8, gamma=0.05, k=0.75, t_0=10.,
                 initial_mean=None, initial_weight=10., adapt_window=60,
                 update_window=1, doubling=True, pooled_metric=False,
                 x_0_descent='auto', step_probe=True):
        super().__init__(n_chain, n_iter, n_warmup, x_0, random_generator)
        # batched gradient-ascent start refinement (core.sample._descend_x0):
        # 'auto' = on for auto-drawn Sobol starts, off for user-supplied x_0;
        # True/False force it; a dict sets n_steps/lr/gain_tol
        self.x_0_descent = x_0_descent
        # per-chain 'find reasonable epsilon' probe before dual averaging
        self.step_probe = bool(step_probe)
        self._descent_calls = 0
        # one metric adapted from all chains' samples (ChainDriver.run)
        self.pooled_metric = bool(pooled_metric)
        self.max_change = max_change
        self.step_size = step_size
        self.adapt_step_size = bool(adapt_step_size)
        self.metric = metric
        self.adapt_metric = bool(adapt_metric)
        self.target_accept = float(target_accept)
        self.gamma = float(gamma)
        self.k = float(k)
        self.t_0 = float(t_0)
        self.initial_mean = initial_mean
        self.initial_weight = float(initial_weight)
        self.adapt_window = int(adapt_window)
        self.update_window = int(update_window)
        self.doubling = bool(doubling)
        self._samples = None            # (n_chain, i_iter, dim), transformed
        self._samples_original = None
        self._logp_original = None
        self._stats_arrays = None       # dict name -> (n_chain, i_iter)
        self._carry = None              # ChainCarry for continuation

    @property
    def max_change(self):
        return self._max_change

    @max_change.setter
    def max_change(self, mc):
        mc = float(mc)
        if mc <= 0:
            raise ValueError('max_change should be a positive float, instead '
                             f'of {mc}.')
        self._max_change = mc

    @property
    def step_size(self):
        return self._step_size

    @step_size.setter
    def step_size(self, s):
        if s is not None:
            s = float(s)
            if s <= 0:
                raise ValueError('invalid value for step_size.')
        self._step_size = s

    @property
    def metric(self):
        return self._metric

    @metric.setter
    def metric(self, m):
        """'diag', 'full', a (D,) diagonal or a (D, D) covariance."""
        if isinstance(m, str):
            if m not in ('diag', 'full'):
                raise ValueError('invalid value for metric.')
        else:
            m = np.asarray(m)
            n = m.shape[0]
            if not (m.shape == (n,) or m.shape == (n, n)):
                raise ValueError('invalid value for metric.')
        self._metric = m

    @property
    def i_iter(self):
        s = getattr(self, '_samples', None)
        return 0 if s is None else s.shape[1]

    @property
    def finished(self):
        return self.i_iter >= self.n_iter

    @property
    def samples(self):
        return (np.empty((self.n_chain, 0, 0)) if self._samples is None
                else self._samples)

    @property
    def samples_original(self):
        return self._samples_original

    @property
    def logp(self):
        return self._stats_arrays['logp']

    @property
    def logp_original(self):
        return self._logp_original

    @property
    def stats(self):
        return StatsView(self._stats_items, self._stats_arrays, self.n_warmup)

    _all_return = ['samples', 'logp']

    def get(self, since_iter=None, include_warmup=False, original_space=True,
            return_type='samples', flatten=True):
        """Extract results; arrays of shape (n_chain, n_kept, ...), or
        flattened over (chain, iteration) when ``flatten``."""
        if return_type == 'all':
            return [self.get(since_iter, include_warmup, original_space, _,
                             flatten) for _ in self._all_return]
        if since_iter is None:
            since_iter = 0 if include_warmup else self.n_warmup
        since_iter = int(since_iter)
        if since_iter >= self.i_iter - 1:
            raise ValueError('since_iter is too large. Nothing to return.')
        if return_type == 'samples':
            s = self._samples_original if original_space else self._samples
            s = s[:, since_iter:]
            return s.reshape((-1, s.shape[-1])) if flatten else s
        elif return_type == 'logp':
            lp = self._logp_original if original_space else self.logp
            lp = lp[:, since_iter:]
            return lp.reshape(-1) if flatten else lp
        else:
            raise ValueError('invalid value for return_type.')

    __call__ = get

    def _append_results(self, samples, stats_arrays):
        """Append a freshly-run block of iterations (host numpy)."""
        if self._samples is None:
            self._samples = samples
            self._stats_arrays = dict(stats_arrays)
        else:
            self._samples = np.concatenate([self._samples, samples], axis=1)
            for k in self._stats_arrays:
                self._stats_arrays[k] = np.concatenate(
                    [self._stats_arrays[k], stats_arrays[k]], axis=1)


class HTrace(_HTrace):
    """Trace for fixed-length HMC."""

    _stats_items = hstats_items

    def __init__(self, n_chain=4, n_iter=1500, n_warmup=500, n_int_step=32,
                 x_0=None, random_generator=None, step_size=1.,
                 adapt_step_size=True, metric='diag', adapt_metric=True,
                 max_change=1000., target_accept=0.8, gamma=0.05, k=0.75,
                 t_0=10., initial_mean=None, initial_weight=10.,
                 adapt_window=60, update_window=1, doubling=True,
                 pooled_metric=False, x_0_descent='auto', step_probe=True):
        super().__init__(n_chain, n_iter, n_warmup, x_0, random_generator,
                         step_size, adapt_step_size, metric, adapt_metric,
                         max_change, target_accept, gamma, k, t_0,
                         initial_mean, initial_weight, adapt_window,
                         update_window, doubling, pooled_metric,
                         x_0_descent, step_probe)
        self.n_int_step = int(n_int_step)

    @property
    def n_call(self):
        """Total density calls across chains: per chain n_iter x
        (n_int_step + 1) + 1, plus the start-up evaluations."""
        return (self.n_chain * (self.n_iter * (self.n_int_step + 1) + 1)
                + self._descent_calls)


class CTrace(_HTrace):
    """Trace for ChEES-HMC: one adaptive trajectory length shared by all
    chains (``samplers/chees.py``); ``target_accept`` defaults to 0.651,
    the harmonic-mean acceptance of the shared step size."""

    _stats_items = cstats_items

    def __init__(self, n_chain=4, n_iter=1500, n_warmup=500, x_0=None,
                 random_generator=None, step_size=1., adapt_step_size=True,
                 metric='diag', adapt_metric=True, max_change=1000.,
                 traj_len_0=1., adapt_traj_len=True, max_leapfrogs=1024,
                 chees_lr=0.025, target_accept=0.651, gamma=0.05, k=0.75,
                 t_0=10., initial_mean=None, initial_weight=10.,
                 adapt_window=60, update_window=1, doubling=True,
                 pooled_metric=False, x_0_descent='auto', step_probe=True):
        super().__init__(n_chain, n_iter, n_warmup, x_0, random_generator,
                         step_size, adapt_step_size, metric, adapt_metric,
                         max_change, target_accept, gamma, k, t_0,
                         initial_mean, initial_weight, adapt_window,
                         update_window, doubling, pooled_metric,
                         x_0_descent, step_probe)
        self.traj_len_0 = float(traj_len_0)
        self.adapt_traj_len = bool(adapt_traj_len)
        self.max_leapfrogs = int(max_leapfrogs)
        self.chees_lr = float(chees_lr)

    @property
    def n_call(self):
        """Total density calls across chains: each iteration's leapfrogs
        per chain, one initial state an iteration, plus the start-up
        evaluations."""
        ns = self._stats_arrays['n_int_step']
        return int(np.sum(ns) + self.n_chain * (self.i_iter + 1)
                   + self._descent_calls)


class NTrace(_HTrace):
    """Trace for NUTS."""

    _stats_items = nstats_items

    def __init__(self, n_chain=4, n_iter=1500, n_warmup=500, x_0=None,
                 random_generator=None, step_size=1., adapt_step_size=True,
                 metric='diag', adapt_metric=True, max_change=1000.,
                 max_treedepth=10, target_accept=0.8, gamma=0.05, k=0.75,
                 t_0=10., initial_mean=None, initial_weight=10.,
                 adapt_window=60, update_window=1, doubling=True,
                 pooled_metric=False, x_0_descent='auto', step_probe=True):
        super().__init__(n_chain, n_iter, n_warmup, x_0, random_generator,
                         step_size, adapt_step_size, metric, adapt_metric,
                         max_change, target_accept, gamma, k, t_0,
                         initial_mean, initial_weight, adapt_window,
                         update_window, doubling, pooled_metric,
                         x_0_descent, step_probe)
        self.max_treedepth = int(max_treedepth)

    @property
    def n_call(self):
        """Total density calls across chains: per chain,
        sum(tree_size[1:]) + n_iter + 1, plus the start-up evaluations."""
        ts = self._stats_arrays['tree_size']
        return int(np.sum(ts[:, 1:]) + self.n_chain * (self.i_iter + 1)
                   + self._descent_calls)


class _TTraceMixin:
    """Tempered-trace accessors: ``u`` and the importance ``weights``."""

    @property
    def u(self):
        return self._stats_arrays['u']

    @property
    def weights(self):
        return self._stats_arrays['weight']

    def get(self, since_iter=None, include_warmup=False, original_space=True,
            return_type='samples', flatten=True):
        if return_type in ('u', 'weights'):
            if since_iter is None:
                since_iter = 0 if include_warmup else self.n_warmup
            arr = (self.u if return_type == 'u' else
                   self.weights)[:, int(since_iter):]
            return arr.reshape(-1) if flatten else arr
        if return_type == 'all':
            return [self.get(since_iter, include_warmup, original_space, _,
                             flatten)
                    for _ in ('samples', 'u', 'weights', 'logp')]
        return super().get(since_iter, include_warmup, original_space,
                           return_type, flatten)


class TNTrace(_TTraceMixin, NTrace):
    """Trace for tempered NUTS; ``density_base`` is the base density and
    ``logxi`` the log-normalizer shift added to its logp."""

    _stats_items = tnstats_items

    def __init__(self, density_base=None, logxi=0., **kwargs):
        super().__init__(**kwargs)
        self.density_base = density_base
        self.logxi = float(logxi)


class THTrace(_TTraceMixin, HTrace):
    """Trace for tempered HMC (see ``TNTrace``)."""

    _stats_items = thstats_items

    def __init__(self, density_base=None, logxi=0., **kwargs):
        super().__init__(**kwargs)
        self.density_base = density_base
        self.logxi = float(logxi)


class ETrace(_HTrace):
    """Trace for the affine-invariant ensemble sampler
    (``samplers/ensemble.py``). ``n_chain`` is the walker count (even, and
    at least 2 x dim for healthy mixing); ``a`` is the stretch
    parameter."""

    _stats_items = estats_items

    def __init__(self, n_chain=64, n_iter=1500, n_warmup=500, x_0=None,
                 random_generator=None, a=2.0):
        SampleTrace.__init__(self, n_chain, n_iter, n_warmup, x_0,
                             random_generator)
        self.a = float(a)
        self._samples = None
        self._samples_original = None
        self._logp_original = None
        self._stats_arrays = None
        self._carry = None

    @property
    def n_call(self):
        return self.n_chain * (self.n_iter + 1)


class ChainTrace:
    """Read-only single-chain view into a batched trace."""

    def __init__(self, parent, i):
        self._parent = parent
        self._i = int(i)

    @property
    def chain_id(self):
        return self._i

    @property
    def samples(self):
        return self._parent._samples[self._i]

    @property
    def samples_original(self):
        return self._parent._samples_original[self._i]

    @property
    def logp(self):
        return self._parent._stats_arrays['logp'][self._i]

    @property
    def logp_original(self):
        return self._parent._logp_original[self._i]

    @property
    def n_iter(self):
        return self._parent.n_iter

    @property
    def n_warmup(self):
        return self._parent.n_warmup

    @property
    def i_iter(self):
        return self._parent.i_iter

    @property
    def input_size(self):
        return self._parent._samples.shape[-1]

    @property
    def stats(self):
        return StatsView(
            self._parent._stats_items,
            {k: v[self._i] for k, v in self._parent._stats_arrays.items()},
            self._parent.n_warmup)

    # ``flatten`` is accepted, and ignored, as in the JAX package: one
    # chain's draws have no chain axis to flatten
    def get(self, since_iter=None, include_warmup=False, original_space=True,
            return_type='samples', flatten=True):
        if since_iter is None:
            since_iter = 0 if include_warmup else self._parent.n_warmup
        since_iter = int(since_iter)
        if return_type == 'samples':
            s = (self.samples_original if original_space else self.samples)
            return s[since_iter:]
        elif return_type == 'logp':
            lp = self.logp_original if original_space else self.logp
            return lp[since_iter:]
        elif return_type == 'all':
            return [self.get(since_iter, include_warmup, original_space, _)
                    for _ in ('samples', 'logp')]
        else:
            raise ValueError('invalid value for return_type.')

    __call__ = get


class TraceTuple:
    """Cross-chain result collection over one batched trace; iteration and
    indexing yield per-chain views."""

    def __init__(self, trace):
        if isinstance(trace, (tuple, list)):
            raise ValueError('traces are batched; construct TraceTuple from '
                             'a single NTrace.')
        self._trace = trace

    @property
    def trace(self):
        return self._trace

    @property
    def sample_traces(self):
        return tuple(ChainTrace(self._trace, i)
                     for i in range(self._trace.n_chain))

    @property
    def sampler(self):
        # subclasses before their bases: TNTrace is an NTrace, THTrace an
        # HTrace
        for cls, name in ((TNTrace, 'TNUTS'), (THTrace, 'THMC'),
                          (ETrace, 'Ensemble'), (CTrace, 'CHEES'),
                          (NTrace, 'NUTS'), (HTrace, 'HMC')):
            if isinstance(self._trace, cls):
                return name
        raise RuntimeError('unexpected trace type.')

    @property
    def n_chain(self):
        return self._trace.n_chain

    @property
    def n_iter(self):
        return self._trace.n_iter

    @n_iter.setter
    def n_iter(self, n):
        self._trace.n_iter = n

    @property
    def i_iter(self):
        return self._trace.i_iter

    @property
    def n_warmup(self):
        return self._trace.n_warmup

    @n_warmup.setter
    def n_warmup(self, n):
        self._trace.n_warmup = n

    @property
    def n_call(self):
        return self._trace.n_call

    @property
    def samples(self):
        return self._trace.samples

    @property
    def samples_original(self):
        return self._trace.samples_original

    @property
    def logp(self):
        return self._trace.logp

    @property
    def logp_original(self):
        return self._trace.logp_original

    @property
    def input_size(self):
        return self._trace.samples.shape[-1]

    @property
    def finished(self):
        return self._trace.finished

    @property
    def stats(self):
        return [t.stats for t in self.sample_traces]

    def get(self, since_iter=None, include_warmup=False, original_space=True,
            return_type='samples', flatten=True):
        return self._trace.get(since_iter, include_warmup, original_space,
                               return_type, flatten)

    __call__ = get

    def __getitem__(self, key):
        return self.sample_traces[key]

    def __len__(self):
        return self._trace.n_chain

    def __iter__(self):
        return iter(self.sample_traces)

    def save(self, path):
        """Checkpoint the trace (see ``SampleTrace.save``)."""
        from ..utils.checkpoint import save as _save
        _save(self, path)

    @staticmethod
    def load(path):
        from ..utils.checkpoint import load as _load
        return _load(path)


def _get_step_size(sample_trace):
    """Warm-start step size from a previous run
    (``bayesfast_tpu/samplers/sample_trace.py:731-741``): the mean
    dual-averaged step size over chains, times ``dim ** 0.25`` (``sample``
    divides the trace's step size by it)."""
    if isinstance(sample_trace, TraceTuple):
        sample_trace = sample_trace.trace
    if isinstance(sample_trace, _HTrace):
        if sample_trace._carry is None:
            raise RuntimeError('trace has not been run yet.')
        dim = sample_trace._samples.shape[-1]
        log_bar = torch.as_tensor(sample_trace._carry.step.log_bar)
        return float(torch.exp(log_bar).double().mean()) * dim ** 0.25
    raise ValueError('invalid value for sample_trace.')


def _get_metric(sample_trace, target, from_samples=True):
    """Warm-start metric from a previous run
    (``bayesfast_tpu/samplers/sample_trace.py:744-769``): the covariance of
    its post-warmup samples in the sampling space, or (``from_samples``
    False) its adapted metric averaged over chains; ``target`` 'diag'
    returns the diagonal, 'full' the matrix."""
    if from_samples:
        if isinstance(sample_trace, (TraceTuple, _HTrace)):
            samples = sample_trace.get(original_space=False, flatten=True)
            cov = np.cov(samples, rowvar=False)
        else:
            raise ValueError('invalid value for sample_trace.')
    else:
        if isinstance(sample_trace, TraceTuple):
            sample_trace = sample_trace.trace
        carry = sample_trace._carry
        if carry is None:
            raise RuntimeError('trace has not been run yet.')
        m = carry.metric
        leaf = m.var if hasattr(m, 'var') else m.cov
        leaf = leaf.double().cpu().numpy()
        pooled = leaf.ndim == (1 if hasattr(m, 'var') else 2)
        mean = leaf if pooled else np.mean(leaf, axis=0)
        cov = np.diag(mean) if hasattr(m, 'var') else mean
    if target == 'diag':
        return np.diag(cov)
    elif target == 'full':
        return cov
    else:
        raise ValueError('unexpected value for target.')
