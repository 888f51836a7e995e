"""Host-side concurrent map for external (non-traceable) likelihoods.

Counterpart of ``bayesfast_tpu/utils/parallel.py``. Everything traceable
runs as batched torch operations on the device; what stays on the host is
the *external* true-model path, where each likelihood call runs a foreign
pipeline (a cosmology code, a simulator) for seconds at a time.
``ParallelBackend`` fans those calls out over a pool:

* ``'threads'`` (default): right when the external model releases the GIL
  (subprocess waits, sockets, BLAS), and the only kind that may touch the
  in-process torch and CUDA state.
* ``'processes'``: right for pure-Python likelihoods that hold the GIL.
  Workers come from a forkserver (spawn available via ``mp_context``), the
  mapped callable and its arguments must be picklable (module-level
  functions, numpy arrays), and worker code must not touch CUDA: the
  pipeline's external dispatch ships only the raw user callable plus
  prepared numpy inputs, so no worker does. A process has one forkserver,
  and the code that starts it fixes what its workers preload; when other
  code (the JAX package's pool, which preloads jax) started it first, this
  module's pools use ``'spawn'`` instead and say so in a warning.

``set_backend(n)`` fixes the worker count; ``set_backend((n, 'processes'))``
or ``set_backend(ParallelBackend(n, kind='processes'))`` selects the
process pool. ``set_backend(ParallelBackend(serial=True))`` restores a
plain serial map for debugging. Any ``concurrent.futures`` executor (or an
object with ``submit`` and ``map``: dask's ``ClientExecutor``, an MPI pool)
can also be passed and is used as-is (not shut down on exit).
"""

import atexit
import multiprocessing
import os
import warnings
from concurrent.futures import (Executor, ProcessPoolExecutor,
                                ThreadPoolExecutor)

__all__ = ['ParallelBackend', 'get_backend', 'set_backend']


# Process pools are cached for the life of the interpreter: forkserver
# workers pay a module-import bootstrap on creation (fork workers don't,
# but forking a parent whose CUDA context is live is unsafe),
# so transient per-map process pools would dominate short external-model
# batches. Keyed by (start method, width); shut down at exit.
_proc_pools = {}


def _shutdown_proc_pools():
    for pool in _proc_pools.values():
        pool.shutdown(wait=False, cancel_futures=True)
    _proc_pools.clear()


atexit.register(_shutdown_proc_pools)


# What the forkserver's template imports, so that workers skip the imports
# they would otherwise pay unpickling user callables. Importing torch and
# this package initializes no CUDA context, and the template is started
# fresh rather than forked from this process, so its forks hold no CUDA
# state. A module the template cannot import is skipped by multiprocessing
# itself.
_PRELOAD = ['numpy', 'torch', 'bayesfast_tpu_torch']
# pid of the forkserver that this module started with _PRELOAD
_own_server = None


def _foreign_forkserver():
    """The preload list of this process's forkserver when it runs and was
    started by other code with another list, else None. The server's
    preloads are fixed when it starts; ``set_forkserver_preload`` after
    that changes only the list that a restart would read."""
    from multiprocessing import forkserver
    fs = forkserver._forkserver
    if fs._forkserver_pid is None or fs._forkserver_pid == _own_server:
        return None
    preload = list(fs._preload_modules)
    return None if preload == _PRELOAD else preload


def _shared_proc_pool(mp_context, width):
    global _own_server
    key = (mp_context, width)
    pool = _proc_pools.get(key)
    if pool is not None and not getattr(pool, '_broken', False):
        return pool
    if mp_context == 'forkserver':
        foreign = _foreign_forkserver()
        if foreign is not None:
            warnings.warn(
                "this process's forkserver was started by other code with "
                f'preloads {foreign}, which its workers would carry; the '
                "process pool uses 'spawn' instead.", RuntimeWarning,
                stacklevel=3)
            mp_context = 'spawn'
        else:
            from multiprocessing import forkserver
            forkserver.set_forkserver_preload(_PRELOAD)
            forkserver.ensure_running()
            _own_server = forkserver._forkserver._forkserver_pid
    pool = ProcessPoolExecutor(width,
                               mp_context=multiprocessing.get_context(
                                   mp_context))
    _proc_pools[key] = pool
    return pool


def _is_executor(x):
    """True for concurrent.futures.Executor subclasses AND duck-typed
    executors (dask ClientExecutor, ray adapters): submit() + map()."""
    return (isinstance(x, Executor)
            or (not isinstance(x, (int, ParallelBackend, tuple,
                                   type(None)))
                and hasattr(x, 'submit') and hasattr(x, 'map')))


def _auto_workers(n_items, processes=False):
    """Pool size for the default backend: enough workers to overlap every
    pending external call, capped so pathological batch sizes don't spawn
    thousands of them. Process pools additionally cap at the core count —
    GIL-bound work gains nothing beyond it."""
    n_cpu = os.cpu_count() or 1
    cap = n_cpu if processes else max(32, 4 * n_cpu)
    return max(1, min(n_items, cap))


class ParallelBackend:
    """Concurrent host map for external true models.

    Parameters
    ----------
    backend : None, int, Executor or ParallelBackend, optional
        ``None`` (default) uses a transient pool sized to each map call.
        An int pins the pool width. An ``Executor`` is used directly.
    serial : bool, optional
        Force a plain in-order Python map (useful under pdb or when the
        external model is not thread-safe).
    kind : {'threads', 'processes'}, optional
        Pool flavor; defaults to threads. Ignored when an explicit
        ``Executor`` or ``serial=True`` is given.
    mp_context : str, optional
        Multiprocessing start method for ``kind='processes'``; default
        ``'forkserver'``: a CUDA context does not survive a fork (a child
        of a process that has used the GPU fails at its first CUDA call),
        whereas the forkserver's template process has never touched CUDA,
        so its forks are safe and still cheap. Pass ``'fork'`` to inherit
        the parent's imports (only safe before any device use) or
        ``'spawn'`` for maximum isolation.
    """

    def __init__(self, backend=None, serial=False, kind=None,
                 mp_context='forkserver'):
        if isinstance(backend, ParallelBackend):
            serial = serial or backend._serial
            kind = kind or backend._kind
            mp_context = backend._mp_context
            backend = backend._spec
        elif isinstance(backend, tuple) and len(backend) == 2:
            backend, kind = backend
        if not (backend is None or isinstance(backend, int)
                or _is_executor(backend)):
            raise ValueError('backend should be None, an int worker count, '
                             'an Executor (or any object with submit/map), '
                             'or another ParallelBackend.')
        if isinstance(backend, int) and backend <= 0:
            raise ValueError('worker count should be positive.')
        if kind not in (None, 'threads', 'processes'):
            raise ValueError("kind should be 'threads' or 'processes'.")
        self._spec = backend
        self._serial = bool(serial)
        self._kind = kind or 'threads'
        self._mp_context = mp_context

    @property
    def kind(self):
        if self._serial:
            return 'serial'
        if _is_executor(self._spec):
            return 'executor'
        return self._kind

    @property
    def backend(self):
        return self._spec

    def _make_pool(self, width):
        if self._kind == 'processes':
            return _shared_proc_pool(self._mp_context, width)
        return ThreadPoolExecutor(width)

    def _pool_for(self, n_items):
        """(executor, owns_it) for a map over ``n_items`` elements."""
        if self._serial or n_items <= 1:
            return None, False
        if _is_executor(self._spec):
            return self._spec, False
        width = self._spec if isinstance(self._spec, int) else \
            _auto_workers(n_items, self._kind == 'processes')
        # shared (cached) process pools are never owned by one map call
        return self._make_pool(width), self._kind != 'processes'

    def map(self, fun, *iters):
        jobs = list(zip(*iters))
        pool, owns = self._pool_for(len(jobs))
        if pool is None:
            return [fun(*args) for args in jobs]
        try:
            if self.kind in ('processes', 'executor') or isinstance(
                    pool, ProcessPoolExecutor):
                # process pools and injected (possibly remote) executors
                # need a picklable top-level callable — the lambda wrapper
                # used for threads would fail to pickle
                return list(pool.map(fun, *zip(*jobs)))
            return list(pool.map(lambda args: fun(*args), jobs))
        finally:
            if owns:
                pool.shutdown()

    def map_async(self, fun, *iters):
        """Submit ``fun`` over the zipped ``iters`` and return at once: a
        list of futures (for a serial map, or one item, the results
        themselves), which ``gather`` turns into the results. A pool that
        this call makes lives until ``gather``."""
        jobs = list(zip(*iters))
        pool, owns = self._pool_for(len(jobs))
        if pool is None:
            return [fun(*args) for args in jobs]
        futures = [pool.submit(fun, *args) for args in jobs]
        if owns:
            # a transient pool: kept until the futures are gathered
            futures = _OwnedFutures(futures, pool)
        return futures

    def gather(self, async_result):
        """The results of ``map_async``, in order; shuts down the pool that
        ``map_async`` made for them."""
        if isinstance(async_result, _OwnedFutures):
            try:
                return [f.result() for f in async_result]
            finally:
                async_result.pool.shutdown()
        if async_result and hasattr(async_result[0], 'result'):
            return [f.result() for f in async_result]
        return async_result


class _OwnedFutures(list):
    """Futures plus the transient pool that must outlive them."""

    def __init__(self, futures, pool):
        super().__init__(futures)
        self.pool = pool


_backend = ParallelBackend()


def get_backend():
    return _backend


def set_backend(backend):
    """Replace the global backend: int = fixed thread count, None = auto,
    ``(n, 'processes')`` = fixed process-pool width, or a configured
    ``ParallelBackend``."""
    global _backend
    _backend = ParallelBackend(backend)
