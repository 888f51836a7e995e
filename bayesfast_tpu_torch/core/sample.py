"""The parallel-sampling entry point, for every sampler.

Counterpart of ``bayesfast_tpu/core/sample.py``. All chains advance
together on one device. Before the chains of a gradient sampler start:
Sobol start points, a batched Adam ascent of the starts (``_descend_x0``)
and a per-chain reasonable-step probe (``_find_reasonable_step``). Then,
as the JAX package dispatches (``core/sample.py:465-602``):

* NUTS with a diag metric on the kernels, adapted per chain: warmup in
  chunks of at most 64 transitions, each one launch of the warmup chunk
  kernel;
* NUTS with a pooled diag metric: warmup on the per-transition path
  (``ChainDriver.run``), one block-kernel launch per transition with the
  shared Welford update between launches;
* either diag case after warmup: frozen chunks, one launch each;
* NUTS with a full metric, a density without ``kernel_spec()`` or D >
  256 (a ``Density`` plan past 64), and every HMC, THMC, TNUTS and ChEES
  transition: the per-transition path in plain torch on the device (NUTS
  and TNUTS on the tree loop), as the JAX package runs them in XLA.
  ``ChainDriver.uses_kernels`` routes: under ``nuts_kernel='auto'`` a
  ``DensityLite`` whose logp does not trace into the kernels' op set warns
  once (the op named) and takes the tree loop, as the JAX package warns
  and falls back when its kernel does not lower; under ``'cuda'`` such a
  density, or D > 256, raises ``NotImplementedError`` before any device
  work;
* the ensemble: ``_run_ensemble``, gradient-free stretch moves.

Before any device work ``sample`` refuses a gradient sampler on an
external logp (``DensityLite(traceable=False)``) without a gradient of its
own, as the JAX package cannot differentiate its host callback, and under
``'cuda'`` a diag-metric NUTS run that the kernels cannot take
(``_refusal``). A ``DensityLite`` with the user's gradient runs it
everywhere: in the start-up, on the tree loop and, traced, in the kernels.

A ``DensityLite`` over a compiled-in density (``ops.densities``) or over
any torch logp that traces (``ops/trace.py``) has a kernel spec; the
traced one runs the kernels compiled with its generated functor
(``ops/codegen.py``). A ``Density`` (a module pipeline) has a kernel spec
when its active plan is
the Recipe's surrogate, a ``PolyModel`` and a ``Gaussian``
(``Density.kernel_spec``); the kernels then read its coefficients as they
stand at each launch, so a refit between calls is seen.

The JAX package's mesh paths are not part of this module.
"""

import time
import warnings

import numpy as np
import torch

from ..config import get_device, get_dtype, get_nuts_kernel
from ..samplers.chain import ChainCarry, ChainDriver
from ..samplers.chees import CheesAdaptState, init_chees_adapt
from ..samplers.ensemble import run_ensemble
from ..samplers.metrics import (init_diag_metric, init_full_metric,
                                sample_momentum_b)
from ..samplers.sample_trace import (SampleTrace, NTrace, HTrace, TNTrace,
                                     THTrace, CTrace, ETrace, TraceTuple)
from ..samplers.step_size import init_step_size, check_acceptance
from ..samplers import nuts as _nuts
from ..samplers import nuts_cuda
from ..utils.random import generator_from_seed
from ..utils.sobol import multivariate_normal
from .density import DensityLite
from .pipeline import Density

__all__ = ['sample']


def _trace_stream(trace, salt):
    """An independent numpy ``SeedSequence`` for one use (``salt``) of the
    trace's randomness; the root is drawn once from the trace's generator
    (the counterpart of the JAX package's ``fold_in`` of the trace key)."""
    root = getattr(trace, '_seed_root', None)
    if root is None:
        root = int(torch.randint(0, 2 ** 62, (),
                                 generator=trace.random_generator))
        trace._seed_root = root
    return np.random.SeedSequence([root, int(salt)])


def _descend_x0(density, x_0, trace, dtype, device=None):
    """Batched Adam ascent of the starting points on the transformed logp;
    each chain freezes once its per-step gain drops below ``gain_tol``.
    Returns ``(x_opt, n_evals)``, ``n_evals`` the per-chain count of density
    evaluations (for exact n_call accounting)."""
    opts = trace.x_0_descent
    opts = dict(opts) if isinstance(opts, dict) else {}
    n_steps = int(opts.get('n_steps', 5000))
    lr = float(opts.get('lr', 0.3))
    gain_tol = float(opts.get('gain_tol', 0.1))
    b1, b2, eps_adam = 0.9, 0.999, 1e-8
    device = device or get_device()

    lpg = density.device_logp_and_grad(original_space=False)
    params = density.current_params()
    x = torch.as_tensor(np.asarray(x_0), dtype=dtype, device=device)
    lp, g = lpg(params, x)
    frozen = ~torch.isfinite(lp)
    m = torch.zeros_like(x)
    v = torch.zeros_like(x)
    scale = torch.ones(x.shape[0], dtype=dtype, device=device)
    t = 0
    while t < n_steps and not bool(frozen.all()):
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g * g
        tt = float(t + 1)
        m_hat = m_new / (1 - b1 ** tt)
        v_hat = v_new / (1 - b2 ** tt)
        x_prop = x + (lr * scale)[:, None] * m_hat / (
            torch.sqrt(v_hat) + eps_adam)
        lp_new, g_new = lpg(params, x_prop)
        gain = lp_new - lp
        # per-chain backtracking: a finite, improving step advances the
        # state and relaxes the rate; an overshooting or non-finite one is
        # rejected, halves the rate and drops the stale momentum
        good = ~frozen & torch.isfinite(lp_new) & (gain > 0)
        bad = ~frozen & ~good
        x = torch.where(good[:, None], x_prop, x)
        g = torch.where(good[:, None], g_new, g)
        lp = torch.where(good, lp_new, lp)
        m = torch.where(bad[:, None], torch.zeros_like(m_new), m_new)
        v = torch.where(bad[:, None], v, v_new)
        scale = torch.where(bad, scale * 0.5,
                            torch.clamp(scale * 1.25, max=1.0))
        frozen = frozen | (good & (gain < gain_tol)) | (scale < 1e-6)
        t += 1
    return x.cpu().numpy(), t + 1


def _find_reasonable_step(density, x_0, trace, dtype, step0, device=None,
                          p0=None):
    """Per-chain 'find reasonable epsilon' probe (Stan's initialization):
    one leapfrog per chain measures the single-step acceptance; the step
    doubles (acceptance > 0.5) or halves until it crosses 0.5, per chain in
    lockstep. ``p0`` (C, D) overrides the momenta, which are otherwise drawn
    from the trace's generator. Returns ``(eps, n_evals)``."""
    dim = x_0.shape[-1]
    device = device or get_device()
    x = torch.as_tensor(np.asarray(x_0), dtype=dtype, device=device)
    C = x.shape[0]
    mstate = _init_metric(trace, torch.zeros(dim, dtype=dtype,
                                             device=device))
    metric_t = _nuts._metric_t(mstate)
    lpg = density.device_logp_and_grad(original_space=False)
    params = density.current_params()

    def lpg_t(xx):
        return lpg(params, xx)

    if p0 is None:
        p0 = sample_momentum_b(
            mstate, generator_from_seed(_trace_stream(trace, 0xf1d)),
            (C, dim), dtype)
    p0 = torch.as_tensor(p0, dtype=dtype, device=device)
    s0 = _nuts.compute_state_t(metric_t, lpg_t, x, p0)
    n_steps = 60  # eps spans 2^60 at most

    def accept_of(eps):
        s1 = _nuts.leapfrog_t(metric_t, lpg_t, eps, s0)
        d_energy = s1.energy - s0.energy
        return torch.where(torch.isfinite(d_energy),
                           torch.exp(-torch.clamp(d_energy, max=80.0)),
                           torch.zeros_like(d_energy))

    eps = torch.full((C,), float(step0), dtype=dtype, device=device)
    a = accept_of(eps)
    d = torch.where(a > 0.5, 1.0, -1.0).to(dtype)
    frozen = torch.zeros(C, dtype=torch.bool, device=device)
    t = 0
    while t < n_steps and not bool(frozen.all()):
        eps_new = torch.where(frozen, eps, eps * torch.exp2(d))
        a_new = accept_of(eps_new)
        crossed = torch.where(d > 0, a_new <= 0.5, a_new > 0.5)
        # a downward search keeps the first acceptable step; an upward one
        # keeps the overshooting step (Stan does), dual averaging corrects
        eps = torch.where(frozen, eps, eps_new)
        frozen = frozen | crossed
        t += 1
    return eps.cpu().numpy(), t + 2  # init state + first probe


_TRACES = {'NUTS': NTrace, 'HMC': HTrace, 'TNUTS': TNTrace, 'THMC': THTrace,
           'Ensemble': ETrace, 'CHEES': CTrace}

_ALGOS = {'NUTS': 'nuts', 'HMC': 'hmc', 'TNUTS': 'tnuts', 'THMC': 'thmc',
          'CHEES': 'chees'}


def _resolve_trace(sample_trace, sampler):
    """``(trace, sampler name)``: a trace's own type names its sampler; a
    dict (or None) configures a new trace of ``sampler``'s type."""
    if isinstance(sample_trace, TraceTuple):
        return sample_trace.trace, sample_trace.sampler
    if isinstance(sample_trace, SampleTrace):
        return sample_trace, TraceTuple(sample_trace).sampler
    if sample_trace is None or isinstance(sample_trace, dict):
        cls = _TRACES.get(sampler)
        if cls is None:
            raise ValueError('unexpected value for sampler.')
        return cls(**(sample_trace or {})), sampler
    raise ValueError('unexpected value for sample_trace.')


def _init_metric(trace, mean, initial_weight=10., adapt_window=60):
    """The trace's initial metric state around ``mean`` (D,) or (C, D):
    diag for 'diag' or a 1-D array, full for 'full' or a 2-D array."""
    metric = trace.metric
    dim = mean.shape[-1]
    if isinstance(metric, str):
        metric = np.ones(dim) if metric == 'diag' else np.eye(dim)
    metric = torch.as_tensor(np.asarray(metric), dtype=mean.dtype,
                             device=mean.device)
    init = init_diag_metric if metric.dim() == 1 else init_full_metric
    return init(mean, metric, initial_weight, adapt_window)


def _init_carry(trace, x_0, dtype, eps_0=None, device=None, algo='nuts'):
    """Build the batched carry: one int32 seed, q, the step-size state and
    the metric state (per chain, or one shared state from the mean of the
    starts when ``pooled_metric``). The tempered algorithms extend q to
    ``[u, q]`` with ``u ~ N(0, 1)`` per chain; ChEES keeps one shared
    adaptation state, its step the geometric mean of the probe's steps.
    The metric and the step size stay q-space."""
    device = device or get_device()
    n_chain = trace.n_chain
    dim = x_0.shape[-1]
    ss = _trace_stream(trace, 0x5b)
    seed = int(ss.generate_state(1, np.uint32)[0]) % (2 ** 31 - 1)
    q = torch.as_tensor(np.asarray(x_0), dtype=dtype, device=device)
    if algo in ('thmc', 'tnuts'):
        gen = generator_from_seed(_trace_stream(trace, 0x7e))
        u0 = torch.randn((n_chain, 1), dtype=dtype, generator=gen)
        q = torch.cat([u0.to(device), q], dim=1)

    step0 = trace.step_size if trace.step_size is not None else 1.0
    step0 = step0 / dim ** 0.25
    if algo == 'chees':
        if eps_0 is not None:
            step0 = float(np.exp(np.mean(np.log(eps_0))))
        step = init_chees_adapt(step0, trace.traj_len_0, dtype, device)
    else:
        if eps_0 is None:
            eps_0 = np.full(n_chain, step0)
        step = init_step_size(torch.as_tensor(np.asarray(eps_0),
                                              dtype=dtype), dtype, device)

    init_mean = (np.asarray(x_0) if trace.initial_mean is None
                 else np.broadcast_to(trace.initial_mean, (n_chain, dim)))
    if trace.pooled_metric:
        init_mean = np.mean(init_mean, axis=0)
    ms = _init_metric(
        trace, torch.as_tensor(np.asarray(init_mean), dtype=dtype,
                               device=device),
        trace.initial_weight, trace.adapt_window)
    return ChainCarry(seed, q, step, ms)


def _to_device(obj, device):
    """``obj`` (a carry: tensors inside tuples and named tuples) with every
    tensor moved to ``device``."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if isinstance(obj, tuple):
        items = [_to_device(o, device) for o in obj]
        return type(obj)(*items) if hasattr(obj, '_fields') else tuple(items)
    return obj


def _to_host(samples, stats, extras):
    """One chunk to host numpy: samples (C, K, D), stats (C, K)."""
    samples = samples.cpu().numpy()
    stats_np = {k: v.cpu().numpy().T for k, v in stats._asdict().items()}
    if extras is not None:
        stats_np.update({k: v.cpu().numpy().T for k, v in extras.items()})
    return np.swapaxes(samples, 0, 1), stats_np


def _append(density, trace, all_samples, all_stats):
    """Append one ``sample()`` call's chunks to the trace and back-transform
    them to the original space, incrementally: only this call's new samples
    run through the transform. Returns the call's stat arrays."""
    samples = np.concatenate(all_samples, axis=1)
    stats_arrays = {k: np.concatenate([s[k] for s in all_stats], axis=1)
                    for k in all_stats[0]}
    trace._append_results(samples, stats_arrays)
    prev_s = trace._samples_original
    prev_l = trace._logp_original
    new_s = np.asarray(density.to_original(samples))
    new_logp = stats_arrays['logp']
    new_l = np.asarray(density.to_original_density(
        new_logp.reshape(-1), x_trans=samples.reshape(
            (-1, samples.shape[-1])))).reshape(new_logp.shape)
    if (prev_s is not None and
            prev_s.shape[1] + samples.shape[1] == trace._samples.shape[1]):
        trace._samples_original = np.concatenate([prev_s, new_s], axis=1)
        trace._logp_original = np.concatenate([prev_l, new_l], axis=1)
    else:
        trace._samples_original = new_s
        trace._logp_original = new_l
    return stats_arrays


def _run_ensemble(density, trace, x_0, n_run, i_iter, verbose, n_update,
                  dtype, device):
    """The stretch-move ensemble path (no gradients). The carry is
    ``(seed, walkers, their logp)``; iteration ``i`` draws from a generator
    keyed by ``(seed, i)``, so neither ``n_update`` nor a resume changes the
    stream."""
    if trace.n_chain % 2:
        raise ValueError('the ensemble sampler needs an even n_chain.')
    logp_fn = density.device_logp(original_space=False)
    if trace._carry is not None:
        seed, x, lp = _to_device(trace._carry, device)
    else:
        ss = _trace_stream(trace, 0xe5)
        seed = int(ss.generate_state(1, np.uint32)[0]) % (2 ** 31 - 1)
        x = torch.as_tensor(np.asarray(x_0), dtype=dtype, device=device)
        with torch.no_grad():
            lp = logp_fn(x)
        trace._chain_initialized = True

    n_update = max(n_run // 5 if n_update is None else int(n_update), 1)
    all_samples, all_stats = [], []
    t_start = time.time()
    done = 0
    while done < n_run:
        n_step = min(n_update, n_run - done)
        it0 = i_iter + done
        flags = (it0 + np.arange(n_step)) < trace.n_warmup
        with torch.no_grad():
            x, lp, samples, stats = run_ensemble(seed, x, lp, logp_fn, flags,
                                                 trace.a, i0=it0)
        samples, stats_np = _to_host(samples, stats, None)
        all_samples.append(samples)
        all_stats.append(stats_np)
        done += n_step
        if verbose:
            print(f' WALKERS [0-{trace.n_chain - 1}] : ensemble proceeding '
                  f'[ {i_iter + done} / {trace.n_iter} ].')
    _append(density, trace, all_samples, all_stats)
    trace._carry = (seed, x, lp)
    if verbose:
        print(f' WALKERS [0-{trace.n_chain - 1}] : ensemble finished '
              f'[ {trace.i_iter} / {trace.n_iter} ] in '
              f'{time.time() - t_start:.2f} seconds.')
    return TraceTuple(trace)


def _shifted(density, logxi):
    """A base density's ``(C, D) -> (logp + logxi, grad)`` in the sampling
    space, in the fewest launches (``nuts_cuda.plain_lpg``)."""
    lpg = nuts_cuda.plain_lpg(density, ordered=False)

    def fn(x):
        lp, g = lpg(x)
        return lp + logxi, g
    return fn


def _refusal(density, trace, sampler, dim, dtype):
    """What ``sample`` refuses before any device work: a gradient sampler
    on an external logp without a gradient of its own (as the JAX package
    cannot differentiate its host callback), and under
    ``nuts_kernel='cuda'`` a NUTS run with a diag metric that the kernels
    cannot take (``nuts_cuda.kernel_refusal``)."""
    if sampler == 'Ensemble':
        return None
    no_grad = getattr(density, '_no_gradient', lambda: None)()
    if no_grad is not None:
        return no_grad
    if sampler != 'NUTS' or get_nuts_kernel() != 'cuda':
        return None
    m = trace.metric
    if m == 'diag' if isinstance(m, str) else np.ndim(m) == 1:
        why = nuts_cuda.kernel_refusal(density, dim, dtype)
        if why is not None:
            return NotImplementedError(
                f"nuts_kernel='cuda': {why}; sample it on the tree loop "
                "(nuts_kernel='auto' or 'torch').")
    return None


def sample(density, sample_trace=None, sampler='NUTS', n_run=None,
           parallel_backend=None, verbose=True, n_update=None):
    """Sample a probability density; returns a ``TraceTuple``.

    ``sampler`` is 'NUTS', 'HMC', 'TNUTS', 'THMC', 'CHEES' or 'Ensemble'
    when ``sample_trace`` is a dict (or None); a trace's own type names
    its sampler. Runs on the device of ``config.get_device()`` in the dtype
    of ``config.get_dtype()``; ``config.get_nuts_kernel()`` picks NUTS's
    chunk kernels ('auto': CUDA kernels for CUDA tensors, plain torch on
    the CPU). A trace that has run (or was loaded with ``load``) continues
    from its carry, moved to the configured device. ``parallel_backend``
    is accepted and ignored, as in the JAX package (the chains run as one
    batch on the device; an external logp maps its rows over
    ``utils.parallel.get_backend()``).
    """
    if not isinstance(density, (Density, DensityLite)):
        raise ValueError('density should be a Density or DensityLite.')

    trace, sampler = _resolve_trace(sample_trace, sampler)
    dtype = get_dtype()
    device = get_device()
    dim = (density.input_size if trace.x_0 is None
           else np.shape(trace.x_0)[-1])
    if dim is not None:
        err = _refusal(density, trace, sampler, int(dim), dtype)
        if err is not None:
            raise err

    # ------- starting points -------
    x_0_auto = trace.x_0 is None
    if trace.x_0 is None:
        dim = density.input_size
        if dim is None:
            raise RuntimeError('Neither SampleTrace.x_0 nor '
                               'Density/DensityLite.input_size is '
                               'defined.')
        trace._x_0 = multivariate_normal(
            np.zeros(dim), np.eye(dim), trace.n_chain)
        trace._x_0_transformed = True
    elif not trace.x_0_transformed:
        trace._x_0 = np.asarray(density.from_original(trace._x_0))
        trace._x_0_transformed = True
    x_0 = np.atleast_2d(trace._x_0)
    if x_0.shape[0] == trace.n_chain:
        pass
    elif x_0.shape[0] == 1:
        x_0 = np.broadcast_to(x_0, (trace.n_chain, x_0.shape[-1]))
    else:
        # pick one random row per chain
        rng = np.random.default_rng(_trace_stream(trace, 0x517))
        x_0 = x_0[rng.integers(0, x_0.shape[0], trace.n_chain)]

    # ------- start refinement (fresh gradient-sampler runs only) -------
    descent = getattr(trace, 'x_0_descent', False)
    if descent == 'auto':
        descent = x_0_auto
    if (descent and trace._carry is None and not trace.chain_initialized
            and sampler != 'Ensemble'):
        x_0, n_evals = _descend_x0(density, x_0, trace, dtype, device)
        trace._descent_calls = trace.n_chain * n_evals

    # ------- iteration bookkeeping -------
    i_iter = trace.i_iter
    if n_run is None:
        n_run = trace.n_iter - i_iter
    else:
        n_run = int(n_run)
        if n_run <= 0:
            raise ValueError('invalid value for n_run.')
        if n_run > trace.n_iter - i_iter:
            trace.n_iter = i_iter + n_run
    if n_run == 0:
        return TraceTuple(trace)

    # ------- the finite check of a fresh start -------
    if trace._carry is None:
        if sampler == 'Ensemble':  # gradient-free: logp only
            if not np.isfinite(density.logp(x_0, original_space=False)).all():
                raise ValueError('failed to get finite logp at x_0.')
        else:
            lpg = density.device_logp_and_grad(original_space=False)
            lp0, g0 = lpg((), torch.as_tensor(np.asarray(x_0), dtype=dtype,
                                              device=device))
            if not (bool(torch.isfinite(lp0).all())
                    and bool(torch.isfinite(g0).all())):
                raise ValueError('failed to get finite logp and/or grad at '
                                 'x_0.')

    if sampler == 'Ensemble':
        return _run_ensemble(density, trace, x_0, n_run, i_iter, verbose,
                             n_update, dtype, device)

    # ------- driver + carry -------
    algo = _ALGOS[sampler]
    tempered = algo in ('tnuts', 'thmc')
    base = lpg_base = None
    if tempered:
        base = trace.density_base
        if base is None:
            raise ValueError('tempered samplers need trace.density_base.')
        lpg_base = _shifted(base, trace.logxi)
    kernel_mode = get_nuts_kernel()
    cached = getattr(trace, '_driver_cache', None)
    m = trace.metric
    metric_kind = m if isinstance(m, str) else ('diag' if m.ndim == 1
                                                else 'full')
    cache_key = (id(density), algo, id(base), kernel_mode, metric_kind,
                 trace.pooled_metric)
    if cached is not None and cached[0] == cache_key:
        driver = cached[1]
    else:
        driver = ChainDriver(
            density, algorithm=algo,
            max_treedepth=getattr(trace, 'max_treedepth', 10),
            n_int_step=getattr(trace, 'n_int_step', 32),
            max_change=trace.max_change, target_accept=trace.target_accept,
            gamma=trace.gamma, k=trace.k, t_0=trace.t_0,
            adapt_step_size=trace.adapt_step_size,
            update_window=trace.update_window, doubling=trace.doubling,
            adapt_metric=trace.adapt_metric, logp_and_grad_base=lpg_base,
            pooled_metric=trace.pooled_metric,
            max_leapfrogs=getattr(trace, 'max_leapfrogs', 1024),
            adapt_traj_len=getattr(trace, 'adapt_traj_len', True),
            chees_lr=getattr(trace, 'chees_lr', 0.025),
            nuts_kernel=kernel_mode)
        trace._driver_cache = (cache_key, driver)

    if trace._carry is not None:
        carry = _to_device(trace._carry, device)
    else:
        eps_0 = None
        if trace.step_probe:
            step0 = trace.step_size if trace.step_size is not None else 1.0
            step0 = step0 / x_0.shape[-1] ** 0.25
            eps_0, n_ev = _find_reasonable_step(density, x_0, trace, dtype,
                                                step0, device)
            trace._descent_calls += trace.n_chain * n_ev
        carry = _init_carry(trace, x_0, dtype, eps_0, device, algo)
        trace._chain_initialized = True

    # ------- chunked run with progress reporting -------
    if n_update is None:
        n_update = max(n_run // 5, 1)
    else:
        n_update = max(int(n_update), 1)

    all_samples, all_stats = [], []
    frozen_extras = None
    warm_ints = None
    t_start = time.time()
    done = 0
    while done < n_run:
        n_step = min(n_update, n_run - done)
        it0 = i_iter + done
        # never let a chunk straddle the warmup boundary: warmup chunks
        # adapt, post-warmup chunks are frozen
        if it0 < trace.n_warmup < it0 + n_step:
            n_step = trace.n_warmup - it0
        warm = it0 < trace.n_warmup
        kernels = driver.uses_kernels(carry.metric)
        t_i = time.time()
        if warm and kernels and not trace.pooled_metric:
            carry, (samples, (stats, extras)), warm_ints = \
                driver.run_warmup_chunk(carry, n_step, i0=it0,
                                        win_ints=warm_ints)
            samples, stats_np = _to_host(samples, stats, extras)
        elif not kernels or warm:
            carry, (samples, (stats, extras)) = driver.run(
                carry, [warm] * n_step, i0=it0)
            samples, stats_np = _to_host(samples, stats, extras)
        else:
            carry, (samples, (stats, _)) = driver.run_frozen_chunk(
                carry, n_step, i0=it0)
            samples, stats_np = _to_host(samples, stats, None)
            # step sizes are constant post-warmup: rebuild the rows on host
            if frozen_extras is None:
                frozen_extras = (
                    torch.exp(carry.step.log_step).cpu().numpy(),
                    torch.exp(carry.step.log_bar).cpu().numpy())
            n_c = stats_np['logp'].shape[0]
            stats_np['step_size'] = np.broadcast_to(
                frozen_extras[0][:, None], (n_c, n_step)).copy()
            stats_np['step_size_bar'] = np.broadcast_to(
                frozen_extras[1][:, None], (n_c, n_step)).copy()
            stats_np['warmup'] = np.zeros((n_c, n_step), bool)
        if tempered:
            samples = samples[..., 1:]  # strip the temperature coordinate
        all_samples.append(samples)
        all_stats.append(stats_np)
        done += n_step
        if verbose:
            t_d = time.time() - t_i
            n_div = int(stats_np['diverging'].sum())
            msg = (f' CHAINS [0-{trace.n_chain - 1}] : sampling proceeding '
                   f'[ {i_iter + done} / {trace.n_iter} ], last {n_step} '
                   f'samples used {t_d:.2f} seconds')
            msg += (f', while divergence encountered in {n_div} sample(s).'
                    if n_div / (n_step * trace.n_chain) > 0.05 else '.')
            if (i_iter + done) <= trace.n_warmup:
                msg += ' (warmup)'
            print(msg)

    stats_arrays = _append(density, trace, all_samples, all_stats)
    trace._carry = carry

    if verbose:
        t_f = time.time() - t_start
        print(f' CHAINS [0-{trace.n_chain - 1}] : sampling finished '
              f'[ {trace.i_iter} / {trace.n_iter} ], obtained {n_run} '
              f'samples per chain in {t_f:.2f} seconds.')

    post_div = stats_arrays['diverging'][:, trace.n_warmup:]
    if post_div.size:
        frac = float(np.mean(post_div))
        if frac > 0.05:
            warnings.warn(
                f'{frac:.1%} of post-warmup transitions diverged: the '
                'posterior has geometry the adapted step size cannot '
                'integrate (results may be biased toward the bulk). '
                'Consider a higher target_accept, a reparametrization, '
                'or float64.', RuntimeWarning)

    if 'tree_depth' in stats_arrays:
        post = stats_arrays['tree_depth'][:, trace.n_warmup:]
        if post.size and np.mean(post >= trace.max_treedepth) > 0.5:
            warnings.warn(
                'more than half of the post-warmup NUTS trees hit '
                f'max_treedepth={trace.max_treedepth}: the adapted step size '
                'is too small for full trajectories (common for very stiff '
                'targets in float32). Consider raising max_treedepth, '
                'running in float64, or reparametrizing.', RuntimeWarning)

    if not np.all(stats_arrays['warmup'][:, -1:]):
        # post-warmup acceptance check, on one host copy; ChEES keeps one
        # shared step state, so it is checked once
        step = carry.step
        if isinstance(step, CheesAdaptState):
            ss = type(step.step)(*[x.cpu().numpy() for x in step.step])
            msg = check_acceptance(ss, trace.target_accept, None)
            if msg is not None:
                warnings.warn(msg, RuntimeWarning)
        else:
            ss = type(step)(*[x.cpu().numpy() for x in step])
            for i in range(trace.n_chain):
                si = type(ss)(*[x[i] for x in ss])
                msg = check_acceptance(si, trace.target_accept, i)
                if msg is not None:
                    warnings.warn(msg, RuntimeWarning)

    return TraceTuple(trace)
