"""The port's sampling slice as a whole against the JAX package.

(a) the chunk driver on the same carry, (b) ``sample`` end to end, (c) the
port imports no JAX, (d) ``nuts_kernel='cuda'`` on CPU tensors raises.
"""

import importlib
import os
import subprocess
import sys
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.stats import special_ortho_group

import bayesfast_tpu as bf
import bayesfast_tpu_torch as bt
from bayesfast_tpu.samplers import chain as jchain
from bayesfast_tpu.samplers import nuts_pallas as jnpl
from bayesfast_tpu.samplers.metrics import (init_diag_metric as j_init_diag,
                                            sample_momentum_b as j_momenta)
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch import interop
from bayesfast_tpu_torch.core.density import DensityLite
from bayesfast_tpu_torch.ops.densities import DiagGaussian
from bayesfast_tpu_torch.samplers import chain as tchain
from bayesfast_tpu_torch.samplers import nuts_cuda as tnc
from test_torch_nuts_kernel import use_rounded_momenta


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


# the modules (the packages re-export the function under the same name)
jsample = importlib.import_module('bayesfast_tpu.core.sample')
tsample = importlib.import_module('bayesfast_tpu_torch.core.sample')
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
def _banana_pair(D, Q):
    A = special_ortho_group.rvs(D, random_state=2)
    bounds = np.stack([np.full(D, -15.), np.full(D, 15.)]).T
    Aj = jnp.asarray(A)
    even = jnp.asarray((np.arange(D) % 2) == 0, jnp.float64)

    def logp(x):
        z = x @ Aj.T
        zn = jnp.roll(z, -1, axis=-1)
        t = (z * z - zn) ** 2 / Q + (z - 1.0) ** 2
        return -jnp.sum(t * even)

    den_j = bf.DensityLite(logp=logp, input_size=D, input_scales=bounds,
                           hard_bounds=True)
    return A, den_j, interop.banana_density(A, Q, bounds)


def _assert_close(got, want, name, rtol=1e-9, atol=1e-10):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype.kind in 'biu':
        assert np.array_equal(got.astype(want.dtype), want), name
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=name)


def test_driver_chunks_match_jax(monkeypatch):
    """One JAX carry through JAX's ChainDriver and, converted by
    ``interop``, through the port's: warmup then frozen chunks, with the
    chunk cap at 4 on both sides so chunk splitting is covered. Both sides
    draw the same correctly rounded Box-Muller momenta (see
    test_torch_nuts_kernel.py), so floats agree to rtol 1e-9."""
    use_rounded_momenta(monkeypatch)
    monkeypatch.setattr(jchain.ChainDriver, '_CHUNK_CAP', 4)
    monkeypatch.setattr(tchain.ChainDriver, '_CHUNK_CAP', 4)
    D, C, n_warm, n_post = 4, 16, 10, 6
    A, den_j, den_t = _banana_pair(D, 0.1)
    rng = np.random.default_rng(3)
    xo = (A.T @ np.ones(D))[None] + rng.normal(size=(C, D)) * 0.05
    x0 = np.asarray(den_t.from_original(xo))
    eps0 = np.exp(rng.normal(size=C) * 0.2) * 0.02
    trace = bf.NTrace(n_chain=C, n_iter=50, n_warmup=n_warm,
                      max_treedepth=6, adapt_window=3, random_generator=11)
    carry_j = jsample._init_carry(trace, x0, jnp.float64, False, 'nuts',
                                  eps0)
    seed = int(jax.random.randint(carry_j.key[0], (), 0,
                                  np.int32(2 ** 31 - 1), dtype=jnp.int32))
    carry_t = interop.carry_from_numpy(
        seed, np.asarray(carry_j.q), jax.tree.map(np.asarray, carry_j.step),
        jax.tree.map(np.asarray, carry_j.metric))

    drv_j = jchain.ChainDriver(den_j.device_logp_and_grad(False),
                               algorithm='nuts', max_treedepth=6,
                               nuts_kernel='pallas')
    drv_t = tchain.ChainDriver(den_t, max_treedepth=6)
    cj, (qj, (sj, ej)), wj = drv_j.run_warmup_chunk(carry_j, n_warm, (),
                                                    i0=0)
    ct, (qt, (st, et)), wt = drv_t.run_warmup_chunk(carry_t, n_warm, i0=0)
    # three chunks (4 + 4 + 2) and a window switch at adapt_window 3
    assert wt == wj and wj[1] > 0
    _assert_close(qt, qj, 'warmup q')
    for k, v in sj._asdict().items():
        _assert_close(getattr(st, k), v, 'warmup ' + k)
    for k in ('step_size', 'step_size_bar'):
        _assert_close(et[k], ej[k], k)
    for k in ('log_step', 'log_bar', 'hbar', 'count', 'mu'):
        _assert_close(getattr(ct.step, k), getattr(cj.step, k), k)
    _assert_close(ct.metric.var, cj.metric.var, 'var')
    for w in ('fg', 'bg'):
        for k in ('mean', 'raw', 'weight'):
            _assert_close(getattr(getattr(ct.metric, w), k),
                          getattr(getattr(cj.metric, w), k), f'{w}.{k}')

    cj2, (qj2, (sj2, _)) = drv_j.run_frozen_chunk(cj, n_post, (), i0=n_warm)
    ct2, (qt2, (st2, _)) = drv_t.run_frozen_chunk(ct, n_post, i0=n_warm)
    _assert_close(qt2, qj2, 'frozen q')
    for k, v in sj2._asdict().items():
        _assert_close(getattr(st2, k), v, 'frozen ' + k)
    _assert_close(ct2.q, cj2.q, 'final q')
    _assert_close(ct2.step.accept_sum, cj2.step.accept_sum, 'accept_sum')
    _assert_close(ct2.step.accept_count, cj2.step.accept_count,
                  'accept_count')


def _gauss_pair(D):
    mean = np.array([1.5, -0.5, 0.3, 2.0])[:D]
    var = np.array([0.5, 2.0, 1.0, 0.3])[:D]
    bounds = np.stack([np.full(D, -10.), np.full(D, 10.)]).T
    mj, vj = jnp.asarray(mean), jnp.asarray(var)
    den_j = bf.DensityLite(
        logp=lambda x: -0.5 * jnp.sum((x - mj) ** 2 / vj), input_size=D,
        input_scales=bounds, hard_bounds=True)
    den_t = DensityLite(logp=DiagGaussian(mean, var), input_size=D,
                        input_scales=bounds, hard_bounds=True)
    return mean, var, den_j, den_t


def test_sample_end_to_end_matches_jax():
    D, C, n_iter, n_warm = 4, 64, 200, 100
    mean, var, den_j, den_t = _gauss_pair(D)
    trace_j = bf.NTrace(n_chain=C, n_iter=n_iter, n_warmup=n_warm,
                        random_generator=5)
    trace_t = bt.NTrace(n_chain=C, n_iter=n_iter, n_warmup=n_warm,
                        random_generator=5)
    with warnings.catch_warnings():
        # 100 warmup iterations leave some chains' acceptance off target:
        # both packages warn per chain
        warnings.simplefilter('ignore', RuntimeWarning)
        tt_j = bf.sample(den_j, trace_j, verbose=False)
        tt_t = bt.sample(den_t, trace_t, verbose=False)

    # the same Sobol starts, the same start descent
    np.testing.assert_allclose(trace_t._x_0, trace_j._x_0, rtol=0,
                               atol=1e-12)
    x_j, n_j = jsample._descend_x0(den_j, trace_j._x_0, trace_j,
                                   jnp.float64)
    x_t, n_t = tsample._descend_x0(den_t, trace_t._x_0, trace_t,
                                   torch.float64)
    assert n_t == n_j
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=1e-6)

    # the step probe, given the JAX probe's own momenta
    step0 = 1.0 / D ** 0.25
    key = jax.random.fold_in(trace_j.random_generator, 0xf1d)
    ms = j_init_diag(jnp.zeros(D), jnp.ones(D))
    p0 = np.asarray(j_momenta(ms, key, (C, D), jnp.float64))
    eps_j, ne_j = jsample._find_reasonable_step(den_j, x_j, trace_j,
                                                jnp.float64, step0)
    eps_t, ne_t = tsample._find_reasonable_step(den_t, x_j, trace_t,
                                                torch.float64, step0, p0=p0)
    assert ne_t == ne_j
    np.testing.assert_allclose(eps_t, eps_j, rtol=1e-12)

    # posterior moments agree with each other and the truth within MC error
    s_j, s_t = tt_j.get(), tt_t.get()
    assert s_t.shape == s_j.shape == (C * (n_iter - n_warm), D)
    assert np.isfinite(s_t).all()
    sd = np.sqrt(var)
    for s in (s_j, s_t):
        assert np.all(np.abs(s.mean(0) - mean) < 0.1 * sd)
        assert np.all(np.abs(s.var(0) / var - 1) < 0.15)
    assert np.all(np.abs(s_t.mean(0) - s_j.mean(0)) < 0.15 * sd)
    assert np.all(np.abs(s_t.var(0) / s_j.var(0) - 1) < 0.2)

    # the same n_call formula: tree leaves + one start per iteration and
    # chain + the start-up evaluations (descent, then probe)
    for tr in (trace_j, trace_t):
        ts = tr._stats_arrays['tree_size']
        assert tr.n_call == (np.sum(ts[:, 1:]) + C * (n_iter + 1)
                             + tr._descent_calls)
        assert (tr._descent_calls - C * n_j) % C == 0
        assert 2 <= (tr._descent_calls - C * n_j) // C <= 62


def _is_jax_side(name):
    return name.split('.')[0] in ('jax', 'jaxlib', 'bayesfast_tpu')


def test_import_leaves_jax_out():
    """Every module of the port, and chip_smoke.py, imported in a fresh
    interpreter, loads nothing of JAX or of the JAX package."""
    code = ('import sys, importlib, pkgutil, bayesfast_tpu_torch as bt; '
            '[importlib.import_module(m.name) for m in '
            'pkgutil.walk_packages(bt.__path__, "bayesfast_tpu_torch.")]; '
            'import chip_smoke; '
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "bayesfast_tpu")]; '
            'print(bad); sys.exit(1 if bad else 0)')
    env = dict(os.environ, PYTHONPATH=_REPO)
    res = subprocess.run([sys.executable, '-c', code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_import_no_jax():
    """No import statement of the port or of chip_smoke.py, at any level
    (chip_smoke imports inside its functions), names JAX or the JAX
    package. The port's ignored build directory holds generated units and
    whatever a run unpacked there, nothing of the port's own Python: it is
    not read."""
    import ast
    import glob
    build = os.path.join(_REPO, 'bayesfast_tpu_torch', 'build', '')
    files = [f for f in glob.glob(os.path.join(_REPO, 'bayesfast_tpu_torch',
                                               '**', '*.py'), recursive=True)
             if not f.startswith(build)]
    files.append(os.path.join(_REPO, 'chip_smoke.py'))
    # the host library's bindings are among them
    native = os.path.join(_REPO, 'bayesfast_tpu_torch', 'native', '')
    assert {os.path.relpath(f, native) for f in files
            if f.startswith(native)} == {'__init__.py', 'bindings.py'}
    for f in files:
        with open(f) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not any(_is_jax_side(n) for n in names), (f, names)


def test_cuda_kernel_mode_on_cpu_raises():
    _, _, _, den_t = _gauss_pair(4)
    tconfig.set_nuts_kernel('cuda')
    try:
        with pytest.raises(RuntimeError, match='CUDA'):
            bt.sample(den_t, bt.NTrace(n_chain=8, n_iter=20, n_warmup=10,
                                       random_generator=1), verbose=False)
    finally:
        tconfig.set_nuts_kernel('auto')
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
