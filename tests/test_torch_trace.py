"""The tracer of a user's torch logp (``bayesfast_tpu_torch/ops/trace.py``),
its generated CUDA functor (``ops/codegen.py``) and the routing around it,
on the CPU.

* The program's interpreter against the user's eager torch function and
  its autograd gradient, for the five densities of
  ``examples/user_densities.py`` (bench.py's banana-32 and the JAX
  examples' banana, funnel, ring and cauchy written in torch): rtol 1e-6
  in float32 and 1e-12 in float64, the gradient with an atol of rtol
  times its largest magnitude (a component near 0 has no relative
  precision). The two sum in different orders (BLAS, torch's reductions,
  the warp's order), so they agree to rounding only.
* One case per op of the op set, and ops outside it raising
  ``TraceError`` with the aten op's name.
* The traced bench banana in the plain chunk, warmup and block
  transitions against the JAX Pallas kernels in interpret mode with
  ``bench.py``'s jnp density, with ``tests/test_torch_nuts_kernel.py``'s
  tolerances (the two momenta cases there).
* Routing: a traced density takes the kernels' path; one that does not
  trace warns once under 'auto' and takes the tree loop, and raises under
  'cuda'; so does D > 256, for a compiled-in and a traced density.
"""

import os
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import special_ortho_group

import bayesfast_tpu as bf
from bayesfast_tpu.samplers import nuts_pallas as jnpl
import bayesfast_tpu_torch as bt
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.examples.user_densities import DENSITIES
from bayesfast_tpu_torch.ops.codegen import cuda_source
from bayesfast_tpu_torch.ops.densities import spec_logp_and_grad
from bayesfast_tpu_torch.ops.trace import TraceError, trace_density
from bayesfast_tpu_torch.samplers import nuts as ttree
from bayesfast_tpu_torch.samplers import nuts_cuda as tnc
from bayesfast_tpu_torch.samplers.chain import ChainDriver
from bayesfast_tpu_torch.samplers.metrics import init_diag_metric
from test_torch_nuts_kernel import (_compare, _to_port_layout, momenta,  # noqa
                                    use_rounded_momenta)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = {torch.float32: 1e-6, torch.float64: 1e-12}


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU,
    in float64, with the kernels' mode as it was."""
    old = tconfig.set_device('cpu')
    old_dtype, old_mode = tconfig.get_dtype(), tconfig.get_nuts_kernel()
    tconfig.set_dtype(torch.float64)
    yield
    tconfig.set_device(old)
    tconfig.set_dtype(old_dtype)
    tconfig.set_nuts_kernel(old_mode)


def _points(den, n, seed):
    """Points inside the density's bounds, around its bulk (original
    space)."""
    rng = np.random.default_rng(seed)
    D = den.input_size
    lo, hi = den.input_scales[:, 0], den.input_scales[:, 1]
    return np.clip(rng.normal(size=(n, D)) * 1.5, lo * 0.9, hi * 0.9)


def _eager(fn, x):
    xr = x.clone().requires_grad_(True)
    lp = fn(xr)
    (g,) = torch.autograd.grad(lp.sum(), xr)
    return lp.detach(), g


def _close(got, want, rtol):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                               atol=rtol * want.abs().max().item())


# ---------------------------------------------------------------------------
# The interpreter against the user's eager function

@pytest.mark.parametrize('dtype', [torch.float32, torch.float64],
                         ids=['f32', 'f64'])
@pytest.mark.parametrize('name', list(DENSITIES))
def test_interpreter_matches_eager(name, dtype):
    den, _ = DENSITIES[name]()
    prog = trace_density(den._logp, den.input_size, dtype)
    x = torch.as_tensor(_points(den, 16, 1), dtype=dtype)
    lp, g = prog.logp_and_grad(x, prog.pack(dtype))
    lp_e, g_e = _eager(den._logp, x)
    assert lp.dtype == g.dtype == dtype and g.shape == x.shape
    np.testing.assert_allclose(lp.numpy(), lp_e.numpy(), rtol=RTOL[dtype])
    _close(g, g_e, RTOL[dtype])
    # the dense form (one torch sum a sum, one matmul a product)
    lp_d, g_d = prog.logp_and_grad(x, prog.pack(dtype), ordered=False)
    np.testing.assert_allclose(lp_d.numpy(), lp_e.numpy(), rtol=RTOL[dtype])
    _close(g_d, g_e, RTOL[dtype])


@pytest.mark.parametrize('name', list(DENSITIES))
def test_spec_in_transformed_space_matches_autograd(name):
    """The traced spec with the fused bound transform (the plain versions'
    density, ``nuts_cuda.plain_lpg``) against autograd through
    ``DensityLite``'s own transform and logp."""
    den, _ = DENSITIES[name]()
    assert den.has_kernel_spec and den.has_traced_spec
    spec = den.kernel_spec()
    assert spec['density'] == 'traced'
    x_t = torch.as_tensor(np.asarray(den.from_original(_points(den, 12, 2))))
    lp, g = spec_logp_and_grad(spec, x_t)
    lp_a, g_a = den.device_logp_and_grad(False)((), x_t)
    np.testing.assert_allclose(lp.numpy(), lp_a.numpy(), rtol=1e-12)
    _close(g, g_a, 1e-10)
    lp_p, g_p = tnc.plain_lpg(den)(x_t)
    assert torch.equal(lp_p, lp) and torch.equal(g_p, g)


# ---------------------------------------------------------------------------
# The op set, one case each

_A = torch.as_tensor(np.random.default_rng(3).normal(size=(6, 6)))
_B = torch.as_tensor(np.random.default_rng(4).normal(size=(4, 6)))
_W = torch.as_tensor(np.random.default_rng(5).normal(size=6))
_R9 = torch.arange(9, dtype=torch.float64)

OP_CASES = {
    'add': (lambda x: torch.sum(x + 2.5 + x, -1), 'add'),
    'sub': (lambda x: torch.sum(x - 1.5 - x * x, -1), 'sub'),
    'rsub': (lambda x: torch.sum(3.0 - x, -1) * x[..., 0], 'sub'),
    'mul': (lambda x: torch.sum(x * _W * x, -1), 'mul'),
    'div': (lambda x: torch.sum(x / 0.7 + 2.0 / (x * x + 1.0), -1), 'div'),
    'neg': (lambda x: -torch.sum(x * x, -1), 'neg'),
    'pow2': (lambda x: torch.sum((x - 1.0) ** 2, -1), 'mul'),
    'pow3': (lambda x: torch.sum(x ** 3, -1), 'mul'),
    'pow_neg': (lambda x: torch.sum((x * x + 1.0) ** -2, -1), 'recip'),
    'square': (lambda x: torch.sum(torch.square(x), -1), 'mul'),
    'reciprocal': (lambda x: torch.sum(torch.reciprocal(x * x + 2.0), -1),
                   'recip'),
    'exp': (lambda x: torch.sum(torch.exp(-0.5 * x), -1), 'exp'),
    'log': (lambda x: torch.sum(torch.log(x * x + 0.5), -1), 'log'),
    'log1p': (lambda x: torch.sum(torch.log1p(x * x), -1), 'log1p'),
    'sqrt': (lambda x: torch.sum(torch.sqrt(x * x + 1.0), -1), 'sqrt'),
    'scalar_vector': (lambda x: torch.sum(x[..., 0, None] * x
                                          + x[..., 1, None], -1)
                      * x[..., 2], 'pick'),
    'length1_broadcast': (lambda x: torch.sum(x[..., :1] * x, -1), 'gather'),
    'sum_keepdim': (lambda x: (torch.sum(x * x, dim=-1, keepdim=True)
                               * x).sum(-1), 'sum'),
    'dot': (lambda x: torch.dot(x, _W * x) if x.dim() == 1
            else torch.sum(x * (_W * x), -1), 'sum'),
    'mv': (lambda x: torch.sum((_A @ x) ** 2 if x.dim() == 1
                               else (x @ _A.T) ** 2, -1), 'mv'),
    'mm_transposed': (lambda x: torch.sum((x @ _A.T) ** 2, -1), 'mv'),
    'mm_rectangular': (lambda x: torch.sum(torch.exp(0.1 * (x @ _B.T)), -1),
                       'mv'),
    'mm': (lambda x: torch.sum((x @ _A) * x, -1), 'mv'),
    'slice_step': (lambda x: torch.sum(x[..., ::2] * x[..., 1::2], -1),
                   'gather'),
    'slice_negative': (lambda x: torch.sum(x[..., 1:-1] ** 2, -1)
                       + x[..., -1], 'gather'),
    'select': (lambda x: x[..., 3] * x[..., 0] - x[..., -2], 'pick'),
    'cat': (lambda x: torch.sum(torch.cat((x[..., -2:], x, x[..., :1]), -1)
                                ** 2 * _R9, -1), 'gather'),
    'roll': (lambda x: torch.sum(x * torch.roll(x, 2, dims=-1), -1),
             'gather'),
}


@pytest.mark.parametrize('case', list(OP_CASES))
def test_op_set(case):
    fn, op = OP_CASES[case]
    prog = trace_density(fn, 6, torch.float64)
    assert op in [nd.op for nd in prog.nodes]
    x = torch.as_tensor(np.random.default_rng(6).normal(size=(5, 6)))
    lp, g = prog.logp_and_grad(x, prog.pack())
    lp_e, g_e = _eager(fn, x)
    np.testing.assert_allclose(lp.numpy(), lp_e.numpy(), rtol=1e-12)
    _close(g, g_e, 1e-12)
    # the generated functor exists for it in both dtypes
    for dt in (torch.float32, torch.float64):
        src = cuda_source(prog, dt)
        assert 'struct Traced' in src and 'nuts_traced_launch' in src


@pytest.mark.parametrize('fn,name', [
    (lambda x: -torch.sum(torch.abs(x), -1), 'aten.abs'),
    (lambda x: torch.sum(torch.sin(x), -1), 'aten.sin'),
    (lambda x: torch.sum(x[torch.where(x > 0)], -1), 'aten.nonzero'),
    (lambda x: torch.sum(x ** 0.5, -1), 'aten.pow.Tensor_Scalar'),
    (lambda x: torch.sum(x * torch.randn(4), -1), 'aten.randn'),
], ids=['abs', 'sin', 'where', 'pow_half', 'factory'])
def test_outside_the_op_set_raises(fn, name):
    with pytest.raises(TraceError, match=name.replace('.', r'\.')):
        trace_density(fn, 4, torch.float64)


def test_control_flow_on_the_data_raises():
    def fn(x):
        return torch.sum(x, -1) if float(x[0]) > 0 else -torch.sum(x, -1)
    with pytest.raises(TraceError):
        trace_density(fn, 3, torch.float64)


# ---------------------------------------------------------------------------
# The generated source and the trace's key

def test_new_constants_keep_the_source():
    """A new matrix changes the packed constants, not the program: the
    generated unit (and so its build) is the same."""
    den_1, info = DENSITIES['bench_banana']()
    A2 = torch.as_tensor(special_ortho_group.rvs(32, random_state=7),
                         dtype=torch.float32)
    even = torch.as_tensor((np.arange(32) % 2) == 0, dtype=torch.float32)

    def logp(x):  # bench_banana's logp over another rotation
        z = x @ A2.to(x).T
        zn = torch.roll(z, -1, dims=-1)
        t = (z * z - zn) ** 2 / 0.01 + (z - 1.0) ** 2
        return -torch.sum(t * even.to(x), dim=-1) - info['const']

    p1 = den_1.kernel_spec()['program']
    p2 = trace_density(logp, 32, torch.float64)
    for dt in (torch.float32, torch.float64):
        assert p1.source(dt) == p2.source(dt)
    assert not torch.equal(p1.pack(), p2.pack())
    assert p1.n_ops == p2.n_ops == 4738


def test_spec_follows_the_tensors_in_place():
    """The trace is keyed by the bytes of the tensors the logp reads: a
    rotation changed in place gives a new key and new packed constants."""
    A = torch.as_tensor(special_ortho_group.rvs(4, random_state=1))

    def logp(x):
        return -0.5 * torch.sum((x @ A.T) ** 2, -1)

    den = bt.DensityLite(logp=logp, input_size=4)
    like = torch.zeros(3, 4, dtype=torch.float64)
    key_1, par_1 = den.kernel_spec_key(), tnc._spec_for(den, like)[2]
    with torch.no_grad():
        A.mul_(2.0)
    key_2, par_2 = den.kernel_spec_key(), tnc._spec_for(den, like)[2]
    assert key_1 != key_2
    assert torch.equal(par_2, 2.0 * par_1)
    x = torch.as_tensor(np.random.default_rng(2).normal(size=(3, 4)))
    lp, _ = tnc.plain_lpg(den)(x)
    np.testing.assert_allclose(lp.numpy(), logp(x).numpy(), rtol=1e-12)


# ---------------------------------------------------------------------------
# Against the JAX Pallas kernels in interpret mode, bench.py's density

D, C, K, MAXDEPTH, MAX_CHANGE = 32, 8, 2, 5, 1000.


def _bench_pair():
    """bench.py's jnp density in a JAX DensityLite (its float32 rotation
    and mask, as bench.py:129-145 writes them) and the torch one from
    ``user_densities.bench_banana``, with starts near the banana's ridge,
    per-chain metrics and steps around the scale a run adapts to at D = 32
    (0.03), two of them 400 times as long, which diverge. (At ten times
    the adapted step every trajectory's energy error is in the hundreds,
    and the ulp by which XLA's float32 Box-Muller differs from torch's
    grows past rtol 1e-6 there: ROADMAP's reference behaviours.)"""
    den_t, info = DENSITIES['bench_banana']()
    A = jnp.asarray(info['A'], dtype=jnp.float32)
    even = jnp.asarray((np.arange(D) % 2) == 0, jnp.float32)
    Q, const = info['Q'], info['const']

    def logp(x):
        z = x @ A.T
        zn = jnp.roll(z, -1, axis=-1)
        t = (z * z - zn) ** 2 / Q + (z - 1.0) ** 2
        return -jnp.sum(t * even) - const

    den_j = bf.DensityLite(logp=logp, input_size=D,
                           input_scales=den_t.input_scales, hard_bounds=True)
    rng = np.random.default_rng(11)
    xo = (info['A'].T @ np.ones(D))[None] + rng.normal(size=(C, D)) * 0.05
    q0 = np.asarray(den_t.from_original(xo))
    var = np.exp(rng.normal(size=(C, D)) * 0.2) * 1e-3
    eps = np.exp(rng.normal(size=C) * 0.3) * 0.03
    eps[:2] *= 400.0
    return den_j, den_t, q0, var, eps


def test_traced_frozen_chunk_matches_pallas(momenta):
    den_j, den_t, q0, var, eps = _bench_pair()
    seed, i0, chain_start = 123456789, 7, 5
    run = jnpl.make_nuts_pallas_multi(
        den_j.device_logp_and_grad(False), (), D, C, K, MAXDEPTH,
        MAX_CHANGE, jnp.float64, interpret=True)
    o = run(jnp.int32(seed), jnp.int32(i0), jnp.int32(chain_start),
            jnp.asarray(q0.T), jnp.asarray(var.T), jnp.asarray(eps)[None],
            [])
    want = {k: _to_port_layout(k, v) for k, v in o.items()}
    got = tnc.nuts_chunk_plain(
        seed, torch.as_tensor(q0), torch.as_tensor(var),
        torch.as_tensor(eps), K, MAXDEPTH, MAX_CHANGE, tnc.plain_lpg(den_t),
        i0, chain_start)
    _compare(got, want, *momenta)
    assert want['diverging'].any() and (want['tree_depth'] > 1).any()


def test_traced_warmup_chunk_matches_pallas(monkeypatch):
    tol = use_rounded_momenta(monkeypatch)
    den_j, den_t, q0, var, eps = _bench_pair()
    eps[:2] /= 400.0
    rng = np.random.default_rng(5)
    log_step = np.log(eps)
    step = (log_step, log_step + 0.1, rng.normal(size=C) * 0.01,
            np.full(C, 5.0), np.log(10 * eps))
    metric = (var, q0 + rng.normal(size=(C, D)) * 0.01, var * 10.0,
              np.full(C, 10.0), q0, var * 3.0, np.full(C, 3.0))
    wsched, _ = jnpl._window_schedule(4, 0, 5, K, 1, True)
    seed, i0, args = 987654321, 33, (0.8, 0.05, 0.75, 10.)
    run = jnpl.make_nuts_pallas_warmup(
        den_j.device_logp_and_grad(False), (), D, C, K, MAXDEPTH,
        MAX_CHANGE, jnp.float64, wsched, *args, True, True, interpret=True)
    row = lambda a: jnp.asarray(a).reshape(1, C)  # noqa: E731
    mat = lambda a: jnp.asarray(a).T  # noqa: E731
    o = run(jnp.int32(seed), jnp.int32(i0), jnp.int32(0), jnp.asarray(q0.T),
            tuple(row(a) for a in step),
            (mat(metric[0]), mat(metric[1]), mat(metric[2]), row(metric[3]),
             mat(metric[4]), mat(metric[5]), row(metric[6])), [], wsched)
    want = {k: _to_port_layout(k, v) for k, v in o.items()}
    got = tnc.nuts_warmup_chunk_plain(
        seed, torch.as_tensor(q0), [torch.as_tensor(a) for a in step],
        [torch.as_tensor(a) for a in metric], K, MAXDEPTH, MAX_CHANGE,
        *args, True, True, wsched, tnc.plain_lpg(den_t), i0)
    assert set(got) == set(want)
    _compare(got, want, *tol)


def test_traced_block_matches_pallas(momenta):
    den_j, den_t, q0, var, eps = _bench_pair()
    seed, chain_start = 2 ** 31 - 2, 1000
    run = jnpl.make_nuts_pallas(den_j.device_logp_and_grad(False), (), D, C,
                                MAXDEPTH, MAX_CHANGE, jnp.float64,
                                interpret=True)
    o = run(jnp.int32(seed), jnp.int32(chain_start), jnp.asarray(q0.T),
            jnp.asarray(var.T), jnp.asarray(eps), [])
    want = {k: _to_port_layout(k, v) for k, v in o.items()}
    got = tnc.nuts_block_plain(seed, torch.as_tensor(q0),
                               torch.as_tensor(var), torch.as_tensor(eps),
                               MAXDEPTH, MAX_CHANGE, tnc.plain_lpg(den_t),
                               chain_start)
    assert set(got) == set(want)
    _compare(got, want, *momenta)
    assert want['diverging'].any()


# ---------------------------------------------------------------------------
# Routing

def _trace(n_chain=4, n_iter=12, n_warmup=6, D=None, seed=3):
    out = dict(n_chain=n_chain, n_iter=n_iter, n_warmup=n_warmup,
               random_generator=seed)
    if D is not None:
        out['x_0'] = np.random.default_rng(seed).normal(size=(n_chain, D))
    return bt.NTrace(**out)


def test_traced_density_samples_on_the_kernels_path():
    """bt.sample over the traced bench banana makes no tree-loop
    transition; the chunk wrappers run the interpreter on the CPU."""
    den, info = DENSITIES['bench_banana']()
    tconfig.set_nuts_kernel('auto')
    n0 = ttree.nuts_transition_batched.transitions
    with warnings.catch_warnings():
        warnings.simplefilter('error', RuntimeWarning)
        warnings.filterwarnings('ignore', message='.*diverg')
        warnings.filterwarnings('ignore', message='for chain #')
        warnings.filterwarnings('ignore', message='.*tree depth')
        tt = bt.sample(den, _trace(), verbose=False)
    assert ttree.nuts_transition_batched.transitions == n0
    assert np.isfinite(tt.get()).all()
    chains = tt.trace._driver_cache[1]
    assert chains.uses_kernels(tt.trace._carry.metric)


def _untraceable(D=3):
    return bt.DensityLite(
        logp=lambda x: -0.5 * torch.sum(torch.abs(x) ** 2, -1),
        input_size=D)


def test_untraceable_warns_once_and_takes_the_tree_loop():
    den = _untraceable()
    assert not den.has_kernel_spec
    assert 'aten.abs' in den.kernel_trace_error()
    tconfig.set_nuts_kernel('auto')
    n0 = ttree.nuts_transition_batched.transitions
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter('always')
        tt = bt.sample(den, _trace(), verbose=False, n_update=3)
    mine = [w for w in rec if 'does not trace' in str(w.message)]
    assert len(mine) == 1 and issubclass(mine[0].category, RuntimeWarning)
    assert 'aten.abs' in str(mine[0].message)
    assert ttree.nuts_transition_batched.transitions - n0 == 12
    assert np.isfinite(tt.get()).all()


def test_untraceable_raises_under_cuda():
    den = _untraceable()
    tconfig.set_nuts_kernel('cuda')
    try:
        with pytest.raises(NotImplementedError, match='aten.abs'):
            bt.sample(den, _trace(), verbose=False)
    finally:
        tconfig.set_nuts_kernel('auto')


def _wide_gaussian(D):
    return bt.DensityLite(logp=bt.ops.DiagGaussian(np.zeros(D), np.ones(D)),
                          input_size=D)


def _wide_traced(D):
    return bt.DensityLite(logp=lambda x: -0.5 * torch.sum(x * x, -1),
                          input_size=D)


@pytest.mark.parametrize('make', [_wide_gaussian, _wide_traced],
                         ids=['compiled_in', 'traced'])
def test_past_64_dimensions_takes_the_tree_loop(make):
    """D = 257 (the kernels take D <= 256, eight dimensions a lane): the
    density keeps its spec (the plain versions' analytic form serves any
    D), ``uses_kernels`` says no, 'auto' samples on the tree loop and
    'cuda' raises before any device work."""
    D = 257
    den = make(D)
    assert den.has_kernel_spec
    q = torch.zeros(4, D, dtype=torch.float64)
    metric = init_diag_metric(q, torch.ones(4, D, dtype=torch.float64))
    assert 'D <= 256' in tnc.kernel_refusal(den, D)
    assert tnc.kernel_refusal(den, 256) is None
    assert not ChainDriver(den).uses_kernels(metric)
    tconfig.set_nuts_kernel('auto')
    n0 = ttree.nuts_transition_batched.transitions
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        tt = bt.sample(den, _trace(D=D), verbose=False, n_update=6)
    assert ttree.nuts_transition_batched.transitions - n0 == 12
    assert np.isfinite(tt.get()).all()
    with pytest.raises(NotImplementedError, match='D <= 256'):
        ChainDriver(den, nuts_kernel='cuda').uses_kernels(metric)
    tconfig.set_nuts_kernel('cuda')
    try:
        with pytest.raises(NotImplementedError, match='D <= 256'):
            bt.sample(den, _trace(D=D), verbose=False)
    finally:
        tconfig.set_nuts_kernel('auto')


def test_new_modules_import_no_jax():
    """The tracer, the generator, the user densities and every module the
    user-gradient slice touched (the density, the sampling entry point,
    the samplers and their routing, the host pool, the configuration, the
    flow, the estimators and the splines) and the host library's bindings
    with the KDE and the build, imported in a fresh
    interpreter, load nothing of JAX or of the JAX package."""
    mods = ['ops.trace', 'ops.codegen', 'examples.user_densities',
            'core.density', 'core.sample', 'samplers.nuts',
            'samplers.tempered', 'samplers.chain', 'samplers.nuts_cuda',
            'samplers.sample_trace', 'utils.parallel', 'config',
            'transforms.sit', 'evidence.gaussianized', 'utils.cubic',
            'native', 'native.bindings', 'utils.kde', '_build']
    code = ('import sys; import ' + ', '.join(
                'bayesfast_tpu_torch.' + m for m in mods) + '; '
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "bayesfast_tpu")]; '
            'print(bad); sys.exit(1 if bad else 0)')
    env = dict(os.environ, PYTHONPATH=_REPO)
    res = subprocess.run([sys.executable, '-c', code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
