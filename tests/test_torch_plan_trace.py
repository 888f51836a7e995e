"""A ``Density`` plan traced into the CUDA NUTS kernels' op set
(``bayesfast_tpu_torch/ops/trace.py`` over ``Density._logp_traced``), on
the CPU.

* One case per op that a plan adds to the op set (a gather by a constant
  index, a scatter-add into zeros, each comparison, ``where``, ``clamp``,
  ``maximum``, a constant folded from a parameter): the program's
  interpreter against the eager function and its autograd gradient, rtol
  1e-12 in float64 and 1e-6 in float32 (the gradient with an atol of rtol
  times its largest magnitude). Ties of ``clamp`` and ``maximum`` follow
  torch's rule (clamp's gradient goes to x at a bound, maximum's splits
  in half).
* The 2-d donut's plans (``examples/donut_recipe.py``: a linear and a
  quadratic PolyModel, then the user's ``f_1``, with the decay), a
  quadratic PolyModel with its bound active (points inside and outside
  the alpha-ellipsoid) and one before the first fit (alpha and the
  decay's alpha^2 infinite), with the JAX package's surrogates carried
  across: the traced program against ``jax.value_and_grad`` of the JAX
  ``Density._logp_traced``, rtol 1e-10.
* A PolyModel -> Gaussian plan traced agrees with the compiled-in
  ``PolyGaussian``'s plain form, and the route still picks the compiled-in
  one.
* The traced donut plan in the plain chunk, warmup and block transitions
  against the JAX Pallas kernels in interpret mode over the JAX
  ``Density.device_logp_and_grad(False)``, with
  ``test_torch_nuts_kernel.py``'s tolerances and, as
  ``test_torch_anchors.py`` compares, an atol of rtol times each output's
  largest magnitude: the donut's logp is near zero on its ring, where an
  element carries the absolute error that an ulp of a float32 momentum
  grows into along the trajectory.
* A refit packs new parameters into the same program and source; the
  routing: 0 tree-loop transitions on the donut's plan, a warning and the
  tree loop under 'auto' for an untraceable plan (raising under 'cuda'),
  and a ``TraceError`` for an external module and for a program past the
  kernels' constant or shared memory.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesfast_tpu as bf
from bayesfast_tpu.modules import PolyModel as JPoly
from bayesfast_tpu.samplers import nuts_pallas as jnpl
import bayesfast_tpu_torch as bt
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch._build import traced_path
from bayesfast_tpu_torch.interop import (density_decay_from_numpy,
                                         poly_from_numpy)
from bayesfast_tpu_torch.modules import Gaussian, PolyConfig, PolyModel
from bayesfast_tpu_torch.ops.densities import spec_logp_and_grad
from bayesfast_tpu_torch.ops.trace import TraceError, trace_density
from bayesfast_tpu_torch.samplers import nuts as ttree
from bayesfast_tpu_torch.samplers import nuts_cuda as tnc
from test_torch_anchors import _compare
from test_torch_nuts_kernel import (_to_port_layout, momenta,  # noqa
                                    use_rounded_momenta)

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


def _close(got, want, rtol):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                               atol=rtol * want.abs().max().item())


# ---------------------------------------------------------------------------
# One case per new op, on one point x (6,)

_IDX = torch.tensor([0, 2, 2, 5, 1])
_IDX2 = torch.tensor([3, 3, 4, 0, 5])
_OM = torch.tensor([0, 3, 1, 3, 0, 2])
_W4 = torch.tensor([0.5, -1.5, 2.0, 0.75], dtype=torch.float64)
_ALPHA = torch.tensor(float('inf'), dtype=torch.float64)


def _scatter(x):
    out = x.new_zeros(4).index_add(0, _OM, x * x)
    return torch.sum(out * _W4.to(x))


def _index_put(x):
    out = torch.zeros(4, dtype=x.dtype).index_put((_OM,), x * x,
                                                  accumulate=True)
    return torch.sum(torch.exp(0.1 * out))


def _fold(x):
    a = torch.where(torch.isfinite(_ALPHA), _ALPHA, torch.ones_like(_ALPHA))
    return -torch.sum(x * x, -1) / a.to(x)


# name: (function, a node op it must lower to, ties in the first point)
NEW_OPS = {
    'gather': (lambda x: torch.sum(x[_IDX] * x[_IDX2]), 'gather', None),
    'scatter_add': (_scatter, 'gather', None),
    'index_put': (_index_put, 'gather', None),
    'lt': (lambda x: torch.sum(torch.where(x < 0.2, x * x, 3.0 * x)), 'lt',
           None),
    'le': (lambda x: torch.sum(torch.where(x <= x[2], x, -x)), 'le', None),
    'gt': (lambda x: torch.sum(torch.where(x > 0.0, torch.exp(x), 1.0 + x)),
           'gt', None),
    'ge': (lambda x: torch.where(torch.sum(x * x) >= 4.0, torch.sum(x),
                                 torch.sum(x * x)), 'ge', None),
    'where': (lambda x: torch.sum(torch.where(x[:3] < x[3:], x[:3] * x[3:],
                                              x[3:] - x[:3])), 'where',
              None),
    'clamp': (lambda x: torch.sum(torch.clamp(x, min=-0.5, max=0.7) ** 2),
              'where', (0, -0.5)),
    'clamp_min': (lambda x: torch.sum(torch.sqrt(torch.clamp(x * x - 0.3,
                                                             min=1e-30))),
                  'where', None),
    'maximum': (lambda x: torch.sum(torch.maximum(x, 0.5 * x.flip(0)) ** 2),
                'where', (1, 0.8)),
    'fold': (_fold, 'cscal', None),
}


def _eager_rows(fn, x):
    """The eager function and its autograd gradient, one row at a time."""
    lps, gs = [], []
    for row in x:
        r = row.clone().requires_grad_(True)
        lp = fn(r)
        (g,) = torch.autograd.grad(lp, r)
        lps.append(lp.detach())
        gs.append(g)
    return torch.stack(lps), torch.stack(gs)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64],
                         ids=['f32', 'f64'])
@pytest.mark.parametrize('case', list(NEW_OPS))
def test_new_op(case, dtype):
    fn, op, tie = NEW_OPS[case]
    prog = trace_density(fn, 6, dtype)
    assert op in [nd.op for nd in prog.nodes]
    x = torch.as_tensor(np.random.default_rng(8).normal(size=(7, 6)),
                        dtype=dtype)
    if tie is not None:
        x[0, tie[0]] = tie[1]
        if case == 'maximum':      # x_1 == 0.5 x_4: a tie of maximum
            x[0, 4] = 2.0 * x[0, 1]
    lp, g = prog.logp_and_grad(x, prog.pack(dtype))
    lp_e, g_e = _eager_rows(fn, x)
    assert lp.dtype == g.dtype == dtype
    np.testing.assert_allclose(lp.numpy(), lp_e.numpy(), rtol=RTOL[dtype])
    _close(g, g_e, RTOL[dtype])


def test_folded_constant_is_packed_not_a_literal():
    """``where(isfinite(alpha), alpha, 1)`` is evaluated at the trace into
    a packed constant: the program reads it from the parameters, and a
    new alpha changes the parameters, not the source."""
    def logp(x, alpha):
        a = torch.where(torch.isfinite(alpha), alpha, torch.ones_like(alpha))
        return -torch.sum(x * x) / a

    inf = torch.tensor(float('inf'), dtype=torch.float64)
    prog = trace_density(logp, 3, torch.float64, leaves=[inf])
    assert 'isfinite' not in prog.describe()
    assert float(prog.pack(leaves=[inf])[0]) == 1.0
    assert float(prog.pack(leaves=[torch.tensor(2.5).double()])[0]) == 2.5
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(4, 3)))
    lp, g = prog.logp_and_grad(x, prog.pack(leaves=[torch.tensor(
        2.5).double()]))
    np.testing.assert_allclose(lp.numpy(), (-(x * x).sum(-1) / 2.5).numpy(),
                               rtol=1e-15)
    np.testing.assert_allclose(g.numpy(), (-2 * x / 2.5).numpy(), rtol=1e-15)


# ---------------------------------------------------------------------------
# The donut's plans against the JAX package's

A_R, B_R = 5.0, 0.5


def _donut(pkg, order, bound):
    """The donut's Density (``examples/donut_recipe.py``) in one package
    (``bf`` or ``bt``) with a surrogate of ``order`` attached."""
    if pkg is bf:
        def f_0(x):
            return jnp.linalg.norm(x, 2, -1)
    else:
        def f_0(x):
            return torch.linalg.vector_norm(x, 2, -1)

    def f_1(m):
        return -(m - A_R) ** 2 / B_R

    den = pkg.Density(module_list=[
        pkg.Module(fun=f_0, input_vars='x', output_vars='m'),
        pkg.Module(fun=f_1, input_vars='m', output_vars='logp')],
        input_shapes=[2], input_vars='x', density_name='logp')
    den.set_decay_options(use_decay=True)
    Poly = JPoly if pkg is bf else PolyModel
    su = Poly(order, input_size=2, output_size=1, input_vars='x',
              output_vars='m')
    su.set_bound_options(use_bound=bound)
    den.surrogate_list = [su]
    return den, su


def _ring(n, seed, spread=0.3):
    """Points around the donut's ring, radius 5."""
    rng = np.random.default_rng(seed)
    phi = rng.uniform(0, 2 * np.pi, n)
    r = A_R + rng.normal(size=n) * spread
    return np.stack([r * np.cos(phi), r * np.sin(phi)], -1)


def _carry(su_j, bound):
    return poly_from_numpy(
        [(c.order, c.input_mask, c.output_mask, np.asarray(c._a))
         for c in su_j.configs], su_j._mu, su_j._hess, su_j._alpha,
        su_j._f_mu, {'use_bound': bound}, input_size=2, output_size=1,
        input_vars='x', output_vars='m')


def _pair(order, bound, prefit=False, seed=3):
    """The JAX donut fitted on seeded points (on a quarter of the ring, so
    the surrogate's bound ellipsoid leaves most of the ring outside), and
    the port's with the JAX surrogate and decay carried across; ``prefit``
    resets both to their state before a first fit (alpha and the decay's
    alpha^2 infinite, the decay's centre zero)."""
    den_j, su_j = _donut(bf, order, bound)
    rng = np.random.default_rng(seed)
    phi = rng.uniform(0, 0.5 * np.pi, 40)
    r = A_R + rng.normal(size=40) * 0.4
    x_fit = np.stack([r * np.cos(phi), r * np.sin(phi)], -1)
    den_j.fit(den_j.fun(x_fit, original_space=True, use_surrogate=False))
    if prefit:
        su_j._alpha = None
        den_j._mu = den_j._hess = None
        den_j._alpha_2_val = np.inf
    den_j.use_surrogate = True
    den_t, _ = _donut(bt, order, bound)
    den_t.surrogate_list = [_carry(su_j, bound)]
    density_decay_from_numpy(den_t, den_j._mu, den_j._hess,
                             den_j._alpha_2_val)
    den_t.use_surrogate = True
    return den_j, den_t


def _jax_lpg(den_j, x):
    params = den_j.current_params()
    f = jax.vmap(jax.value_and_grad(
        lambda xi: den_j._logp_traced(xi, params, True, True)))
    lp, g = f(jnp.asarray(x))
    return np.asarray(lp), np.asarray(g)


@pytest.mark.parametrize('order,bound,prefit', [
    ('linear', False, False), ('quadratic', False, False),
    ('quadratic', True, False), ('quadratic', True, True)],
    ids=['linear', 'quadratic', 'quadratic_bound', 'before_fit'])
def test_donut_plan_matches_jax(order, bound, prefit):
    den_j, den_t = _pair(order, bound, prefit)
    spec = den_t.kernel_spec()
    assert spec['density'] == 'traced' and den_t.has_traced_spec
    x = np.concatenate([_ring(48, 4), np.random.default_rng(5).uniform(
        -9, 9, size=(16, 2))])
    lp, g = spec['program'].logp_and_grad(torch.as_tensor(x),
                                          spec['params'][0])
    lp_j, g_j = _jax_lpg(den_j, x)
    assert np.isfinite(lp.numpy()).all() and np.isfinite(g.numpy()).all()
    np.testing.assert_allclose(lp.numpy(), lp_j, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(g.numpy(), g_j, rtol=1e-10, atol=1e-10)
    su = den_j.surrogate_list[0]
    if bound and not prefit:
        beta = np.sqrt(np.einsum('ij,jk,ik->i', x - su._mu, su._hess,
                                 x - su._mu))
        assert (beta <= su._alpha).any() and (beta > su._alpha).any()
    if not prefit:
        bd = np.einsum('ij,jk,ik->i', x - den_j._mu, den_j._hess,
                       x - den_j._mu)
        assert (bd > den_j._alpha_2_val).any()


# ---------------------------------------------------------------------------
# The compiled-in PolyGaussian route

def test_poly_gaussian_plan_traced_matches_compiled_in():
    """A narrow DES-like surrogate (D = 4, 10 outputs, quadratic in 2 of
    them) then a diagonal Gaussian: its plan traced agrees with the
    compiled-in ``PolyGaussian``'s plain form, and the route keeps the
    compiled-in one."""
    D, M = 4, 10
    rng = np.random.default_rng(0)
    Amat = rng.normal(size=(M, D))

    def forward(x):
        x = np.asarray(x)
        return Amat @ x + 0.3 * x[0] * x[1]

    model = bt.Module(fun=forward, input_vars='x', output_vars='m',
                      input_shapes=[D], output_shapes=[M], traceable=False)
    like = Gaussian(mean=forward(np.full(D, 0.1)), cov=np.full(M, 0.05),
                    input_vars='m', output_vars='logp')
    den = bt.Density(density_name='logp', module_list=[model, like],
                     input_vars='x', input_shapes=[D],
                     input_scales=np.stack([np.full(D, -5.),
                                            np.full(D, 5.)]).T,
                     hard_bounds=True, decay_options={'use_decay': True})
    su = PolyModel([PolyConfig('linear'),
                    PolyConfig('quadratic', input_mask=[0, 1])],
                   input_size=D, output_size=M, input_vars='x',
                   output_vars='m')
    den.surrogate_list = [su]
    x_fit = 0.1 + rng.normal(size=(60, D)) * 0.3
    den.fit(den.fun(x_fit, original_space=True, use_surrogate=False))
    den.use_surrogate = True
    spec = den.kernel_spec()
    assert spec['density'] == 'poly_gaussian' and not den.has_traced_spec
    prog = den._program()
    traced = dict(density='traced', dim=D, program=prog,
                  params=[prog.pack(leaves=den._leaf_tensors(
                      den._param_leaves()[0]))],
                  scalars=(0.0, 0.0), transform=spec['transform'])
    xt = torch.as_tensor(den.from_original(
        0.1 + rng.normal(size=(32, D)) * 0.8))
    lp_c, g_c = spec_logp_and_grad(spec, xt)
    lp_t, g_t = spec_logp_and_grad(traced, xt)
    np.testing.assert_allclose(lp_t.numpy(), lp_c.numpy(), rtol=1e-10)
    np.testing.assert_allclose(g_t.numpy(), g_c.numpy(), rtol=1e-10,
                               atol=1e-10 * g_c.abs().max().item())


# ---------------------------------------------------------------------------
# Against the JAX Pallas kernels in interpret mode

C, K, MAXDEPTH, MAX_CHANGE = 8, 4, 6, 1000.


def _chain_inputs():
    """Starts on the ring, per-chain metrics and steps near the adapted
    scale, two of them 60 times as long."""
    q0 = _ring(C, 11, 0.2)
    rng = np.random.default_rng(12)
    var = np.exp(rng.normal(size=(C, 2)) * 0.2) * 2.0
    eps = np.exp(rng.normal(size=C) * 0.2) * 0.4
    eps[:2] *= 60.0
    return q0, var, eps


def test_traced_plan_frozen_chunk_matches_pallas(momenta):
    den_j, den_t = _pair('quadratic', False)
    q0, var, eps = _chain_inputs()
    params = den_j.current_params()
    run = jnpl.make_nuts_pallas_multi(
        den_j.device_logp_and_grad(False), params, 2, C, K, MAXDEPTH,
        MAX_CHANGE, jnp.float64, interpret=True)
    seed, i0 = 123456789, 7
    o = run(jnp.int32(seed), jnp.int32(i0), jnp.int32(3),
            jnp.asarray(q0.T), jnp.asarray(var.T), jnp.asarray(eps)[None],
            jax.tree.leaves(params))
    want = {k: _to_port_layout(k, v) for k, v in o.items()}
    got = tnc.nuts_chunk_plain(
        seed, torch.as_tensor(q0), torch.as_tensor(var),
        torch.as_tensor(eps), K, MAXDEPTH, MAX_CHANGE, tnc.plain_lpg(den_t),
        i0, 3)
    _compare(got, want, *momenta)
    assert (want['tree_depth'] > 1).any() and want['diverging'].any()


def test_traced_plan_warmup_chunk_matches_pallas(monkeypatch):
    tol = use_rounded_momenta(monkeypatch)
    den_j, den_t = _pair('quadratic', False)
    q0, var, eps = _chain_inputs()
    eps[:2] /= 60.0
    rng = np.random.default_rng(5)
    log_step = np.log(eps)
    step = (log_step, log_step + 0.1, rng.normal(size=C) * 0.01,
            np.full(C, 5.0), np.log(10 * eps))
    metric = (var, q0 + rng.normal(size=(C, 2)) * 0.01, var * 10.0,
              np.full(C, 10.0), q0, var * 3.0, np.full(C, 3.0))
    wsched, _ = jnpl._window_schedule(4, 0, 5, K, 1, True)
    args = (0.8, 0.05, 0.75, 10.)
    params = den_j.current_params()
    run = jnpl.make_nuts_pallas_warmup(
        den_j.device_logp_and_grad(False), params, 2, C, K, MAXDEPTH,
        MAX_CHANGE, jnp.float64, wsched, *args, True, True, interpret=True)
    row = lambda a: jnp.asarray(a).reshape(1, C)  # noqa: E731
    mat = lambda a: jnp.asarray(a).T  # noqa: E731
    seed, i0 = 987654321, 33
    o = run(jnp.int32(seed), jnp.int32(i0), jnp.int32(0), jnp.asarray(q0.T),
            tuple(row(a) for a in step),
            (mat(metric[0]), mat(metric[1]), mat(metric[2]), row(metric[3]),
             mat(metric[4]), mat(metric[5]), row(metric[6])),
            jax.tree.leaves(params), wsched)
    want = {k: _to_port_layout(k, v) for k, v in o.items()}
    got = tnc.nuts_warmup_chunk_plain(
        seed, torch.as_tensor(q0), [torch.as_tensor(a) for a in step],
        [torch.as_tensor(a) for a in metric], K, MAXDEPTH, MAX_CHANGE,
        *args, True, True, wsched, tnc.plain_lpg(den_t), i0)
    assert set(got) == set(want)
    _compare(got, want, *tol)


def test_traced_plan_block_matches_pallas(momenta):
    den_j, den_t = _pair('quadratic', False)
    q0, var, eps = _chain_inputs()
    params = den_j.current_params()
    seed, chain_start = 2 ** 31 - 2, 1000
    run = jnpl.make_nuts_pallas(den_j.device_logp_and_grad(False), params,
                                2, C, MAXDEPTH, MAX_CHANGE, jnp.float64,
                                interpret=True)
    o = run(jnp.int32(seed), jnp.int32(chain_start), jnp.asarray(q0.T),
            jnp.asarray(var.T), jnp.asarray(eps), jax.tree.leaves(params))
    want = {k: _to_port_layout(k, v) for k, v in o.items()}
    got = tnc.nuts_block_plain(seed, torch.as_tensor(q0),
                               torch.as_tensor(var), torch.as_tensor(eps),
                               MAXDEPTH, MAX_CHANGE, tnc.plain_lpg(den_t),
                               chain_start)
    assert set(got) == set(want)
    _compare(got, want, *momenta)


# ---------------------------------------------------------------------------
# A refit, and the routing

def _port_donut(order='quadratic', bound=False, seed=3):
    den, _ = _donut(bt, order, bound)
    den.fit(den.fun(_ring(40, seed, 0.4), original_space=True,
                    use_surrogate=False))
    den.use_surrogate = True
    return den


def test_refit_keeps_the_source_and_changes_the_parameters():
    """Two refits give one program and source and different packed
    parameters; the plan traced before any fit (zero coefficients, no
    decay yet) is the same program."""
    den, _ = _donut(bt, 'quadratic', False)
    den.use_surrogate = True
    src_0 = den.kernel_spec()['program'].source(torch.float64)
    den.fit(den.fun(_ring(40, 3, 0.4), original_space=True,
                    use_surrogate=False))
    spec_1, key_1 = den.kernel_spec(), den.kernel_spec_key()
    assert spec_1['program'].source(torch.float64) == src_0
    den.fit(den.fun(_ring(40, 9, 0.6), original_space=True,
                    use_surrogate=False))
    spec_2, key_2 = den.kernel_spec(), den.kernel_spec_key()
    p1, p2 = spec_1['program'], spec_2['program']
    assert p1 is p2               # the trace is kept: no new make_fx
    for dt in (torch.float32, torch.float64):
        assert traced_path(p1.source(dt)) == traced_path(p2.source(dt))
    assert key_1 != key_2
    assert spec_1['params'][0].shape == spec_2['params'][0].shape
    assert not torch.equal(spec_1['params'][0], spec_2['params'][0])
    # the launch spec follows the refit
    like = torch.zeros(3, 2, dtype=torch.float64)
    assert torch.equal(tnc._spec_for(den, like)[2], spec_2['params'][0])


def _short_trace():
    return bt.NTrace(n_chain=4, n_iter=16, n_warmup=8, random_generator=4,
                     x_0=_ring(4, 2, 0.3))


def test_donut_plan_samples_on_the_kernels_path():
    den = _port_donut()
    tconfig.set_nuts_kernel('auto')
    n0 = ttree.nuts_transition_batched.transitions
    with warnings.catch_warnings():
        warnings.filterwarnings('error', message='.*does not trace')
        tt = bt.sample(den, _short_trace(), verbose=False)
    assert ttree.nuts_transition_batched.transitions == n0
    assert np.isfinite(tt.get()).all()
    assert tt.trace._driver_cache[1].uses_kernels(tt.trace._carry.metric)


def _abs_donut():
    """The donut with ``f_1`` through ``abs``, outside the op set."""
    den = _port_donut()
    den.module_list[1] = bt.Module(
        fun=lambda m: -torch.abs(m - A_R) ** 2 / B_R, input_vars='m',
        output_vars='logp')
    return den


def test_untraceable_plan_warns_once_and_takes_the_tree_loop():
    den = _abs_donut()
    assert not den.has_kernel_spec
    assert 'aten.abs' in den.kernel_trace_error()
    tconfig.set_nuts_kernel('auto')
    n0 = ttree.nuts_transition_batched.transitions
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter('always')
        tt = bt.sample(den, _short_trace(), verbose=False, n_update=4)
    mine = [w for w in rec if 'does not trace' in str(w.message)]
    assert len(mine) == 1 and issubclass(mine[0].category, RuntimeWarning)
    assert 'aten.abs' in str(mine[0].message)
    assert ttree.nuts_transition_batched.transitions - n0 == 16
    assert np.isfinite(tt.get()).all()
    tconfig.set_nuts_kernel('cuda')
    try:
        with pytest.raises(NotImplementedError, match='aten.abs'):
            bt.sample(den, _short_trace(), verbose=False)
    finally:
        tconfig.set_nuts_kernel('auto')


def test_external_module_in_the_plan_does_not_trace():
    """The true model of a plan as a host module: the plan has no kernel
    spec, and the reason names it."""
    den = _port_donut()
    den.module_list[0] = bt.Module(
        fun=lambda x: np.linalg.norm(x), input_vars='x', output_vars='m',
        output_shapes=[1], traceable=False, label='f_0 on the host')
    den.use_surrogate = False
    prog = den._program()
    assert isinstance(prog, TraceError) and 'external' in str(prog)
    assert 'f_0 on the host' in den.kernel_trace_error()
    assert not den.has_kernel_spec
    assert 'external' in tnc.kernel_refusal(den, 2)
    den.use_surrogate = True       # the surrogate replaces it: traces
    assert den.has_traced_spec


_BIG_IDX = torch.arange(20000) % 4
_WIDE = torch.as_tensor(np.random.default_rng(2).normal(size=(4, 4000)))


@pytest.mark.parametrize('fn,what', [
    (lambda x: torch.sum(x[_BIG_IDX] ** 2), 'constant memory'),
    (lambda x: torch.sum(torch.exp(0.01 * (x @ _WIDE))), 'shared memory'),
], ids=['constant_memory', 'shared_memory'])
def test_program_past_the_kernels_memory_raises(fn, what):
    with pytest.raises(TraceError, match=what):
        trace_density(fn, 4, torch.float64)
    den = bt.DensityLite(logp=fn, input_size=4)
    assert not den.has_kernel_spec and what in den.kernel_trace_error()
