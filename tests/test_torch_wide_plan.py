"""A ``Density`` plan past D = 64 on the CUDA NUTS kernels' route, on the
CPU: the compiled-in ``PolyGaussian`` at NE = 3..8 dimensions a lane (a
unit of one lane width, dtype and path, ``csrc/nuts_poly.cuh``; its
Hessians read from device memory, not staged) and a traced plan up to D =
256.

* The port's plain frozen chunk, warmup chunk and block transition over
  the compiled-in ``PolyGaussian`` plan of a DES-like Density at D = 72
  (NE = 3) and D = 100 (NE = 4), a 24-dim data vector, quadratic response
  in 3 parameters, bound and decay on (two chains start beyond the bound,
  one diverges), against ``make_nuts_pallas_multi`` / ``_warmup`` /
  ``make_nuts_pallas`` in interpret mode over the JAX
  ``Density.device_logp_and_grad``: 8 chains, K = 2, depth 5, the same
  int32 seed, as ``tests/test_torch_plan_trace.py`` holds the traced
  donut plan. Tolerances are ``tests/test_torch_nuts_kernel.py``'s: tree
  statistics exactly equal; floats to rtol 1e-6, atol 1e-8 with both
  packages' own float32 Box-Muller, 1e-9 / 1e-10 with the same correctly
  rounded one on both sides; and, as ``tests/test_torch_anchors.py``
  compares, an atol of rtol times each output's largest magnitude: a
  transformed position near 0 carries the absolute error that an ulp of a
  float32 momentum (XLA's float32 log and cos are not correctly rounded)
  grows into along the trajectory.
* Hoffman & Gelman's MVN-250 written as a ``Density`` plan (one traced
  module) takes the kernels, and its plain transitions equal, bit for
  bit, those of the same logp on the ``DensityLite`` route.
* A small wide Recipe in both packages, as ``tests/test_torch_recipe.py``
  holds D = 6: D = 70, quadratic on 3, 8 chains, its second SampleStep
  pooled, depth 5. The data vector has 96 outputs: with fewer outputs than
  parameters the posterior would be flat up to the bounds in the rest, and
  the trees run to their depth. n_call is equal; the IS-weighted means,
  in units of the analytic posterior sigma, agree in their RMS over the
  dimensions within three times the combined Monte Carlo error measured
  over two of the port's runs; the pooled step adapts one (D,) metric and
  no transition takes the tree loop.
* ``poly_smem_plan`` at the wide Recipe's shape (D = 100, M = 457, F =
  146) in float32 and float64: the Hessians off the staged layout, the
  coefficients streamed through tiles, the plan within a block's shared
  memory; the generated units at every NE = 3..8.
* The routing: ``kernel_refusal`` is None at D = 65 and 256 for both plan
  kinds and names the limit at 257; the wide Recipe's Density takes the
  compiled-in ``PolyGaussian`` at D = 100.
* The new modules import no JAX.
"""

import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesfast_tpu as bf
from bayesfast_tpu.modules import (Gaussian as JGaussian,
                                   PolyConfig as JConfig, PolyModel as JPoly)
from bayesfast_tpu.samplers import nuts_pallas as jnpl
import bayesfast_tpu_torch as bt
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.examples import wide_recipe as wr
from bayesfast_tpu_torch.examples.wide_gaussians import mvn_250
from bayesfast_tpu_torch.interop import (density_decay_from_numpy,
                                         poly_from_numpy)
from bayesfast_tpu_torch.modules import Gaussian, PolyConfig, PolyModel
from bayesfast_tpu_torch.samplers import nuts as ttree
from bayesfast_tpu_torch.samplers import nuts_cuda as tnc
from test_torch_anchors import _compare
from test_torch_nuts_kernel import (_to_port_layout, momenta,  # noqa
                                    use_rounded_momenta)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, NL, TRUTH = 24, np.arange(3), 0.1
C, K, MAXDEPTH, MAX_CHANGE = 8, 2, 5, 1000.


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU,
    in float64."""
    old = tconfig.set_device('cpu')
    old_dtype = tconfig.get_dtype()
    tconfig.set_dtype(torch.float64)
    yield
    tconfig.set_device(old)
    tconfig.set_dtype(old_dtype)


# ---------------------------------------------------------------------------
# The compiled-in PolyGaussian plan against the Pallas kernels

def _density(pkg, dim, forward, data):
    """The DES-like Density of one package (``bf`` or ``bt``) at ``dim``
    parameters, a linear + quadratic-on-3 surrogate attached."""
    J = pkg is bf
    Gauss, Conf, Poly = ((JGaussian, JConfig, JPoly) if J
                         else (Gaussian, PolyConfig, PolyModel))
    model = pkg.Module(fun=forward, input_vars='x', output_vars='m',
                       input_shapes=[dim], output_shapes=[M],
                       traceable=False)
    like = Gauss(mean=data, cov=np.full(M, 0.05), input_vars='m',
                 output_vars='logp')
    den = pkg.Density(density_name='logp', module_list=[model, like],
                      input_vars='x', input_shapes=[dim],
                      input_scales=np.stack([np.full(dim, -5.),
                                             np.full(dim, 5.)]).T,
                      hard_bounds=True, decay_options={'use_decay': True})
    su = Poly([Conf('linear'), Conf('quadratic', input_mask=NL)],
              input_size=dim, output_size=M, input_vars='x',
              output_vars='m')
    den.surrogate_list = [su]
    return den, su


def _fitted_pair(dim):
    """The JAX density fitted on seeded points around the truth, and the
    port's with the JAX surrogate and decay carried across; the surrogate
    on in both."""
    forward, data, _ = wr.make_model(dim, M, NL)
    den_j, su_j = _density(bf, dim, forward, data)
    x_fit = TRUTH + np.random.default_rng(1).normal(size=(2 * dim, dim)) * 0.3
    den_j.fit(den_j.fun(x_fit, original_space=True, use_surrogate=False))
    den_j.use_surrogate = True
    den_t, _ = _density(bt, dim, forward, data)
    den_t.surrogate_list = [poly_from_numpy(
        [(c.order, c.input_mask, c.output_mask, np.asarray(c._a))
         for c in su_j.configs], su_j._mu, su_j._hess, su_j._alpha,
        su_j._f_mu, None, input_size=dim, output_size=M, input_vars='x',
        output_vars='m')]
    density_decay_from_numpy(den_t, den_j._mu, den_j._hess,
                             den_j._alpha_2_val)
    den_t.use_surrogate = True
    assert den_t.kernel_spec()['density'] == 'poly_gaussian'
    return den_j, den_t


def _chain_inputs(den_j, dim):
    rng = np.random.default_rng(4)
    xo = TRUTH + rng.normal(size=(C, dim)) * 0.3
    xo[:2] += 2.0                       # two chains start beyond the bound
    q0 = np.asarray(den_j.from_original(xo))
    var = np.exp(rng.normal(size=(C, dim)) * 0.2) * 1e-3
    eps = np.exp(rng.normal(size=C) * 0.3) * 0.3
    eps[0] *= 30.0                      # one chain diverges
    return q0, var, eps


DIMS = [pytest.param(72, id='ne3'), pytest.param(100, id='ne4')]


@pytest.mark.parametrize('dim', DIMS)
def test_poly_plan_frozen_chunk_matches_pallas(dim, momenta):
    den_j, den_t = _fitted_pair(dim)
    q0, var, eps = _chain_inputs(den_j, dim)
    params = den_j.current_params()
    run = jnpl.make_nuts_pallas_multi(
        den_j.device_logp_and_grad(False), params, dim, C, K, MAXDEPTH,
        MAX_CHANGE, jnp.float64, interpret=True)
    seed, i0 = 123456789, 5
    o = run(jnp.int32(seed), jnp.int32(i0), jnp.int32(0),
            jnp.asarray(q0.T), jnp.asarray(var.T), jnp.asarray(eps)[None],
            jax.tree.leaves(params))
    want = {k: _to_port_layout(k, v) for k, v in o.items()}
    got = tnc.nuts_chunk_plain(
        seed, torch.as_tensor(q0), torch.as_tensor(var),
        torch.as_tensor(eps), K, MAXDEPTH, MAX_CHANGE, tnc.plain_lpg(den_t),
        i0)
    _compare(got, want, *momenta)
    assert want['diverging'].any() and (want['tree_depth'] > 1).any()


@pytest.mark.parametrize('dim', DIMS)
def test_poly_plan_warmup_chunk_matches_pallas(dim, monkeypatch):
    tol = use_rounded_momenta(monkeypatch)
    den_j, den_t = _fitted_pair(dim)
    q0, var, eps = _chain_inputs(den_j, dim)
    eps[0] /= 30.0
    rng = np.random.default_rng(5)
    log_step = np.log(eps)
    step = (log_step, log_step + 0.1, rng.normal(size=C) * 0.01,
            np.full(C, 5.0), np.log(10 * eps))
    metric = (var, q0 + rng.normal(size=(C, dim)) * 0.01, var * 10.0,
              np.full(C, 10.0), q0, var * 3.0, np.full(C, 3.0))
    # a refresh and a window switch inside the chunk
    wsched, _ = jnpl._window_schedule(4, 0, 5, K, 1, True)
    assert wsched[0].any() and wsched[1].any()
    args = (0.8, 0.05, 0.75, 10.)
    params = den_j.current_params()
    run = jnpl.make_nuts_pallas_warmup(
        den_j.device_logp_and_grad(False), params, dim, C, K, MAXDEPTH,
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


@pytest.mark.parametrize('dim', DIMS)
def test_poly_plan_block_matches_pallas(dim, momenta):
    den_j, den_t = _fitted_pair(dim)
    q0, var, eps = _chain_inputs(den_j, dim)
    params = den_j.current_params()
    seed, chain_start = 2 ** 31 - 2, 1000
    run = jnpl.make_nuts_pallas(den_j.device_logp_and_grad(False), params,
                                dim, C, MAXDEPTH, MAX_CHANGE, jnp.float64,
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
    assert want['diverging'].any()


# ---------------------------------------------------------------------------
# A traced plan at D = 250

def _mvn_plan():
    """MVN-250's logp as the one module of a Density plan, and the same
    logp on the DensityLite route."""
    den_l, info = mvn_250()
    P = torch.as_tensor(info['P'])
    den = bt.Density(density_name='logp', module_list=[bt.Module(
        fun=lambda x: -0.5 * torch.sum((x @ P.to(x)) * x, dim=-1),
        input_vars='x', output_vars='logp')], input_vars='x',
        input_shapes=[250])
    return den, den_l, info['P']


@pytest.mark.parametrize('kind', ['frozen', 'block'])
def test_traced_mvn_plan_equals_the_logp_route(kind):
    den, den_l, P = _mvn_plan()
    assert tnc.kernel_refusal(den, 250) is None and den.has_traced_spec
    spec = den.kernel_spec()
    assert spec['density'] == 'traced' and spec['program'].D == 250
    rng = np.random.default_rng(4)
    q0 = torch.as_tensor(np.linalg.solve(np.linalg.cholesky(P).T,
                                         rng.normal(size=(250, 4))).T)
    var = torch.as_tensor(np.exp(rng.normal(size=(4, 250)) * 0.2)
                          / np.diag(P))
    eps = torch.as_tensor(np.exp(rng.normal(size=4) * 0.3) * 0.03)
    eps[0] *= 80.0
    outs = []
    for d in (den, den_l):
        if kind == 'frozen':
            outs.append(tnc.nuts_chunk_plain(7, q0, var, eps, 2, MAXDEPTH,
                                             MAX_CHANGE, tnc.plain_lpg(d),
                                             3))
        else:
            outs.append(tnc.nuts_block_plain(7, q0, var, eps, MAXDEPTH,
                                             MAX_CHANGE, tnc.plain_lpg(d)))
    assert set(outs[0]) == set(outs[1])
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k
    assert (outs[0]['tree_depth'] > 2).any()


# ---------------------------------------------------------------------------
# A small wide Recipe in both packages

W_D, W_M = 70, 96
W_TRACE = {'n_iter': 50, 'n_warmup': 25, 'max_treedepth': 5}
W_N_IS = 100
W_SEEDS = (27, 28)   # the port's runs (the JAX run takes the first)


def _jax_recipe():
    """``wide_recipe.build``'s Recipe, written for the JAX package."""
    forward, data, _ = wr.make_model(W_D, W_M, NL)
    model = bf.Module(fun=forward, input_vars='x', output_vars='m',
                      input_shapes=[W_D], output_shapes=[W_M],
                      traceable=False)
    like = JGaussian(mean=data, cov=np.full(W_M, 0.05), input_vars='m',
                     output_vars='logp')
    den = bf.Density(density_name='logp', module_list=[model, like],
                     input_vars='x', input_shapes=[W_D],
                     input_scales=np.stack([np.full(W_D, -5.),
                                            np.full(W_D, 5.)]).T,
                     hard_bounds=True, decay_options={'use_decay': True})
    s0 = JPoly('linear', input_size=W_D, output_size=W_M, input_vars='x',
               output_vars='m')
    opt = bf.recipe.OptimizeStep(surrogate_list=s0, alpha_n=2, max_iter=2,
                                 sample_trace=dict(W_TRACE, n_chain=8))
    sam = [bf.recipe.SampleStep(
        surrogate_list=JPoly([JConfig('linear'),
                              JConfig('quadratic', input_mask=NL)],
                             input_size=W_D, output_size=W_M,
                             input_vars='x', output_vars='m'),
        alpha_n=2, reuse_samples=1, logp_cutoff=False,
        sample_trace=dict(W_TRACE, n_chain=8, pooled_metric=i == 1))
        for i in range(2)]
    post = bf.recipe.PostStep(n_is=W_N_IS, k_trunc=0.25)
    return bf.Recipe(density=den, optimize=opt, sample=sam, post=post)


def _port_recipe():
    return wr.build(W_D, W_M, NL, n_chain=8, traces=(W_TRACE, W_TRACE),
                    n_is=W_N_IS, optimize_options={'max_iter': 2},
                    sample_options={'logp_cutoff': False})


def _run_quiet(rec):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        rec.run()
    return rec


def test_wide_recipe_matches_jax():
    old = bf.config.get_nuts_kernel()
    bf.config.set_nuts_kernel('xla')
    try:
        bf.utils.set_generator(W_SEEDS[0])
        rj = _run_quiet(_jax_recipe())
    finally:
        bf.config.set_nuts_kernel(old)
    runs = []
    ttree.nuts_transition_batched.transitions = 0
    for seed in W_SEEDS:
        bt.utils.set_generator(seed)
        runs.append(_run_quiet(_port_recipe()))
    assert ttree.nuts_transition_batched.transitions == 0
    rt = runs[0]
    # the pooled step adapted one shared (D,) metric on the block path
    last = rt.recipe_trace.results.sample[-1].sample_trace.trace
    assert last.pooled_metric and not rt.recipe_trace.results.sample[
        0].sample_trace.trace.pooled_metric
    assert tuple(last._carry.metric.var.shape) == (W_D,)
    assert rt.density.kernel_spec()['density'] == 'poly_gaussian'
    res_j, res_t = rj.get(), rt.get()
    assert res_t.n_call == res_j.n_call
    assert all(r.get().n_call == res_j.n_call for r in runs)
    assert rt.recipe_trace.finished == (True, True, True)
    assert res_t.samples.shape == res_j.samples.shape == (W_N_IS, W_D)
    assert np.all(np.isfinite(res_t.weights)) and np.all(res_t.weights > 0)
    # The Monte Carlo error of one run's weighted mean, in units of each
    # dimension's posterior sigma, measured over the port's runs and pooled
    # over the dimensions (tests/test_torch_recipe.py measures it so, in
    # the parameters' units, at D = 6). At D = 70 a run's error is heavy
    # tailed and shared by many dimensions (its IS weights move the
    # nonlinear directions together), so the statistic is the RMS over the
    # dimensions of the sigma-normalized difference: over six seeds of the
    # port alone, one run against another (or the mean of two) with the
    # error from two more, it reached 2.3 times its expected value.
    sigma = wr.analytic_sigma(W_D, W_M, NL)
    means = np.stack([wr.weighted_mean(r) for r in runs]) / sigma
    err = np.sqrt(np.mean(means.var(axis=0, ddof=1)))
    m_j = wr.weighted_mean(rj) / sigma

    def rms(a):
        return np.sqrt(np.mean(a ** 2))

    assert rms(means[0] - m_j) < 3 * np.sqrt(2.0) * err, (means, m_j, err)
    assert (rms(means.mean(0) - m_j)
            < 3 * np.sqrt(1.0 + 1.0 / len(W_SEEDS)) * err)


# ---------------------------------------------------------------------------
# The shared-memory plan and the units

# the wide Recipe's sample-step surrogate: 101 linear and 45 quadratic
# features, a sparse-row entry a linear feature and two a quadratic one
WIDE = dict(D=100, M=457, F=146, NNZ=100 + 2 * 45)


@pytest.mark.parametrize('itemsize,tile', [(4, 32), (8, 16)],
                         ids=['float32', 'float64'])
def test_wide_recipe_plan_streams_with_the_hessians_off(itemsize, tile):
    """At the wide Recipe's shape the Hessians stay in device memory, and
    WT streams through two tiles of the dtype's width beside as many
    staged features as fit, within a block's shared memory; with the
    Hessians staged (2 P (P + 16 / itemsize) values) not even the tiles
    would fit beside the density's own buffers."""
    plan = tnc.poly_smem_plan(WIDE['D'], WIDE['M'], WIDE['F'], WIDE['NNZ'],
                              False, 10, itemsize)
    assert plan['hess_smem'] is False
    assert plan['stream'] and plan['tile'] == tile
    assert plan['bytes'] <= tnc._MAX_SMEM
    n = 16 // itemsize
    assert 0 < plan['rows'] < WIDE['F'] and plan['rows'] % n == 0
    hess = 2 * 128 * (128 + n) * itemsize
    no_rows = tnc._poly_layout(WIDE['D'], WIDE['M'], WIDE['F'], WIDE['NNZ'],
                               False, 10, itemsize, 0, tile)
    assert no_rows['bytes'] + hess > tnc._MAX_SMEM
    # the next vector of staged features would not fit
    more = tnc._poly_layout(WIDE['D'], WIDE['M'], WIDE['F'], WIDE['NNZ'],
                            False, 10, itemsize, plan['rows'] + n, tile)
    assert more['bytes'] > tnc._MAX_SMEM
    # the launch passes the plan's bytes, which count no Hessian, and the
    # streamed path
    f = tnc._fargs(1000., 0., (0., 0., WIDE['M'], WIDE['F'], WIDE['NNZ'], 1,
                               1, 1., 1., 0), (0.8, 0.05, 0.75, 10.), plan)
    assert f[16:] == [float(plan['rows']), float(plan['bytes']), 0.0, 1.0,
                      float(tile), float(plan['tile_bytes'])]


def test_hessians_stay_staged_at_64():
    """At D <= 64 (csrc/nuts.cu's library, NE <= 2) the Hessians stay
    staged (the plan as before: no ``hess_smem`` key), and the layout's
    bytes count them."""
    for D in (27, 64):
        plan = tnc.poly_smem_plan(D, 457, 73, 27 + 2 * 45, False, 10, 4)
        assert 'hess_smem' not in plan
        P = 32 * -(-D // 32)
        lay = tnc._poly_layout(D, 457, 73, 117, False, 10, 4, plan['rows'],
                               plan.get('tile', 0))
        assert lay == plan and lay['bytes'] >= 2 * P * (P + 4) * 4


@pytest.mark.parametrize('ne', range(3, 9))
def test_poly_units_at_every_lane_width(ne):
    """One unit a (NE, dtype, path): its entry point instantiates
    ``launch_poly_unit`` with them, from ``nuts_poly.cuh``; D <= 64 and
    D > 256 have none."""
    for dt, real in ((torch.float32, 'float'), (torch.float64, 'double')):
        for stream in (False, True):
            src = tnc.poly_unit_source(32 * ne, dt, stream)
            path = 'true' if stream else 'false'
            assert f'launch_poly_unit<{real}, {ne}, {path}>(' in src
            assert '#include "nuts_poly.cuh"' in src
            assert 'extern "C" int nuts_traced_launch(' in src
            assert src == tnc.poly_unit_source(32 * ne - 31, dt, stream)
    for bad in (64, 257):
        with pytest.raises(ValueError):
            tnc.poly_unit_source(bad, torch.float32, False)


# ---------------------------------------------------------------------------
# Routing

def _poly_plan(D):
    """A Density whose plan is a linear PolyModel then a Gaussian at D."""
    n_out = 3
    su = PolyModel([PolyConfig('linear')], input_size=D, output_size=n_out,
                   input_vars='x', output_vars='m')
    su.configs[0]._a = np.random.default_rng(0).normal(
        size=(n_out, su.configs[0].n_features))
    like = Gaussian(mean=np.zeros(n_out), cov=np.ones(n_out),
                    input_vars='m', output_vars='logp')
    model = bt.Module(fun=lambda x: x[..., :n_out], input_vars='x',
                      output_vars='m')
    return bt.Density(density_name='logp', module_list=[model, like],
                      surrogate_list=[su], input_vars='x',
                      input_shapes=[D], use_surrogate=True)


def _traced_plan(D):
    """A Density whose plan is one traced module at D."""
    return bt.Density(density_name='logp', module_list=[bt.Module(
        fun=lambda x: -0.5 * torch.sum(x * x, -1), input_vars='x',
        output_vars='logp')], input_vars='x', input_shapes=[D])


@pytest.mark.parametrize('make', [_poly_plan, _traced_plan],
                         ids=['poly_gaussian', 'traced_plan'])
def test_a_density_plan_takes_the_kernels_to_256(make):
    """A Density plan takes the kernels past D = 64 up to 256 (the
    compiled-in PolyGaussian and a traced plan alike), and says so past
    it."""
    for D in (65, 256):
        den = make(D)
        assert tnc.kernel_refusal(den, D) is None
        kind = den.kernel_spec()['density']
        assert kind == ('poly_gaussian' if make is _poly_plan else 'traced')
    den = make(257)
    why = tnc.kernel_refusal(den, 257)
    assert 'Density plan' in why and 'D <= 256' in why and '257' in why


def test_wide_recipe_density_takes_the_compiled_in_poly_gaussian():
    """The wide Recipe's Density with its sample-step surrogate fitted and
    on: the compiled-in PolyGaussian at D = 100, F = 146, bound and decay
    on."""
    rec = wr.build(n_chain=8)
    den = rec.density
    den.surrogate_list = [wr.make_surrogate()]
    x_fit = TRUTH + np.random.default_rng(1).normal(size=(300, wr.D)) * 0.05
    den.fit(den.fun(x_fit, original_space=True, use_surrogate=False))
    den.use_surrogate = True
    assert tnc.kernel_refusal(den, wr.D) is None
    spec = den.kernel_spec()
    assert spec['density'] == 'poly_gaussian' and spec['dim'] == 100
    assert tuple(spec['scalars'][2:7]) == (457, 146, 190, 1, 1)
    sigma = wr.analytic_sigma()
    assert sigma.shape == (100,) and np.all((sigma > 0.05) & (sigma < 0.5))


def test_new_modules_import_no_jax():
    """The wide Recipe, the wrappers and the pipeline, imported in a fresh
    interpreter, load nothing of JAX or of the JAX package."""
    code = ('import sys; import bayesfast_tpu_torch.examples.wide_recipe, '
            'bayesfast_tpu_torch.samplers.nuts_cuda, '
            'bayesfast_tpu_torch.core.pipeline; '
            'bad = [m for m in sys.modules if m == "jax" or '
            'm.startswith("jax.") or m == "bayesfast_tpu" or '
            'm.startswith("bayesfast_tpu.")]; '
            'print(bad); sys.exit(1 if bad else 0)')
    env = dict(os.environ, PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, '-c', code], env=env, cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
