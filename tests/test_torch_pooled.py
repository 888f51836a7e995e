"""Pooled-metric NUTS and the full metric in the port against the JAX
package.

(a) ``ChainDriver.run`` with ``pooled_metric=True`` for six warmup
transitions against a JAX reference composed of its public pieces with the
same per-transition seeds: ``make_nuts_pallas(...).run`` in interpret mode,
then ``update_step_size``, then ``update_metric_pooled``. As in the
adapting chunk test of ``test_torch_nuts_kernel.py``, both sides draw one
correctly rounded Box-Muller: tree statistics equal, floats to rtol 1e-9
(energies to 1e-9 of the energy scale). (b) ``sample`` with a pooled metric: a twin of
the JAX package's ``test_pooled_diag_sampling``. (c) ``metric='full'`` and
2-D metric arrays build a ``FullMetricState`` (the JAX package's
``_init_carry`` and ``_find_reasonable_step``), and the full-metric step
probe matches JAX's given JAX's momenta.
"""

import importlib
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bayesfast_tpu as bf
import bayesfast_tpu_torch as bt
from bayesfast_tpu.samplers import metrics as jm
from bayesfast_tpu.samplers import nuts_pallas as jnpl
from bayesfast_tpu.samplers import step_size as jss
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch import interop
from bayesfast_tpu_torch.ops.densities import DiagGaussian
from bayesfast_tpu_torch.samplers import chain as tchain
from bayesfast_tpu_torch.samplers import metrics as tm
from bayesfast_tpu_torch.samplers import nuts_cuda as tnc
from test_torch_nuts_kernel import (MAX_CHANGE, MAXDEPTH, _setup,
                                    _to_port_layout, use_rounded_momenta)
from test_torch_sample import _gauss_pair

jsample = importlib.import_module('bayesfast_tpu.core.sample')
tsample = importlib.import_module('bayesfast_tpu_torch.core.sample')


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


ADAPT = dict(target=0.8, gamma=0.05, k=0.75, t_0=10.)


def _compare_rows(got, want, rtol, atol):
    """``test_torch_nuts_kernel._compare``, with the energy held like the
    energy differences (to the energy scale): an energy that happens to lie
    near zero carries the absolute error of its trajectory."""
    escale = np.abs(want['energy']).max()
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape, k
        if k in ('tree_depth', 'tree_size', 'diverging'):
            assert np.array_equal(g, w), k
        else:
            a = atol + (rtol * escale if k in ('energy', 'energy_change',
                                               'max_de') else 0.)
            np.testing.assert_allclose(g, w, rtol=rtol, atol=a, err_msg=k)


def test_pooled_run_matches_jax_pieces(monkeypatch):
    # one correctly rounded Box-Muller on both sides, as the adapting chunk
    # test does: over six transitions the pooled metric couples the chains,
    # so with each side's own float32 momenta an ulp of one chain's momentum
    # reaches every chain, and a diverging leaf's energy error grows past
    # rtol 1e-6 (the block test holds the real momenta for one transition)
    momenta = use_rounded_momenta(monkeypatch)
    den_j, den_t, q0, var, eps = _setup()
    C, D = q0.shape
    eps[:2] /= 40.0
    eps *= 0.1
    n_steps, seed = 6, 86420
    # one shared metric from the mean of the starts, windows of 2
    mj = jm.init_diag_metric(jnp.asarray(q0.mean(0)),
                             jnp.asarray(var.mean(0)), 10., 2)
    # a mid-warmup step state (count 5, hbar at its fixed point for the
    # current step plus noise), so the steps move by tens of percent, not
    # the tenfold jump of a fresh state that sends every chain diverging
    rng = np.random.default_rng(4)
    count, log_eps = 5.0, np.log(eps)
    hbar = (np.log(10.0) * ADAPT['gamma'] / np.sqrt(count)
            + rng.normal(size=C) * 0.002)
    zero = np.zeros(C)
    sj = jss.StepSizeState(*(jnp.asarray(a) for a in (
        log_eps, log_eps + 0.05, hbar, np.full(C, count),
        log_eps + np.log(10.0), zero, zero)))
    carry = interop.carry_from_numpy(seed, q0, jax.tree.map(np.asarray, sj),
                                     jax.tree.map(np.asarray, mj),
                                     torch.float64, 'cpu')
    drv = tchain.ChainDriver(den_t, max_treedepth=MAXDEPTH, pooled_metric=True)
    ct, (qt, (st, et)) = drv.run(carry, [True] * n_steps)

    run = jnpl.make_nuts_pallas(den_j.device_logp_and_grad(False), (), D, C,
                                MAXDEPTH, MAX_CHANGE, jnp.float64,
                                interpret=True)
    q = jnp.asarray(q0)
    for t in range(n_steps):
        seed_t = np.array(tnc._transition_seed(seed, 0, t),
                          np.uint32).view(np.int32)
        var_t = jnp.broadcast_to(mj.var[:, None], (D, C))
        o = run(jnp.int32(seed_t), jnp.int32(0), q.T, var_t,
                jnp.exp(sj.log_step), [])
        want = {k: _to_port_layout(k, v) for k, v in o.items()}
        q = jnp.asarray(want['q'])
        accept = want['accept_sum'] / np.maximum(want['tree_size'], 1)
        sj = jss.update_step_size(sj, jnp.asarray(accept), True, **ADAPT)
        mj = jm.update_metric_pooled(mj, q, True, 1, True)
        got = {'q': qt[t], 'tree_depth': st.tree_depth[t],
               'tree_size': st.tree_size[t],
               'diverging': st.diverging[t].int(), 'logp': st.logp[t],
               'energy': st.energy[t], 'energy_change': st.energy_change[t],
               'max_de': st.max_energy_change[t],
               'accept_sum': st.mean_tree_accept[t]
               * st.tree_size[t].clamp(min=1),
               'step_size': et['step_size'][t],
               'step_size_bar': et['step_size_bar'][t]}
        want.update(step_size=np.exp(np.asarray(sj.log_step)),
                    step_size_bar=np.exp(np.asarray(sj.log_bar)))
        _compare_rows(got, want, *momenta)
    assert et['warmup'].all()
    # the final carry: per-chain step state, the one shared metric
    got = {f: getattr(ct.step, f) for f in ('log_step', 'log_bar', 'hbar',
                                             'count')}
    got.update(var=ct.metric.var, fg_mean=ct.metric.fg.mean,
               fg_raw=ct.metric.fg.raw, fg_w=ct.metric.fg.weight,
               bg_mean=ct.metric.bg.mean, bg_raw=ct.metric.bg.raw)
    want = {f: np.asarray(getattr(sj, f)) for f in ('log_step', 'log_bar',
                                                     'hbar', 'count')}
    want.update(var=mj.var, fg_mean=mj.fg.mean, fg_raw=mj.fg.raw,
                fg_w=mj.fg.weight, bg_mean=mj.bg.mean, bg_raw=mj.bg.raw)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w),
                                   rtol=momenta[0], atol=momenta[1],
                                   err_msg=k)
    assert tuple(ct.metric.var.shape) == (D,)
    # one window switch (at the third transition, window 2 -> 4)
    ints = (ct.metric.n_samples, ct.metric.prev_update,
            ct.metric.adapt_window)
    assert ints == (6, 2, 4)
    assert ints == tuple(int(getattr(mj, f)) for f in (
        'n_samples', 'prev_update', 'adapt_window'))
    # the plain versions called directly ('torch') are the wrapper's
    drv_t = tchain.ChainDriver(den_t, max_treedepth=MAXDEPTH,
                               pooled_metric=True, nuts_kernel='torch')
    c2, (q2, _) = drv_t.run(carry, [True] * 2)
    assert torch.equal(q2, qt[:2])


def test_pooled_diag_sampling():
    """Twin of the JAX package's test: a short warmup with pooled
    adaptation still finds per-dimension scales two decades apart."""
    rng = np.random.default_rng(3)
    scales = 10.0 ** rng.uniform(-1, 1, 6)
    den = bt.DensityLite(logp=DiagGaussian(np.zeros(6), scales ** 2),
                         input_size=6)
    tr = bt.NTrace(n_chain=32, n_iter=700, n_warmup=300, pooled_metric=True,
                   random_generator=4)
    n0 = tnc.nuts_transition_batched.launches
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        tt = bt.sample(den, tr, verbose=False)
    s = tt.get(flatten=True)
    assert np.allclose(s.std(axis=0), scales, rtol=0.15)
    var = tt.trace._carry.metric.var.numpy()
    assert var.shape == (6,)
    assert np.allclose(np.sqrt(var), scales, rtol=0.25)
    # CPU tensors: the plain block version, no kernel launch
    assert tnc.nuts_transition_batched.launches == n0
    st = tt.trace._stats_arrays
    assert st['warmup'][:, :300].all() and not st['warmup'][:, 300:].any()
    # post-warmup transitions use the frozen averaged step size
    assert np.all(st['step_size_bar'][:, 300:] == st['step_size_bar'][:, -1:])


@pytest.mark.parametrize('metric,pooled', [('full', False), ('full', True),
                                           ('matrix', False)])
def test_full_metric_is_full(metric, pooled):
    """``metric='full'`` (and a (D, D) array) gives a ``FullMetricState``,
    per chain or shared, and samples through the tree loop; before the
    repair the port turned every string into a diag metric."""
    D, C = 4, 8
    mean, var, _, den_t = _gauss_pair(D)
    m = np.diag(var) * 1.5 if metric == 'matrix' else metric
    tr = bt.NTrace(n_chain=C, n_iter=40, n_warmup=20, metric=m,
                   pooled_metric=pooled, random_generator=2)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        tt = bt.sample(den_t, tr, verbose=False)
    ms = tt.trace._carry.metric
    assert isinstance(ms, tm.FullMetricState)
    assert tuple(ms.cov.shape) == ((D, D) if pooled else (C, D, D))
    assert torch.allclose(ms.chol @ ms.chol.mT, ms.cov)
    assert np.isfinite(tt.get()).all()
    assert tt.trace._stats_arrays['tree_size'].shape == (C, 40)


def test_full_metric_step_probe_matches_jax():
    """The full-metric branch of ``_find_reasonable_step``, given the JAX
    probe's own momenta, finds the same per-chain steps."""
    D, C = 4, 32
    _, var, den_j, den_t = _gauss_pair(D)
    cov = np.diag(var) + 0.1
    x0 = np.random.default_rng(0).normal(size=(C, D))
    tj = bf.NTrace(n_chain=C, n_iter=20, n_warmup=10, metric=cov,
                   random_generator=7)
    tt = bt.NTrace(n_chain=C, n_iter=20, n_warmup=10, metric=cov,
                   random_generator=7)
    key = jax.random.fold_in(tj.random_generator, 0xf1d)
    ms = jm.init_full_metric(jnp.zeros(D), jnp.asarray(cov))
    p0 = np.asarray(jm.sample_momentum_b(ms, key, (C, D), jnp.float64))
    step0 = 1.0 / D ** 0.25
    eps_j, ne_j = jsample._find_reasonable_step(den_j, x0, tj, jnp.float64,
                                                step0)
    eps_t, ne_t = tsample._find_reasonable_step(den_t, x0, tt, torch.float64,
                                                step0, p0=p0)
    assert ne_t == ne_j
    np.testing.assert_allclose(eps_t, eps_j, rtol=1e-12)
    # the pooled carry starts from the mean of the starts
    carry = tsample._init_carry(
        bt.NTrace(n_chain=C, metric='full', pooled_metric=True), x0,
        torch.float64, eps_t, 'cpu')
    np.testing.assert_allclose(carry.metric.fg.mean.numpy(), x0.mean(0),
                               rtol=1e-12)
    assert carry.step.log_step.shape == (C,)
