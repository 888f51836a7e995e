"""The port's tempered samplers (``samplers/tempered.py``) against the JAX
package.

(a) ``t_compute_state`` and ``t_leapfrog`` (a metric state) and their
``_t`` twins (the tree loop's metric payload; lane-minor in the JAX
package) on the same float64 inputs, diag and full: rtol 1e-12; ``_weight``
across delta = 0. (b) One THMC transition with the JAX side's draws
injected (the key splits at ``bayesfast_tpu/samplers/tempered.py:252-254``):
rtol 1e-10; the port's stats u, weight, logp and energy are the kept
state's, where the JAX package records the trajectory end's even on a
rejection (there the JAX start state's are the reference). (c) The JAX tests ``test_tnuts_weighted_moments`` and
``test_thmc_smoke`` through ``sample`` with their densities and
tolerances. (d) Each sampler in both packages on the same pair of
densities: importance-weighted means and variances (the weights
computed from the draws) within five standard errors of their
difference, each side's standard error from the smaller of the weights'
Kish ESS and the ``utils/acor.py`` ESS.
"""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bayesfast_tpu as bf
import bayesfast_tpu_torch as bt
from bayesfast_tpu.samplers import metrics as jm
from bayesfast_tpu.samplers import nuts as jnuts
from bayesfast_tpu.samplers import tempered as jt
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.samplers import nuts as tnuts
from bayesfast_tpu_torch.samplers import tempered as tt_
from bayesfast_tpu_torch.utils.acor import effective_sample_size
from test_torch_integration import (assert_state_close, lpg_j, lpg_t,
                                    metric_pair)


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


C, D = 6, 4


def lpgb_j(x):
    """The base density: the target's Gaussian four times wider."""
    lp, g = lpg_j(x)
    return 0.25 * lp - 0.3, 0.25 * g


def lpgb_t(x):
    lp, g = lpg_t(x)
    return 0.25 * lp - 0.3, 0.25 * g


def _lane_minor(lpg):
    def f(x_t):
        lp, g = jax.vmap(lpg)(x_t.T)
        return lp, g.T
    return f


def _inputs(rng):
    q, p = rng.normal(size=(C, D)), rng.normal(size=(C, D))
    u, vu = rng.normal(size=C) * 2, rng.normal(size=C)
    return q, p, u, vu


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _as_rows(sj):
    """A lane-minor JAX state with its (D, C) leaves turned to (C, D)."""
    return type(sj)(*[x.T if x.ndim == 2 else x for x in sj])


@pytest.mark.parametrize('kind', ['diag', 'full'])
def test_t_state_and_leapfrog_match_jax(kind):
    rng = np.random.default_rng(0)
    mj, mt = metric_pair(kind, False, rng)
    q, p, u, vu = _inputs(rng)
    eps = 0.21
    sj = jax.vmap(lambda *a: jt.t_compute_state(mj, lpg_j, lpgb_j, *a))(
        *map(jnp.asarray, (q, p, u, vu)))
    st = tt_.t_compute_state(mt, lpg_t, lpgb_t, *_t(q, p, u, vu))
    assert_state_close(st, sj, tt_.TState._fields)
    for _ in range(4):
        sj = jax.vmap(lambda s: jt.t_leapfrog(mj, lpg_j, lpgb_j, eps, s))(sj)
        st = tt_.t_leapfrog(mt, lpg_t, lpgb_t, eps, st)
    assert_state_close(st, sj, tt_.TState._fields)


@pytest.mark.parametrize('per_chain', [False, True])
@pytest.mark.parametrize('kind', ['diag', 'full'])
def test_lane_minor_twins_match_jax(kind, per_chain):
    rng = np.random.default_rng(1)
    mj, mt = metric_pair(kind, per_chain, rng)
    q, p, u, vu = _inputs(rng)
    eps = rng.uniform(-0.3, 0.3, C)
    mtj, mtt = jnuts._metric_t(mj), tnuts._metric_t(mt)
    lt, lb = _lane_minor(lpg_j), _lane_minor(lpgb_j)
    sj = jt.t_compute_state_t(mtj, lt, lb, jnp.asarray(q.T),
                              jnp.asarray(p.T), jnp.asarray(u),
                              jnp.asarray(vu))
    st = tt_.t_compute_state_t(mtt, lpg_t, lpgb_t, *_t(q, p, u, vu))
    assert_state_close(st, _as_rows(sj), tt_.TState._fields)
    for _ in range(4):
        sj = jt.t_leapfrog_t(mtj, lt, lb, jnp.asarray(eps), sj)
        st = tt_.t_leapfrog_t(mtt, lpg_t, lpgb_t, torch.as_tensor(eps), st)
    assert_state_close(st, _as_rows(sj), tt_.TState._fields)


def test_weight_near_zero_matches_jax():
    delta = np.array([0.0, 1e-13, -1e-13, 9.9e-13, 1.01e-12, -1.01e-12,
                      1e-9, -1e-6, 1e-3, 0.5, -3.0, 30.0, -30.0])
    want = np.asarray(jt._weight(jnp.asarray(delta)))
    got = tt_._weight(torch.as_tensor(delta)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert np.all(got[:3] == 1.0)


@pytest.mark.parametrize('max_change', [1000., 1.0])
@pytest.mark.parametrize('kind', ['diag', 'full'])
def test_thmc_transition_with_jax_draws(kind, max_change):
    n, n_int = 64, 6
    rng = np.random.default_rng(2)
    mj, mt = metric_pair(kind, False, rng)
    q0, u0 = rng.normal(size=(n, D)), rng.normal(size=n)
    eps = 0.5 if kind == 'diag' else 1.4
    keys = jax.random.split(jax.random.PRNGKey(5), n)
    qj, uj, sj = jax.vmap(lambda k, q, u: jt.thmc_transition(
        k, q, u, mj, eps, lpg_j, lpgb_j, n_int, max_change))(
        keys, jnp.asarray(q0), jnp.asarray(u0))

    def draws(key):
        _, k_mom, k_vu, k_acc = jax.random.split(key, 4)
        return (jm.sample_momentum(mj, k_mom),
                jax.random.normal(k_vu, (), jnp.float64),
                jax.random.uniform(k_acc))

    p0, vu0, u_acc = (np.array(a) for a in jax.vmap(draws)(keys))
    start = jax.vmap(lambda *a: jt.t_compute_state(mj, lpg_j, lpgb_j, *a))(
        *map(jnp.asarray, (q0, p0, u0, vu0)))
    sj = sj._replace(**{f: jnp.where(sj.accepted, getattr(sj, f),
                                     getattr(start, f))
                        for f in ('u', 'weight', 'logp', 'energy')})
    qt, ut, st = tt_.thmc_core(*_t(q0, u0, p0, vu0, u_acc), mt, eps, lpg_t,
                               lpgb_t, n_int, max_change)
    acc = np.asarray(sj.accepted)
    assert 0 < acc.sum() < n
    if max_change < 10:
        assert np.asarray(sj.diverging).any()
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-10,
                               atol=1e-12)
    for f in tt_.ThmcStats._fields:
        a, b = getattr(st, f).numpy(), np.asarray(getattr(sj, f))
        if a.dtype == bool or f == 'n_int_step':
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12,
                                       err_msg=f)


def _densities(dim=4):
    """The JAX tests' pair (``tests/test_tempered.py::_densities``): target
    variance 0.5, base variance 4, in both packages."""
    tv, bv = 0.5, 4.0
    pair_j = (bf.DensityLite(logp=lambda x: -0.5 * jnp.sum(x ** 2) / tv,
                             input_size=dim),
              bf.DensityLite(logp=lambda x: -0.5 * jnp.sum(x ** 2) / bv,
                             input_size=dim))
    pair_t = (bt.DensityLite(logp=lambda x: -0.5 * torch.sum(x ** 2, -1) / tv,
                             input_size=dim),
              bt.DensityLite(logp=lambda x: -0.5 * torch.sum(x ** 2, -1) / bv,
                             input_size=dim))
    return pair_j, pair_t, tv


def _run(pkg, pair, sampler, cfg):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        return pkg.sample(pair[0], dict(cfg, density_base=pair[1]),
                          sampler=sampler, verbose=False)


def weights_of(s, tv=0.5, bv=4.0):
    """The importance weights ``delta / expm1(delta)`` of draws ``s`` from
    the pair of ``_densities`` (``logxi`` 0), computed from the draws."""
    delta = 0.5 * np.sum(s ** 2, -1) * (1.0 / tv - 1.0 / bv)
    return delta / np.expm1(delta)


def weighted_moments(tt):
    """Importance-weighted mean and variance per dimension of a tempered
    trace, the weights computed from its draws, with their standard errors
    from the smaller of the weights' Kish ESS and the draws'
    integrated-time ESS."""
    s = np.asarray(tt.get(flatten=False, original_space=False))
    w = weights_of(s)
    sf, wf = s.reshape(-1, s.shape[-1]), w.reshape(-1)
    mean = np.sum(sf * wf[:, None], 0) / np.sum(wf)
    var = np.sum((sf - mean) ** 2 * wf[:, None], 0) / np.sum(wf)
    kish = np.sum(wf) ** 2 / np.sum(wf ** 2)
    ess = np.minimum(kish, effective_sample_size(s))
    return mean, var, np.sqrt(var / ess), var * np.sqrt(2.0 / ess)


def test_tnuts_weighted_moments():
    """Twin of the JAX package's ``test_tnuts_weighted_moments``, its
    density and tolerances. The JAX test's 8 chains x 2000 post-warmup
    draws after 1000 warmup iterations are 32 x 500 after 600 here: the
    port's transitions cost per iteration, not per chain, on the CPU."""
    bt.utils.set_generator(17)
    _, pair, target_var = _densities()
    tt = _run(bt, pair, 'TNUTS', {'n_chain': 32, 'n_iter': 1100,
                                  'n_warmup': 600})
    assert tt.sampler == 'TNUTS'
    s = tt.get(flatten=True, original_space=False)
    w = tt.get(return_type='weights', flatten=True)
    u = tt.get(return_type='u', flatten=True)
    assert s.shape[0] == w.shape[0] == u.shape[0]
    assert np.all(w > 0)
    assert (u > 0).mean() > 0.02 and (u < 0).mean() > 0.02
    mean_w = np.sum(s * w[:, None], axis=0) / np.sum(w)
    var_w = np.sum(s ** 2 * w[:, None], axis=0) / np.sum(w)
    assert np.all(np.abs(mean_w) < 0.15)
    assert np.allclose(var_w, target_var, atol=0.15)
    assert set(tt[0].stats.get()) == set(
        bt.samplers.sample_trace.tnstats_items)


def test_thmc_smoke():
    """Twin of the JAX package's ``test_thmc_smoke``, its density and
    tolerance; its 4 chains x 900 post-warmup draws are 12 x 300 here."""
    bt.utils.set_generator(23)
    _, pair, target_var = _densities(3)
    tt = _run(bt, pair, 'THMC', {'n_chain': 12, 'n_iter': 900,
                                 'n_warmup': 600, 'n_int_step': 16})
    assert tt.sampler == 'THMC'
    w = tt.get(return_type='weights', flatten=True)
    s = tt.get(flatten=True, original_space=False)
    var_w = np.sum(s ** 2 * w[:, None], axis=0) / np.sum(w)
    assert np.allclose(var_w, target_var, atol=0.25)
    st = tt[0].stats.get()
    assert 'u' in st and 'weight' in st and 'accept_stat' in st
    assert tt.n_call == 12 * (900 * 17 + 1) + tt.trace._descent_calls


@pytest.mark.parametrize('sampler', ['TNUTS', 'THMC'])
def test_matches_jax_statistically(sampler):
    """The weights are computed from each side's draws: the JAX package's
    THMC records the weight of a rejected proposal, not of the draw the
    chain kept (its weighted variance here reads ~0.6, not 0.5). The
    port's recorded weights are its draws' own."""
    pair_j, pair_t, _ = _densities(3)
    cfg = {'n_chain': 16, 'n_iter': 600, 'n_warmup': 300}
    if sampler == 'THMC':
        cfg['n_int_step'] = 16
    bf.utils.set_generator(4)
    bt.utils.set_generator(4)
    tt = _run(bt, pair_t, sampler, cfg)
    np.testing.assert_allclose(
        tt.get(return_type='weights', flatten=False),
        weights_of(tt.get(flatten=False, original_space=False)),
        rtol=1e-12)
    mj, vj, smj, svj = weighted_moments(_run(bf, pair_j, sampler, cfg))
    mt, vt, smt, svt = weighted_moments(tt)
    tol_m, tol_v = 5 * np.hypot(smt, smj), 5 * np.hypot(svt, svj)
    assert np.all(np.abs(mt - mj) < tol_m), (mt, mj, tol_m)
    assert np.all(np.abs(vt - vj) < tol_v), (vt, vj, tol_v)
