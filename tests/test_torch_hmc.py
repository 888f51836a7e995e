"""The port's fixed-length HMC (``samplers/hmc.py``) against the JAX
package.

(a) One transition of every chain with the JAX side's own draws injected:
the momenta and the accept uniform come from the key splits that
``bayesfast_tpu/samplers/hmc.py:32-33`` makes, and go into the port's
deterministic core; q, the stats and the acceptances agree to rtol 1e-10
in float64. The port's stats logp and energy are the kept state's: the
JAX package's are the trajectory end's even where it rejects, so there
the JAX start state's are the reference. (b) The JAX test ``test_hmc_gaussian_moments`` through
``sample`` with its density, tolerances and exact ``n_call``. (c) The two
packages on the same density: per-dimension means and variances within
five standard errors of their difference (sd / sqrt(ESS) for a mean,
var sqrt(2 / ESS) for a variance; ESS from ``utils/acor.py``). (d) One run
with ``metric='full'`` and one with ``pooled_metric=True``.
"""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bayesfast_tpu as bf
import bayesfast_tpu_torch as bt
from bayesfast_tpu.samplers import hmc as jhmc
from bayesfast_tpu.samplers import integration as jint
from bayesfast_tpu.samplers import metrics as jm
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.samplers import hmc as thmc
from bayesfast_tpu_torch.utils.acor import effective_sample_size
from test_torch_integration import lpg_j, lpg_t, metric_pair


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


def assert_moments_agree(s_t, s_j, z=5.0):
    """Means and variances of two runs' draws (C, N, D) agree within ``z``
    standard errors of their difference, each side's from its ESS."""
    out = []
    for s in (s_t, s_j):
        ess = effective_sample_size(s)
        flat = s.reshape(-1, s.shape[-1])
        m, v = flat.mean(0), flat.var(0)
        out.append((m, v, np.sqrt(v / ess), v * np.sqrt(2.0 / ess)))
    (mt, vt, smt, svt), (mj, vj, smj, svj) = out
    tol_m, tol_v = z * np.hypot(smt, smj), z * np.hypot(svt, svj)
    assert np.all(np.abs(mt - mj) < tol_m), (mt, mj, tol_m)
    assert np.all(np.abs(vt - vj) < tol_v), (vt, vj, tol_v)


def _gauss_density(dim=4):
    """The JAX test's density (``tests/test_sampling.py::_gauss_density``)
    in both packages."""
    rng = np.random.default_rng(3)
    A = rng.normal(size=(dim, dim))
    cov = A @ A.T / dim + np.eye(dim)
    prec = np.linalg.inv(cov)
    pj, pt = jnp.asarray(prec), torch.as_tensor(prec)
    den_j = bf.DensityLite(logp=lambda x: -0.5 * x @ pj @ x, input_size=dim)
    den_t = bt.DensityLite(
        logp=lambda x: -0.5 * torch.sum((x @ pt) * x, -1), input_size=dim)
    return den_j, den_t, cov


@pytest.mark.parametrize('max_change', [1000., 1.0])
@pytest.mark.parametrize('kind', ['diag', 'full'])
def test_transition_with_jax_draws(kind, max_change):
    C, D = 64, 4
    rng = np.random.default_rng(10)
    mj, mt = metric_pair(kind, False, rng)
    q0 = rng.normal(size=(C, D))
    # the full metric is the target's covariance: a longer step is needed
    # for rejections
    eps, n_int = (0.45 if kind == 'diag' else 1.6), 7
    keys = jax.random.split(jax.random.PRNGKey(4), C)
    qj, sj = jax.vmap(lambda k, q: jhmc.hmc_transition(
        k, q, mj, eps, lpg_j, n_int, max_change))(keys, jnp.asarray(q0))

    def draws(key):
        _, k_mom, k_acc = jax.random.split(key, 3)
        return jm.sample_momentum(mj, k_mom), jax.random.uniform(k_acc)

    p0, u = jax.vmap(draws)(keys)
    start = jax.vmap(lambda q, p: jint.compute_state(mj, lpg_j, q, p))(
        jnp.asarray(q0), p0)
    sj = sj._replace(**{f: jnp.where(sj.accepted, getattr(sj, f),
                                     getattr(start, f))
                        for f in ('logp', 'energy')})
    qt, st = thmc.hmc_core(torch.as_tensor(q0), torch.as_tensor(np.array(p0)),
                           torch.as_tensor(np.array(u)), mt, eps, lpg_t,
                           n_int, max_change)
    acc = np.asarray(sj.accepted)
    # both outcomes occur, and with max_change 1 some transitions diverge
    assert 0 < acc.sum() < C
    if max_change < 10:
        assert np.asarray(sj.diverging).any()
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-10,
                               atol=1e-12)
    for f in thmc.HmcStats._fields:
        a, b = getattr(st, f).numpy(), np.asarray(getattr(sj, f))
        if a.dtype == bool or f == 'n_int_step':
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12,
                                       err_msg=f)


def test_transition_draws_from_one_generator():
    """``hmc_transition`` takes the momenta, then one uniform per chain,
    from its generator: the same draws given to the core reproduce it."""
    C, D = 16, 4
    rng = np.random.default_rng(11)
    _, mt = metric_pair('full', False, rng)
    q0 = torch.as_tensor(rng.normal(size=(C, D)))
    qa, sa = thmc.hmc_transition(torch.Generator().manual_seed(9), q0, mt,
                                 0.4, lpg_t, 5, 1000.)
    g = torch.Generator().manual_seed(9)
    p0 = bt.samplers.metrics.sample_momentum_b(mt, g, (C, D), torch.float64)
    u = torch.rand(C, generator=g, dtype=torch.float64)
    qb, sb = thmc.hmc_core(q0, p0, u, mt, 0.4, lpg_t, 5, 1000.)
    assert torch.equal(qa, qb)
    assert all(torch.equal(x, y) for x, y in zip(sa, sb))


def test_hmc_gaussian_moments():
    """Twin of the JAX package's ``test_hmc_gaussian_moments``."""
    _, den, cov = _gauss_density()
    bt.utils.set_generator(0)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        tt = bt.sample(den, {'n_chain': 8, 'n_iter': 3000, 'n_warmup': 1000,
                             'n_int_step': 24}, sampler='HMC', verbose=False)
    s = tt.get(flatten=True)
    assert np.abs(np.cov(s, rowvar=False) - cov).max() < 0.6
    assert np.abs(s.mean(axis=0)).max() < 0.25
    assert tt.sampler == 'HMC'
    assert isinstance(tt.trace, bt.HTrace)
    assert tt.trace._descent_calls > 0
    assert tt.n_call == 8 * (3000 * 25 + 1) + tt.trace._descent_calls
    st = tt[0].stats.get()
    assert set(st) == set(bt.samplers.sample_trace.hstats_items)
    assert np.all(st['n_int_step'] == 24)


def test_hmc_matches_jax_statistically():
    den_j, den_t, cov = _gauss_density()
    cfg = {'n_chain': 16, 'n_iter': 1500, 'n_warmup': 500, 'n_int_step': 12}
    bf.utils.set_generator(1)
    bt.utils.set_generator(1)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        tj = bf.sample(den_j, dict(cfg), sampler='HMC', verbose=False)
        tt = bt.sample(den_t, dict(cfg), sampler='HMC', verbose=False)
    assert_moments_agree(tt.get(flatten=False), tj.get(flatten=False))
    acc_t = tt.trace._stats_arrays['accept_stat'][:, 500:].mean()
    acc_j = np.asarray(tj.trace._stats_arrays['accept_stat'])[:, 500:].mean()
    # both adapt to the 0.8 target
    assert abs(acc_t - acc_j) < 0.05, (acc_t, acc_j)


@pytest.mark.parametrize('option', ['full', 'pooled'])
def test_hmc_metric_options(option):
    """HMC with a full metric adapted per chain, and with one diag metric
    pooled over chains, at the JAX test's 24 leapfrogs (at 16, eps x 16
    nears half a period of the long axis and both packages' variances come
    out low)."""
    _, den, cov = _gauss_density()
    bt.utils.set_generator(2)
    kw = ({'metric': 'full'} if option == 'full'
          else {'pooled_metric': True})
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        tt = bt.sample(den, bt.HTrace(n_chain=8, n_iter=1500, n_warmup=600,
                                      n_int_step=24, **kw), verbose=False)
    s = tt.get(flatten=True)
    assert np.abs(np.cov(s, rowvar=False) - cov).max() < 0.6
    assert np.abs(s.mean(axis=0)).max() < 0.25
    m = tt.trace._carry.metric
    if option == 'full':
        assert m.cov.shape == (8, 4, 4)
        # the adapted metric approaches the covariance
        assert np.abs(m.cov.mean(0).numpy() - cov).max() < 0.8
    else:
        assert m.var.shape == (4,)
        np.testing.assert_allclose(m.var.numpy(), np.diag(cov), rtol=0.3)
