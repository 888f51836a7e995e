"""The port's tree loop (``samplers/nuts.py``) against the JAX package's.

(a) The full-metric integrator pieces, ``compute_state_t`` and
``leapfrog_t``, on the same float64 inputs: rtol 1e-12 (the port keeps
chains on the leading axis, the JAX package lane-minor). (b) One
``nuts_transition_batched`` of each on a Gaussian from the same starts: the
two draw from different generators (torch vs jax keys), so they are held
together statistically, mean tree depth and acceptance over 512 chains
within bounds of about five standard errors. (c) A twin of the JAX
package's ``test_pooled_full_metric_sampling`` through ``sample``.
"""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bayesfast_tpu_torch as bt
from bayesfast_tpu.samplers import metrics as jm
from bayesfast_tpu.samplers import nuts as jnuts
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.samplers import metrics as tm
from bayesfast_tpu_torch.samplers import nuts as tnuts


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


D = 3
COV = np.array([[2.0, 0.8, 0.1], [0.8, 1.0, -0.3], [0.1, -0.3, 0.5]])
PREC = np.linalg.inv(COV)


def _lpg_j(x_t):
    x = x_t.T
    return -0.5 * jnp.sum((x @ jnp.asarray(PREC)) * x, -1), \
        -(x @ jnp.asarray(PREC)).T


def _lpg_t(x):
    g = -(x @ torch.as_tensor(PREC))
    return 0.5 * torch.sum(g * x, -1), g


@pytest.mark.parametrize('per_chain', [False, True])
def test_full_metric_leapfrog_matches_jax(per_chain):
    rng = np.random.default_rng(0)
    C = 5
    q, p = rng.normal(size=(C, D)), rng.normal(size=(C, D))
    eps = rng.uniform(-0.3, 0.3, size=C)
    cov = COV if not per_chain else np.stack(
        [COV * s for s in rng.uniform(0.5, 2., C)])
    mean = np.zeros((C, D) if per_chain else D)
    mj = (jax.vmap(jm.init_full_metric)(jnp.asarray(mean), jnp.asarray(cov))
          if per_chain else jm.init_full_metric(jnp.asarray(mean),
                                                jnp.asarray(cov)))
    mt = tm.init_full_metric(torch.as_tensor(mean), torch.as_tensor(cov))
    mtj, mtt = jnuts._metric_t(mj), tnuts._metric_t(mt)
    sj = jnuts.compute_state_t(mtj, _lpg_j, jnp.asarray(q.T), jnp.asarray(p.T))
    st = tnuts.compute_state_t(mtt, _lpg_t, torch.as_tensor(q),
                               torch.as_tensor(p))
    for _ in range(3):
        sj = jnuts.leapfrog_t(mtj, _lpg_j, jnp.asarray(eps), sj)
        st = tnuts.leapfrog_t(mtt, _lpg_t, torch.as_tensor(eps), st)
    for f in tnuts.TIntegratorState._fields:
        want = np.asarray(getattr(sj, f))
        want = want.T if want.ndim == 2 else want
        np.testing.assert_allclose(getattr(st, f).numpy(), want, rtol=1e-12,
                                   atol=1e-15, err_msg=f)


@pytest.mark.parametrize('kind', ['diag', 'full'])
def test_tree_loop_matches_jax_statistically(kind):
    C = 512
    rng = np.random.default_rng(1)
    q0 = rng.normal(size=(C, D)) @ np.linalg.cholesky(COV).T
    step = 0.6
    if kind == 'diag':
        mj = jm.init_diag_metric(jnp.zeros(D), jnp.asarray(np.diag(COV)))
        mt = tm.init_diag_metric(torch.zeros(D, dtype=torch.float64),
                                 torch.as_tensor(np.diag(COV)))
    else:
        mj = jm.init_full_metric(jnp.zeros(D), jnp.asarray(COV))
        mt = tm.init_full_metric(torch.zeros(D, dtype=torch.float64),
                                 torch.as_tensor(COV))
    lpg_b = jax.vmap(jax.value_and_grad(
        lambda x: -0.5 * x @ jnp.asarray(PREC) @ x))
    qj, sj = jnuts.nuts_transition_batched(
        jax.random.PRNGKey(3), jnp.asarray(q0), mj, step, lpg_b, 10, 1000.)
    qt, stt = tnuts.nuts_transition_batched(
        torch.Generator().manual_seed(3), torch.as_tensor(q0), mt, step,
        _lpg_t, 10, 1000.)
    assert qt.shape == (C, D) and torch.isfinite(qt).all()
    depth_j = float(np.mean(np.asarray(sj.tree_depth)))
    depth_t = float(stt.tree_depth.double().mean())
    acc_j = float(np.mean(np.asarray(sj.mean_tree_accept)))
    acc_t = float(stt.mean_tree_accept.mean())
    # per-chain sd of the depth ~0.6 and of the acceptance ~0.15: over 512
    # chains the difference of two means has sd ~0.04 and ~0.01
    assert abs(depth_t - depth_j) < 0.2, (depth_t, depth_j)
    assert abs(acc_t - acc_j) < 0.05, (acc_t, acc_j)
    assert not stt.diverging.any()
    # the statistics hang together as in the JAX loop
    assert torch.all(stt.tree_size >= 1)
    assert torch.all(stt.tree_size <= 2 ** stt.tree_depth)
    lp, _ = _lpg_t(qt)
    np.testing.assert_allclose(stt.logp.numpy(), lp.numpy(), rtol=1e-12)


def test_pooled_full_metric_sampling():
    """Twin of the JAX package's test: a correlated 2-d Gaussian through
    ``sample`` with a pooled full metric (every transition on the tree
    loop, the density has no ``kernel_spec()``)."""
    cov = np.array([[2.0, 1.2], [1.2, 1.0]])
    prec = torch.as_tensor(np.linalg.inv(cov))
    den = bt.DensityLite(
        logp=lambda x: -0.5 * torch.sum((x @ prec) * x, -1), input_size=2)
    tr = bt.NTrace(n_chain=32, n_iter=700, n_warmup=300, metric='full',
                   pooled_metric=True, random_generator=5)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        tt = bt.sample(den, tr, verbose=False)
    s = tt.get(flatten=True)
    assert np.allclose(np.cov(s, rowvar=False), cov, atol=0.2)
    metric = tt.trace._carry.metric
    assert isinstance(metric, tm.FullMetricState)
    assert tuple(metric.cov.shape) == (2, 2)
    assert np.allclose(metric.cov.numpy(), cov, atol=0.4)
    # every iteration's stats came back, warmup flags included
    st = tt.trace._stats_arrays
    assert st['warmup'][:, :300].all() and not st['warmup'][:, 300:].any()
    assert st['step_size'].shape == (32, 700)
