"""The port's fixed-length integrator (``samplers/integration.py``) and the
metric helpers it uses, against the JAX package.

``compute_state`` and ``leapfrog`` on the same float64 inputs, diag and
full metrics, shared or per chain: rtol 1e-12 (the JAX functions are
per-chain and vmapped here; the port's are batched). ``kinetic_energy``
and the single-draw ``sample_momentum`` against their definitions.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bayesfast_tpu.samplers import integration as jint
from bayesfast_tpu.samplers import metrics as jm
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.samplers import integration as tint
from bayesfast_tpu_torch.samplers import metrics as tm


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


D, C = 4, 6
COV = np.array([[2.0, 0.8, 0.1, 0.0], [0.8, 1.0, -0.3, 0.2],
                [0.1, -0.3, 0.5, 0.1], [0.0, 0.2, 0.1, 1.5]])
PREC = np.linalg.inv(COV)


def lpg_j(x):
    g = -(jnp.asarray(PREC) @ x)
    return 0.5 * jnp.dot(g, x), g


def lpg_jb(x):
    """``lpg_j`` of a batch (C, D)."""
    g = -(x @ jnp.asarray(PREC))
    return 0.5 * jnp.sum(g * x, -1), g


def lpg_t(x):
    g = -(x @ torch.as_tensor(PREC))
    return 0.5 * torch.sum(g * x, -1), g


def metric_pair(kind, per_chain, rng, C=C):
    """The same metric state in both packages: diag or full, one shared
    state or one per chain (of ``C``)."""
    if kind == 'diag':
        m = (rng.uniform(0.3, 2., (C, D)) if per_chain
             else rng.uniform(0.3, 2., D))
    else:
        m = (np.stack([COV * s for s in rng.uniform(0.5, 2., C)])
             if per_chain else COV)
    mean = np.zeros((C, D) if per_chain else D)
    j_init = jm.init_diag_metric if kind == 'diag' else jm.init_full_metric
    t_init = tm.init_diag_metric if kind == 'diag' else tm.init_full_metric
    mj = (jax.vmap(j_init)(jnp.asarray(mean), jnp.asarray(m)) if per_chain
          else j_init(jnp.asarray(mean), jnp.asarray(m)))
    return mj, t_init(torch.as_tensor(mean), torch.as_tensor(m))


def assert_state_close(st, sj, fields, rtol=1e-12):
    for f in fields:
        np.testing.assert_allclose(
            torch.as_tensor(getattr(st, f)).numpy(),
            np.asarray(getattr(sj, f)), rtol=rtol, atol=1e-14, err_msg=f)


@pytest.mark.parametrize('per_chain', [False, True])
@pytest.mark.parametrize('kind', ['diag', 'full'])
def test_compute_state_matches_jax(kind, per_chain):
    rng = np.random.default_rng(0)
    mj, mt = metric_pair(kind, per_chain, rng)
    q, p = rng.normal(size=(C, D)), rng.normal(size=(C, D))
    sj = jax.vmap(lambda m, qq, pp: jint.compute_state(m, lpg_j, qq, pp),
                  in_axes=(0 if per_chain else None, 0, 0))(
        mj, jnp.asarray(q), jnp.asarray(p))
    st = tint.compute_state(mt, lpg_t, torch.as_tensor(q),
                            torch.as_tensor(p))
    assert_state_close(st, sj, tint.IntegratorState._fields)


@pytest.mark.parametrize('per_chain', [False, True])
@pytest.mark.parametrize('kind', ['diag', 'full'])
def test_leapfrog_matches_jax(kind, per_chain):
    """Five leapfrogs with per-chain steps."""
    rng = np.random.default_rng(1)
    mj, mt = metric_pair(kind, per_chain, rng)
    q, p = rng.normal(size=(C, D)), rng.normal(size=(C, D))
    eps = rng.uniform(0.05, 0.4, C)
    ma = 0 if per_chain else None
    sj = jax.vmap(lambda m, qq, pp: jint.compute_state(m, lpg_j, qq, pp),
                  in_axes=(ma, 0, 0))(mj, jnp.asarray(q), jnp.asarray(p))
    step_j = jax.vmap(lambda m, e, s: jint.leapfrog(m, lpg_j, e, s),
                      in_axes=(ma, 0, 0))
    st = tint.compute_state(mt, lpg_t, torch.as_tensor(q),
                            torch.as_tensor(p))
    for _ in range(5):
        sj = step_j(mj, jnp.asarray(eps), sj)
        st = tint.leapfrog(mt, lpg_t, torch.as_tensor(eps), st)
    assert_state_close(st, sj, tint.IntegratorState._fields)


def test_leapfrog_scalar_step_equals_per_chain_step():
    rng = np.random.default_rng(2)
    _, mt = metric_pair('diag', False, rng)
    q, p = (torch.as_tensor(rng.normal(size=(C, D))) for _ in range(2))
    s0 = tint.compute_state(mt, lpg_t, q, p)
    a = tint.leapfrog(mt, lpg_t, 0.3, s0)
    b = tint.leapfrog(mt, lpg_t, torch.full((C,), 0.3, dtype=torch.float64),
                      s0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize('kind', ['diag', 'full'])
def test_single_momentum_draw(kind):
    """``sample_momentum`` draws one (D,) ``p ~ N(0, M)``: its standard
    normals are ``sqrt(var) p`` (diag) or ``L^T p`` (full), and
    ``kinetic_energy`` is ``0.5 p . M^-1 p``."""
    rng = np.random.default_rng(3)
    _, mt = metric_pair(kind, False, rng)
    p = tm.sample_momentum(mt, torch.Generator().manual_seed(5))
    z = torch.randn(D, generator=torch.Generator().manual_seed(5),
                    dtype=torch.float64)
    assert p.shape == (D,)
    z_back = (torch.sqrt(mt.var) * p if kind == 'diag'
              else mt.chol.T @ p)
    torch.testing.assert_close(z_back, z, rtol=1e-12, atol=1e-14)
    v = tm.velocity(mt, p)
    torch.testing.assert_close(tm.kinetic_energy(p, v), 0.5 * p @ v,
                               rtol=1e-14, atol=0)
    # a (C, D) batch reduces over the last axis
    pb = torch.stack([p, 2 * p])
    ke = tm.kinetic_energy(pb, tm.velocity(mt, pb))
    torch.testing.assert_close(ke, torch.stack([0.5 * p @ v, 2 * p @ v]),
                               rtol=1e-13, atol=0)
