"""The port's ensemble sampler (``samplers/ensemble.py``) against the JAX
package.

(a) One half-update with the JAX side's z, j and u (the key splits at
``bayesfast_tpu/samplers/ensemble.py:36-41``) given to the port's
deterministic core: rtol 1e-10 in float64. (b) The JAX tests
``test_ensemble_*`` through ``sample`` with their densities and
tolerances. (c) Both packages on the same density: moments within five
standard errors of their difference. (d) The stream is keyed by the
global iteration: ``n_update`` does not change it.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bayesfast_tpu as bf
import bayesfast_tpu_torch as bt
from bayesfast_tpu.samplers import ensemble as je
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.samplers import ensemble as te
from test_torch_hmc import assert_moments_agree


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


COV = np.array([[2.0, 0.8], [0.8, 1.0]])


def _gauss_pair():
    """The JAX test's correlated 2-d Gaussian in both packages."""
    pj = jnp.asarray(np.linalg.inv(COV))
    pt = torch.as_tensor(np.linalg.inv(COV))
    return (bf.DensityLite(logp=lambda x: -0.5 * x @ pj @ x, input_size=2),
            bt.DensityLite(logp=lambda x: -0.5 * torch.sum((x @ pt) * x, -1),
                           input_size=2))


@pytest.mark.parametrize('a', [2.0, 3.5])
def test_half_update_with_jax_draws(a):
    n_act, n_other, D = 40, 40, 5
    rng = np.random.default_rng(0)
    active = rng.normal(size=(n_act, D))
    other = rng.normal(size=(n_other, D)) * 1.3
    prec = np.diag(rng.uniform(0.5, 2.0, D))

    def logp_j(x):
        return -0.5 * x @ jnp.asarray(prec) @ x

    def logp_t(x):
        return -0.5 * torch.sum((x @ torch.as_tensor(prec)) * x, -1)

    lp_act = -0.5 * np.sum((active @ prec) * active, -1)
    key = jax.random.PRNGKey(3)
    new_j, lp_j, acc_j, p_j = je._half_update(
        key, jnp.asarray(active), jnp.asarray(other), jnp.asarray(lp_act),
        logp_j, a)
    k_z, k_j, k_u = jax.random.split(key, 3)
    u_z = jax.random.uniform(k_z, (n_act,), jnp.float64)
    z = ((a - 1.0) * u_z + 1.0) ** 2 / a
    j = jax.random.randint(k_j, (n_act,), 0, n_other)
    u = jax.random.uniform(k_u, (n_act,), jnp.float64)
    new_t, lp_t, acc_t, p_t = te._half_update_core(
        *(torch.as_tensor(np.array(v)) for v in (active, other, lp_act)),
        logp_t, *(torch.as_tensor(np.array(v)) for v in (z, j, u)))
    acc = np.asarray(acc_j)
    assert 0 < acc.sum() < n_act
    np.testing.assert_array_equal(acc_t.numpy(), acc)
    for got, want in ((new_t, new_j), (lp_t, lp_j), (p_t, p_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-10, atol=1e-12)


def test_ensemble_gaussian_moments():
    """Twin of the JAX package's ``test_ensemble_gaussian_moments``."""
    bt.utils.set_generator(12)
    den = _gauss_pair()[1]
    tt = bt.sample(den, {'n_chain': 64, 'n_iter': 2000, 'n_warmup': 500},
                   sampler='Ensemble', verbose=False)
    assert tt.sampler == 'Ensemble'
    assert isinstance(tt.trace, bt.ETrace)
    s = tt.get(flatten=True)
    assert s.shape == (64 * 1500, 2)
    assert np.allclose(s.mean(axis=0), 0.0, atol=0.1)
    assert np.allclose(np.cov(s, rowvar=False), COV, atol=0.25)
    st = tt[0].stats.get()
    assert 0.1 < np.mean(st['accepted']) < 0.9
    assert tt.n_call == 64 * 2001
    # the trace's logp is the walkers' log density
    lp = den.logp(tt.trace.samples[:, -1], original_space=False)
    np.testing.assert_allclose(tt.trace.logp[:, -1], lp, rtol=1e-12)


def _beta_logp(x):
    return torch.sum(1.5 * torch.log(x) + 1.5 * torch.log1p(-x), -1)


def test_ensemble_bounded_continuation():
    """Twin of the JAX package's ``test_ensemble_bounded_continuation``."""
    bt.utils.set_generator(13)
    den = bt.DensityLite(logp=_beta_logp, input_size=2,
                         input_scales=np.array([[0., 1.], [0., 1.]]),
                         hard_bounds=True)
    tt = bt.sample(den, {'n_chain': 32, 'n_iter': 1000, 'n_warmup': 300},
                   sampler='Ensemble', verbose=False)
    tt.trace.add_iter(500)
    tt = bt.sample(den, tt, verbose=False)
    assert tt.i_iter == 1500
    s = tt.get(flatten=True)
    assert (s > 0).all() and (s < 1).all()
    assert np.allclose(s.mean(axis=0), 0.5, atol=0.03)


def test_ensemble_matches_jax_statistically():
    den_j, den_t = _gauss_pair()
    # long enough for the integrated time (~31 here) to be estimated
    cfg = {'n_chain': 64, 'n_iter': 4000, 'n_warmup': 500}
    bf.utils.set_generator(6)
    bt.utils.set_generator(6)
    tj = bf.sample(den_j, dict(cfg), sampler='Ensemble', verbose=False)
    tt = bt.sample(den_t, dict(cfg), sampler='Ensemble', verbose=False)
    assert_moments_agree(tt.get(flatten=False), tj.get(flatten=False))
    acc_t = tt.trace._stats_arrays['accepted'][:, 500:].mean()
    acc_j = np.asarray(tj.trace._stats_arrays['accepted'])[:, 500:].mean()
    # 64 x 3500 accept flags: the rates' sd is ~0.002 apart from the
    # correlation along a chain
    assert abs(acc_t - acc_j) < 0.02, (acc_t, acc_j)


def test_stream_independent_of_n_update():
    den = _gauss_pair()[1]
    runs = []
    for n_update in (None, 7, 200):
        bt.utils.set_generator(8)
        runs.append(bt.sample(den, {'n_chain': 16, 'n_iter': 200,
                                    'n_warmup': 50}, sampler='Ensemble',
                              verbose=False, n_update=n_update))
    for tt in runs[1:]:
        assert np.array_equal(tt.samples, runs[0].samples)
        assert np.array_equal(tt.logp, runs[0].logp)
