"""The port's ChEES-HMC (``samplers/chees.py``) against the JAX package.

(a) ``halton2`` bitwise for i in 0..65535. (b) ``chees_adapt_update``
inside and outside warmup, three updates in a row from the same float64
inputs: rtol 1e-12. (c) One ``chees_transition_batched`` with the JAX
side's draws injected (the momenta and the uniforms of the key splits at
``bayesfast_tpu/samplers/chees.py:97`` and ``:119``) into the port's
deterministic core: rtol 1e-10. (d) The JAX tests ``test_chees_*`` through
``sample`` with their densities and tolerances. (e) The two packages on
the same density: moments within five standard errors of their
difference.
"""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bayesfast_tpu as bf
import bayesfast_tpu_torch as bt
from bayesfast_tpu.samplers import chees as jc
from bayesfast_tpu.samplers import metrics as jm
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.samplers import chees as tc
from test_torch_hmc import assert_moments_agree
from test_torch_integration import lpg_jb, lpg_t, metric_pair


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


def _std_normal(D):
    den_j = bf.DensityLite(logp=lambda x: -0.5 * jnp.sum(x ** 2),
                           input_size=D)
    den_t = bt.DensityLite(logp=lambda x: -0.5 * torch.sum(x ** 2, -1),
                           input_size=D)
    return den_j, den_t


def test_halton2_bitwise():
    i = np.arange(65536)
    want = np.asarray(jc.halton2(jnp.asarray(i, jnp.int32)))
    assert want.dtype == np.float64
    got = tc.halton2(torch.as_tensor(i)).numpy()
    np.testing.assert_array_equal(got, want)
    # the host-int form the driver uses
    for k in (0, 1, 2, 3, 100, 4095, 65535):
        assert tc.halton2(k) == want[k]


def _adapt_inputs(rng, C=32, D=3):
    q_old = rng.normal(size=(C, D))
    q_prop = q_old + 0.3 * rng.normal(size=(C, D))
    v_prop = rng.normal(size=(C, D))
    ap = rng.uniform(0.0, 1.0, C)
    ap[:3] = 0.0  # rejected proposals weigh nothing
    return q_old, q_prop, v_prop, ap


@pytest.mark.parametrize('warmup', [True, False])
def test_adapt_update_matches_jax(warmup):
    rng = np.random.default_rng(0)
    aj = jc.init_chees_adapt(0.3, 1.2, jnp.float64)
    at = tc.init_chees_adapt(0.3, 1.2, torch.float64)
    for it in range(3):
        q_old, q_prop, v_prop, ap = _adapt_inputs(rng)
        h = float(jc.halton2(jnp.int32(it)))
        eps_j = jnp.exp(aj.step.log_step if warmup else aj.step.log_bar)
        eps_t = torch.exp(at.step.log_step if warmup else at.step.log_bar)
        aj = jc.chees_adapt_update(aj, *map(jnp.asarray, (q_old, q_prop,
                                                          v_prop, ap)),
                                   h, eps_j, warmup, lr=0.05,
                                   max_leapfrogs=64)
        at = tc.chees_adapt_update(at, *map(torch.as_tensor, (q_old, q_prop,
                                                              v_prop, ap)),
                                   h, eps_t, warmup, lr=0.05,
                                   max_leapfrogs=64)
    assert at.count == int(aj.count) == 3
    for name in ('log_T', 'adam_m', 'adam_v'):
        np.testing.assert_allclose(getattr(at, name).numpy(),
                                   np.asarray(getattr(aj, name)), rtol=1e-12,
                                   atol=1e-300, err_msg=name)
    for f in at.step._fields:
        np.testing.assert_allclose(getattr(at.step, f).numpy(),
                                   np.asarray(getattr(aj.step, f)),
                                   rtol=1e-12, atol=1e-300, err_msg=f)
    moved = not np.isclose(float(at.log_T), np.log(1.2))
    assert moved == warmup


@pytest.mark.parametrize('per_chain', [False, True])
def test_transition_with_jax_draws(per_chain):
    C, D = 48, 4
    rng = np.random.default_rng(1)
    mj, mt = metric_pair('diag', per_chain, rng, C)
    q0 = rng.normal(size=(C, D))
    eps, traj, h = 0.5, 2.3, float(jc.halton2(jnp.int32(6)))
    key = jax.random.PRNGKey(8)
    qj, sj, auxj = jc.chees_transition_batched(
        key, jnp.asarray(q0), mj, eps, traj, h, lpg_jb, 64, 1000.)
    _, k_mom, k_acc = jax.random.split(key, 3)
    p0 = jm.sample_momentum_b(mj, k_mom, (C, D), jnp.float64)
    u = jax.random.uniform(k_acc, (C,))
    qt, st, auxt = tc.chees_core(
        torch.as_tensor(q0), torch.as_tensor(np.array(p0)),
        torch.as_tensor(np.array(u)), mt, eps, traj, h, lpg_t, 64, 1000.)
    acc = np.asarray(sj.accepted)
    assert 0 < acc.sum() < C
    assert int(st.n_int_step[0]) == int(np.ceil(h * traj / eps))
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-10,
                               atol=1e-12)
    for f in tc.CheesStats._fields:
        a, b = getattr(st, f).numpy(), np.asarray(getattr(sj, f))
        if a.dtype == bool or f == 'n_int_step':
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12,
                                       err_msg=f)
    for a, b in zip(auxt, auxj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)


def test_chees_std_normal_moments():
    """Twin of the JAX package's ``test_chees_std_normal_moments``."""
    D = 6
    bt.utils.set_generator(11)
    den = _std_normal(D)[1]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        tt = bt.sample(den, bt.CTrace(n_chain=16, n_iter=1200, n_warmup=500),
                       verbose=False)
    s = tt.get(flatten=True)
    assert np.abs(s.mean(0)).max() < 0.1
    assert np.all(np.abs(s.var(0) - 1) < 0.15)
    st = tt.sample_traces[0].stats.get()
    # the trajectory length adapts away from its 1.0 start
    assert st['traj_len'][-1] > 1.3
    assert tt.sampler == 'CHEES'
    # all chains share one leapfrog count an iteration
    ns = tt.trace._stats_arrays['n_int_step']
    assert np.all(ns == ns[:1])
    assert tt.n_call == int(ns.sum()) + 16 * 1201 + tt.trace._descent_calls


def test_chees_anisotropic_with_metric():
    """Twin of the JAX package's test: the scale mismatch is handled by the
    adaptive diag metric."""
    D = 4
    scales = np.asarray([0.1, 1.0, 3.0, 10.0])
    st_ = torch.as_tensor(scales)
    bt.utils.set_generator(3)
    den = bt.DensityLite(logp=lambda x: -0.5 * torch.sum((x / st_) ** 2, -1),
                         input_size=D)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        tt = bt.sample(den, bt.CTrace(n_chain=16, n_iter=1500, n_warmup=700),
                       verbose=False)
    s = tt.get(flatten=True)
    ratio = s.std(0) / scales
    assert np.all(np.abs(ratio - 1) < 0.2)


def test_chees_continuation():
    D = 3
    bt.utils.set_generator(7)
    den = _std_normal(D)[1]
    trace = bt.CTrace(n_chain=8, n_iter=200, n_warmup=100)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        tt = bt.sample(den, trace, n_run=120, verbose=False)
        assert tt.samples.shape == (8, 120, D)
        tt = bt.sample(den, tt, verbose=False)  # continue to n_iter
    assert tt.samples.shape == (8, 200, D)
    assert np.all(np.isfinite(tt.get()))


def test_chees_matches_jax_statistically():
    den_j, den_t = _std_normal(6)
    cfg = {'n_chain': 16, 'n_iter': 1000, 'n_warmup': 400}
    bf.utils.set_generator(5)
    bt.utils.set_generator(5)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        tj = bf.sample(den_j, dict(cfg), sampler='CHEES', verbose=False)
        tt = bt.sample(den_t, dict(cfg), sampler='CHEES', verbose=False)
    assert_moments_agree(tt.get(flatten=False), tj.get(flatten=False))
    # both move the trajectory length up from its 1.0 start; where it
    # settles differs from seed to seed in either package (the criterion
    # has a maximum near each odd multiple of a quarter period: 1.5, 3.5,
    # 6 and 9 all occur in five seeds of each), so the values are not
    # compared
    tl_t = tt.trace._stats_arrays['traj_len'][0, -1]
    tl_j = float(np.asarray(tj.trace._stats_arrays['traj_len'])[0, -1])
    assert tl_t > 1.3 and tl_j > 1.3
