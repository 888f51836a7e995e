"""The port's per-transition adaptation updates against the JAX package's.

``update_step_size``, ``update_metric`` (per chain: the JAX function vmapped
over chains, the port's batched over the leading axis) and
``update_metric_pooled``, diag and full, on the same float64 numpy inputs,
step by step through a sequence that refreshes the metric and switches the
Welford windows, then after warmup (masked). Every leaf agrees to rtol
1e-12: the two compute the same operations and differ only in the order of
a few sums.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bayesfast_tpu.samplers import metrics as jm
from bayesfast_tpu.samplers import step_size as jss
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch import interop
from bayesfast_tpu_torch.samplers import metrics as tm
from bayesfast_tpu_torch.samplers import step_size as tss


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


C, D = 6, 3
RTOL = 1e-12


def _close(got, want, name):
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    if want.dtype.kind in 'biu':
        assert np.all(got == want), name
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-300,
                                   err_msg=name)


def _states_close(t, j):
    """Every leaf of a port metric state against the JAX state's."""
    names = ('cov', 'chol') if isinstance(t, tm.FullMetricState) else ('var',)
    for n in names:
        _close(getattr(t, n), getattr(j, n), n)
    for w in ('fg', 'bg'):
        for n in ('mean', 'raw', 'weight'):
            _close(getattr(getattr(t, w), n), getattr(getattr(j, w), n),
                   f'{w}.{n}')
    for n in ('n_samples', 'prev_update', 'adapt_window'):
        assert getattr(t, n) == int(np.asarray(getattr(j, n)).ravel()[0]), n


def test_update_step_size_matches_jax():
    rng = np.random.default_rng(0)
    eps0 = np.exp(rng.normal(size=C) * 0.3) * 0.2
    sj = jax.vmap(lambda e: jss.init_step_size(e, jnp.float64))(
        jnp.asarray(eps0))
    st = tss.init_step_size(torch.as_tensor(eps0), torch.float64, 'cpu')
    kw = dict(target=0.8, gamma=0.05, k=0.75, t_0=10.)
    for i in range(12):
        acc = rng.uniform(0.2, 1.0, size=C)
        warm = i < 8
        _close(tss.current_step_size(st, warm),
               jss.current_step_size(sj, warm), 'current step')
        sj = jss.update_step_size(sj, jnp.asarray(acc), warm, **kw)
        st = tss.update_step_size(st, torch.as_tensor(acc), warm, **kw)
        for f in tss.StepSizeState._fields:
            _close(getattr(st, f), getattr(sj, f), f'{f} at {i}')
    # adapt=False freezes the step in warmup too, as in JAX
    acc = torch.full((C,), 0.3, dtype=torch.float64)
    sj = jss.update_step_size(sj, jnp.asarray(acc.numpy()), True, adapt=False,
                              **kw)
    st = tss.update_step_size(st, acc, True, adapt=False, **kw)
    for f in tss.StepSizeState._fields:
        _close(getattr(st, f), getattr(sj, f), f)


def _samples(n, rng, scale):
    return [rng.normal(size=(C, D)) * scale + 0.5 for _ in range(n)]


@pytest.mark.parametrize('full', [False, True])
def test_update_metric_per_chain_matches_jax(full):
    rng = np.random.default_rng(1)
    mean0 = rng.normal(size=(C, D))
    if full:
        m0 = np.eye(D) + 0.3 * np.ones((D, D))
        mj = jax.vmap(lambda m: jm.init_full_metric(m, jnp.asarray(m0), 10.,
                                                    3))(jnp.asarray(mean0))
        mt = tm.init_full_metric(torch.as_tensor(mean0), torch.as_tensor(m0),
                                 10., 3)
    else:
        m0 = np.linspace(0.5, 2., D)
        mj = jax.vmap(lambda m: jm.init_diag_metric(m, jnp.asarray(m0), 10.,
                                                    3))(jnp.asarray(mean0))
        mt = tm.init_diag_metric(torch.as_tensor(mean0), torch.as_tensor(m0),
                                 10., 3)
    _states_close(mt, mj)
    upd = jax.vmap(jm.update_metric, in_axes=(0, 0, None, None, None))
    switches = 0
    for i, x in enumerate(_samples(14, rng, np.array([0.3, 1., 3.]))):
        warm = i < 11
        before = mt.adapt_window
        mj = upd(mj, jnp.asarray(x), warm, 2, True)
        mt = tm.update_metric(mt, torch.as_tensor(x), warm, 2, True)
        switches += mt.adapt_window != before
        _states_close(mt, mj)
    # two window switches (windows 3 and 6) and refreshes every other step
    assert switches == 2


@pytest.mark.parametrize('full', [False, True])
def test_update_metric_pooled_matches_jax(full):
    rng = np.random.default_rng(2)
    mean0 = rng.normal(size=D)
    if full:
        m0 = np.eye(D) * 2.0
        mj = jm.init_full_metric(jnp.asarray(mean0), jnp.asarray(m0), 10., 2)
        mt = tm.init_full_metric(torch.as_tensor(mean0), torch.as_tensor(m0),
                                 10., 2)
    else:
        m0 = np.ones(D)
        mj = jm.init_diag_metric(jnp.asarray(mean0), jnp.asarray(m0), 10., 2)
        mt = tm.init_diag_metric(torch.as_tensor(mean0), torch.as_tensor(m0),
                                 10., 2)
    switches = 0
    for i, x in enumerate(_samples(9, rng, np.array([0.2, 1., 5.]))):
        warm = i < 7
        before = mt.adapt_window
        mj = jm.update_metric_pooled(mj, jnp.asarray(x), warm, 1, True)
        mt = tm.update_metric_pooled(mt, torch.as_tensor(x), warm, 1, True)
        switches += mt.adapt_window != before
        _states_close(mt, mj)
    assert switches == 2
    assert mt.fg.weight.shape == ()


def test_batch_welford_equals_sequential():
    """Twin of the JAX package's test: one pooled merge of 16 samples is
    the same as 16 one-sample updates."""
    rng = np.random.default_rng(0)
    xb = torch.as_tensor(rng.normal(size=(16, 3)))
    m_seq = tm.init_diag_metric(torch.zeros(3, dtype=torch.float64),
                                torch.ones(3, dtype=torch.float64))
    for i in range(16):
        m_seq = tm.update_metric(m_seq, xb[i], True, update_window=1000)
    m_pool = tm.init_diag_metric(torch.zeros(3, dtype=torch.float64),
                                 torch.ones(3, dtype=torch.float64))
    m_pool = tm.update_metric_pooled(m_pool, xb, True, update_window=1000)
    np.testing.assert_allclose(m_seq.fg.mean, m_pool.fg.mean, rtol=1e-12)
    np.testing.assert_allclose(m_seq.fg.raw, m_pool.fg.raw, rtol=1e-10)


def test_metric_states_carry_over():
    """``interop.metric_from_numpy`` takes a JAX diag or full state (per
    chain or pooled) as numpy leaves."""
    mj = jm.init_full_metric(jnp.zeros(D), jnp.eye(D) * 3.0)
    mt = interop.metric_from_numpy(jax.tree.map(np.asarray, mj),
                                   torch.float64, 'cpu')
    assert isinstance(mt, tm.FullMetricState)
    _states_close(mt, mj)
    mj = jax.vmap(lambda m: jm.init_diag_metric(m, jnp.ones(D)))(
        jnp.zeros((C, D)))
    mt = interop.metric_from_numpy(jax.tree.map(np.asarray, mj),
                                   torch.float64, 'cpu')
    assert isinstance(mt, tm.DiagMetricState)
    _states_close(mt, mj)


def test_momenta_and_velocity_full():
    """The full branch of ``sample_momentum_b`` draws p ~ N(0, cov^-1) and
    ``velocity`` maps it back by cov, shared or per chain."""
    cov = np.array([[2.0, 0.6, 0.], [0.6, 1.0, 0.2], [0., 0.2, 0.5]])
    for batch in ((), (4,)):
        mt = tm.init_full_metric(torch.zeros(batch + (D,),
                                             dtype=torch.float64),
                                 torch.as_tensor(cov))
        g = torch.Generator().manual_seed(3)
        p = tm.sample_momentum_b(mt, g, (40000, D) if not batch else (4, D),
                                 torch.float64)
        if not batch:
            np.testing.assert_allclose(np.cov(p.numpy(), rowvar=False),
                                       np.linalg.inv(cov), rtol=0.05,
                                       atol=0.02)
        v = tm.velocity(mt, p)
        # a matrix product in another summation order: atol for the
        # components that cancel to near zero
        np.testing.assert_allclose(v.numpy(), p.numpy() @ cov.T, rtol=1e-12,
                                   atol=1e-14)


def test_per_transition_path_matches_warmup_chunk():
    """The two copies of warmup adaptation agree: ``ChainDriver.run`` with
    per-chain diag states (the block transition under the chunk's own
    per-transition seeds, then ``update_step_size`` and ``update_metric``)
    against ``run_warmup_chunk`` (the same transitions with the adaptation
    inside the chunk), through a refresh and a window switch. The two
    compute ``count^-k`` and the division by gamma in different forms, so
    floats agree to rtol 1e-9 and the trees exactly."""
    from bayesfast_tpu_torch.samplers.chain import ChainCarry, ChainDriver
    from test_torch_nuts_kernel import MAXDEPTH, _setup
    _, den_t, q0, var, eps = _setup()
    eps[:2] /= 40.0
    q0t = torch.as_tensor(q0)
    carry = ChainCarry(4242, q0t, tss.init_step_size(torch.as_tensor(eps),
                                                     torch.float64, 'cpu'),
                       tm.init_diag_metric(q0t, torch.as_tensor(var), 10., 2))
    drv = ChainDriver(den_t, max_treedepth=MAXDEPTH)
    ca, (qa, (sa, ea)), ints = drv.run_warmup_chunk(carry, 5, i0=3)
    cb, (qb, (sb, eb)) = drv.run(carry, [True] * 5, i0=3)
    assert ints == (cb.metric.n_samples, cb.metric.prev_update,
                    cb.metric.adapt_window) == (5, 2, 4)
    for k in ('tree_depth', 'tree_size', 'diverging'):
        assert torch.equal(getattr(sa, k), getattr(sb, k)), k
    pairs = [(qa, qb), (ea['step_size'], eb['step_size']),
             (ea['step_size_bar'], eb['step_size_bar'])]
    pairs += [(getattr(ca.step, f), getattr(cb.step, f))
              for f in tss.StepSizeState._fields]
    pairs += [(ca.metric.var, cb.metric.var)]
    pairs += [(getattr(getattr(ca.metric, w), f),
               getattr(getattr(cb.metric, w), f))
              for w in ('fg', 'bg') for f in ('mean', 'raw', 'weight')]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-12)
