"""The GBS evidence anchors on the port: funnel-16, ring-64, cauchy-48.

Each compiled-in density (``ops/densities.py``: ``NealFunnel``,
``RingDensity``, ``CauchyPair``, built by ``interop.funnel_density`` and
friends) is held against the JAX suite's own density
(``benchmarks/suite.py:_density``) and ``jax.grad``, in float64: its
``forward`` and its analytic ``(logp, grad)`` in both orders (the kernels'
warp order, and dense torch calls) at 256 seeded points across the box and
near its bounds, to rtol 1e-12 (the gradient with an atol of 1e-12 times
its largest element: components near a cancellation carry the absolute
rounding of the larger terms). The ring is also taken at D = 32, 33 and 40
(its cyclic neighbours across the one- and two-element lanes of the
kernels) and the cauchy at D = 36 (padded lanes), with the suite's formula
at that D.

The plain chunk and block transitions with each density are held against
the Pallas kernels in interpret mode (``make_nuts_pallas_multi`` /
``_warmup`` / ``make_nuts_pallas``), same seed, ``i0`` and
``chain_start``, at C = 8, K = 2, max depth 6: tree statistics exactly
equal, floats to rtol 1e-6 with each side's own float32 Box-Muller momenta
and to rtol 1e-9 with the same correctly rounded momenta on both sides (see
``test_torch_nuts_kernel.py``), each with an atol of rtol times the largest
magnitude of its output (of the energies for the energy differences): an
element near zero carries the absolute error of the trajectory, which
grows an ulp of a momentum up to ~4x over 63 leapfrogs. The ring runs at D = 40 and the cauchy at
D = 36, so that the wrap across two elements a lane and the padding are
covered; the funnel at D = 16.

Last, the route: each anchor samples on the chunk kernels (their plain
versions here) with no tree-loop transition.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesfast_tpu as bf
from bayesfast_tpu.samplers import nuts_pallas as jnpl
from benchmarks.suite import _density as suite_density
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.interop import (cauchy_density, funnel_density,
                                         ring_density)
from bayesfast_tpu_torch.ops.densities import _density_lpg
from bayesfast_tpu_torch.samplers import nuts as ttree
from bayesfast_tpu_torch.samplers import nuts_cuda as tnc
from test_torch_nuts_kernel import _to_port_layout, momenta  # noqa


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


BUILDERS = {'funnel': funnel_density, 'ring': ring_density,
            'cauchy': cauchy_density}
SUITE_D = {'funnel': 16, 'ring': 64, 'cauchy': 48}
C, K, MAXDEPTH, MAX_CHANGE = 8, 2, 6, 1000.


def _jax_density(name, D):
    """The suite's density, or at another D the suite's formula with that
    D's bounds and const (``benchmarks/suite.py:75-95``)."""
    if D == SUITE_D[name]:
        return suite_density(name)[0]
    den_t = BUILDERS[name](D)[0]
    bound = den_t.input_scales
    const = float(np.sum(np.log(bound[:, 1] - bound[:, 0])))
    if name == 'ring':
        def logp(x):
            x2 = x * x
            x2s = jnp.concatenate((x2[-1:], x2, x2[:1]))
            return -jnp.sum((x2s[:-2] + x2s[1:-1] - 2.) ** 2 / 1.) - const
    else:
        def logp(x):
            _a = 1 / ((x + 5.) ** 2 + 1)
            _b = 1 / ((x - 5.) ** 2 + 1)
            return (jnp.sum(jnp.log(_a + _b)) + D * jnp.log(0.5 / jnp.pi)
                    - const)
    return bf.DensityLite(logp=logp, input_size=D, input_scales=bound,
                          hard_bounds=True)


def _points(bound, rng, n=256):
    """Half across the box, a quarter within a thousandth of its width of
    each bound."""
    lo, hi = bound[:, 0], bound[:, 1]
    w = hi - lo
    u = rng.uniform(size=(n, lo.size))
    x = lo + w * u
    q = n // 4
    x[n // 2:n // 2 + q] = lo + w * 1e-3 * u[n // 2:n // 2 + q]
    x[n // 2 + q:] = hi - w * 1e-3 * u[n // 2 + q:]
    return x


@pytest.mark.parametrize('name,D', [('funnel', 16), ('ring', 64),
                                    ('ring', 32), ('ring', 33), ('ring', 40),
                                    ('cauchy', 48), ('cauchy', 36)])
def test_logp_and_grad_match_suite(name, D):
    den_j = _jax_density(name, D)
    den_t, extra = BUILDERS[name](D)
    assert extra == ({'target_accept': 0.95} if name == 'funnel' else {})
    np.testing.assert_array_equal(den_t.input_scales, den_j.input_scales)
    x = _points(den_t.input_scales, np.random.default_rng(D))
    lp_j = np.asarray(jax.vmap(den_j._logp)(x))
    g_j = np.asarray(jax.vmap(jax.grad(den_j._logp))(x))
    xt = torch.as_tensor(x)
    np.testing.assert_allclose(den_t._logp(xt).numpy(), lp_j, rtol=1e-12)
    spec = den_t.kernel_spec()
    for ordered in (True, False):
        lp, g = _density_lpg(spec, xt, ordered)
        np.testing.assert_allclose(lp.numpy(), lp_j, rtol=1e-12,
                                   err_msg=f'ordered={ordered}')
        np.testing.assert_allclose(g.numpy(), g_j, rtol=1e-12,
                                   atol=1e-12 * np.abs(g_j).max(),
                                   err_msg=f'ordered={ordered}')


# ---------------------------------------------------------------------------
# The plain transitions against the Pallas kernels

CASES = {'funnel': 16, 'ring': 40, 'cauchy': 36}


def _draws(name, D, rng, n, signs=None):
    """Rough draws from each anchor, in the original space: the funnel's
    prior, the ring's and the cauchy's modes at ``signs`` (random: every
    mode)."""
    if name == 'funnel':
        x0 = np.clip(rng.normal(size=(n, 1)), -3.5, 3.5)
        return np.concatenate(
            [x0, rng.normal(size=(n, D - 1)) * np.exp(0.5 * x0)], axis=1)
    if signs is None:
        signs = rng.choice([-1., 1.], size=(n, D))
    if name == 'ring':
        return signs * (1.0 + 0.1 * rng.normal(size=(n, D)))
    return 5.0 * signs + 0.5 * rng.normal(size=(n, D))


def _setup(name, diverge=True):
    """Starts in every mode; per-chain metrics from the spread of one mode
    and step sizes around 0.3, the scale a run adapts to. (With the spread
    of all the modes as the metric, a step crosses a cauchy bump or the
    ring's width in one leapfrog: the trajectories turn chaotic, and an
    ulp of a transcendental grows into the energy errors.) With
    ``diverge``, two chains take a step 10^4 times as long, which diverges
    on every density: the cauchy's energy error stays under ``MAX_CHANGE``
    at 40 times, where its trajectories are chaotic too."""
    D = CASES[name]
    den_j, den_t = _jax_density(name, D), BUILDERS[name](D)[0]
    rng = np.random.default_rng(CASES[name] + len(name))
    q0 = np.asarray(den_t.from_original(_draws(name, D, rng, C)))
    ref = np.asarray(den_t.from_original(_draws(name, D, rng, 512, 1.0)))
    var = ref.var(0) * np.exp(rng.normal(size=(C, D)) * 0.2)
    eps = np.exp(rng.normal(size=C) * 0.3) * 0.15
    if diverge:
        eps[:2] *= 1e4
    return den_j, den_t, q0, var, eps


def _compare(got, want, rtol, atol):
    """Tree statistics exactly equal; each float output to ``rtol``, with
    an atol of ``atol`` plus rtol times its own largest finite magnitude
    (the energies' for the energy differences)."""
    e_scale = np.abs(want['energy']).max()
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.shape == w.shape, k
        if k in ('tree_depth', 'tree_size', 'diverging'):
            assert np.array_equal(g, w), k
            continue
        fin = np.abs(w[np.isfinite(w)])
        scale = (e_scale if k in ('energy_change', 'max_de')
                 else fin.max(initial=0.0))
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol + rtol * scale,
                                   err_msg=k)


@pytest.mark.parametrize('name', list(CASES))
def test_frozen_chunk_matches_pallas(name, momenta):
    den_j, den_t, q0, var, eps = _setup(name)
    D = q0.shape[1]
    seed, i0, chain_start = 2 ** 31 - 2, 400, 1000
    run = jnpl.make_nuts_pallas_multi(
        den_j.device_logp_and_grad(False), (), D, C, K, MAXDEPTH,
        MAX_CHANGE, jnp.float64, interpret=True)
    o = run(jnp.int32(seed), jnp.int32(i0), jnp.int32(chain_start),
            jnp.asarray(q0.T), jnp.asarray(var.T), jnp.asarray(eps)[None],
            [])
    want = {k: _to_port_layout(k, v) for k, v in o.items()}
    got = tnc.nuts_chunk_plain(
        seed, torch.as_tensor(q0), torch.as_tensor(var),
        torch.as_tensor(eps), K, MAXDEPTH, MAX_CHANGE,
        tnc.plain_lpg(den_t), i0, chain_start)
    _compare(got, want, *momenta)
    assert want['diverging'].any() and (want['tree_depth'] > 1).any()


@pytest.mark.parametrize('name', list(CASES))
def test_warmup_chunk_matches_pallas(name, momenta):
    den_j, den_t, q0, var, eps = _setup(name, diverge=False)
    D = q0.shape[1]
    rng = np.random.default_rng(5)
    log_step = np.log(eps)
    # a state from late in warmup (count 500, mu at the step, hbar near
    # its fixed point): an update moves the step by under 20 %. Early on
    # (count 5, mu = log(10 eps)) the second transition's steps are ~1.9 to
    # ~18 times the first's, where the ring's and the cauchy's trajectories
    # turn unstable and amplify an ulp of the momenta a thousandfold
    step = (log_step, log_step + 0.1, rng.normal(size=C) * 1e-4,
            np.full(C, 500.0), log_step)
    metric = (var, q0 + rng.normal(size=(C, D)) * 0.01, var * 10.0,
              np.full(C, 10.0), q0, var * 3.0, np.full(C, 3.0))
    # a refresh and a window switch inside the chunk
    wsched, _ = jnpl._window_schedule(4, 0, 5, K, 1, True)
    assert wsched[0].any() and wsched[1].any()
    seed, i0, chain_start = 987654321, 33, 3
    args = (0.8, 0.05, 0.75, 10.)
    run = jnpl.make_nuts_pallas_warmup(
        den_j.device_logp_and_grad(False), (), D, C, K, MAXDEPTH,
        MAX_CHANGE, jnp.float64, wsched, *args, True, True, interpret=True)
    row = lambda a: jnp.asarray(a).reshape(1, C)
    mat = lambda a: jnp.asarray(a).T
    o = run(jnp.int32(seed), jnp.int32(i0), jnp.int32(chain_start),
            jnp.asarray(q0.T), tuple(row(a) for a in step),
            (mat(metric[0]), mat(metric[1]), mat(metric[2]), row(metric[3]),
             mat(metric[4]), mat(metric[5]), row(metric[6])), [], wsched)
    want = {k: _to_port_layout(k, v) for k, v in o.items()}
    got = tnc.nuts_warmup_chunk_plain(
        seed, torch.as_tensor(q0), [torch.as_tensor(a) for a in step],
        [torch.as_tensor(a) for a in metric], K, MAXDEPTH, MAX_CHANGE,
        *args, True, True, wsched, tnc.plain_lpg(den_t), i0, chain_start)
    assert set(got) == set(want)
    _compare(got, want, *momenta)


@pytest.mark.parametrize('name', list(CASES))
def test_block_matches_pallas(name, momenta):
    den_j, den_t, q0, var, eps = _setup(name)
    D = q0.shape[1]
    seed, chain_start = 123456789, 77
    run = jnpl.make_nuts_pallas(den_j.device_logp_and_grad(False), (), D, C,
                                MAXDEPTH, MAX_CHANGE, jnp.float64,
                                interpret=True)
    o = run(jnp.int32(seed), jnp.int32(chain_start), jnp.asarray(q0.T),
            jnp.asarray(var.T), jnp.asarray(eps), [])
    want = {k: _to_port_layout(k, v) for k, v in o.items()}
    got = tnc.nuts_block_plain(seed, torch.as_tensor(q0),
                               torch.as_tensor(var), torch.as_tensor(eps),
                               MAXDEPTH, MAX_CHANGE, tnc.plain_lpg(den_t),
                               chain_start)
    assert set(got) == set(want)
    _compare(got, want, *momenta)
    assert want['diverging'].any() and (want['tree_depth'] > 1).any()


# ---------------------------------------------------------------------------
# The route

def _counting(calls, name, f):
    def wrapped(*a, **kw):
        calls[name] += 1
        return f(*a, **kw)
    return wrapped


@pytest.mark.parametrize('name', list(BUILDERS))
def test_anchor_samples_on_the_chunk_kernels(name, monkeypatch):
    """Under 'auto' an anchor's every transition is in a chunk launch (here
    its plain version), none on the tree loop or the block kernel; under
    'cuda' the same route on CPU tensors raises instead of leaving the
    kernels."""
    import bayesfast_tpu_torch as bt
    den, extra = BUILDERS[name]()
    calls = collections.Counter()
    for n in ('nuts_chunk_batched', 'nuts_warmup_chunk_batched',
              'nuts_transition_batched'):
        monkeypatch.setattr(tnc, n, _counting(calls, n, getattr(tnc, n)))
    t0 = ttree.nuts_transition_batched.transitions

    def run():
        return bt.sample(den, bt.NTrace(n_chain=4, n_iter=6, n_warmup=3,
                                        random_generator=1, **extra),
                         verbose=False)

    tt = run()
    assert ttree.nuts_transition_batched.transitions == t0
    assert calls['nuts_warmup_chunk_batched'] > 0
    assert calls['nuts_chunk_batched'] > 0
    assert calls['nuts_transition_batched'] == 0
    assert np.isfinite(tt.get()).all()
    monkeypatch.setattr(tconfig, '_nuts_kernel', 'cuda')
    with pytest.raises(RuntimeError, match='needs CUDA tensors'):
        run()
