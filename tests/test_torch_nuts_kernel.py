"""The port's plain chunk transitions against the JAX Pallas chunk kernels.

``nuts_chunk_plain`` and ``nuts_warmup_chunk_plain`` (the plain torch
versions of the CUDA kernels in ``bayesfast_tpu_torch/csrc/nuts.cu``) are
held against ``make_nuts_pallas_multi(...).run`` and
``make_nuts_pallas_warmup(...).run`` in interpret mode, on a bounded rotated
banana with the same int32 seed, ``i0`` and ``chain_start``.

Tolerances: the discrete tree statistics (depth, size, divergence) must be
exactly equal. Both sides draw the same float32 uniforms bit for bit
(``test_torch_rng.py``), but XLA's float32 ``log``/``cos``/``sqrt`` are not
correctly rounded, so about one Box-Muller momentum in ten differs from
torch's by an ulp; the banana's trajectories carry that ~1e-7 relative
difference, amplified along the tree. With the real momenta, floats agree
to rtol 1e-6, atol 1e-8. With both sides' Box-Muller replaced by the same
correctly rounded one (float64 math rounded to float32), the momenta are
identical and every float agrees to rtol 1e-9: what is left is summation
order. Energy differences (``energy_change``, ``max_de``) carry the absolute
error of the energies, so their atol scales with the energy.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.stats import special_ortho_group

import bayesfast_tpu as bf
from bayesfast_tpu.samplers import nuts_pallas as jnpl
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.interop import banana_density
from bayesfast_tpu_torch.samplers import nuts_cuda as tnc
from bayesfast_tpu_torch.samplers.metrics import init_diag_metric
from bayesfast_tpu_torch.samplers.step_size import init_step_size


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


D, C, K, MAXDEPTH, Q = 4, 16, 3, 6, 0.1
MAX_CHANGE = 1000.


def _setup(D=D):
    A = special_ortho_group.rvs(D, random_state=1)
    bounds = np.stack([np.full(D, -15.), np.full(D, 15.)]).T
    Aj = jnp.asarray(A)
    even = jnp.asarray((np.arange(D) % 2) == 0, jnp.float64)

    def logp(x):
        z = x @ Aj.T
        zn = jnp.roll(z, -1, axis=-1)
        t = (z * z - zn) ** 2 / Q + (z - 1.0) ** 2
        return -jnp.sum(t * even)

    den_j = bf.DensityLite(logp=logp, input_size=D, input_scales=bounds,
                           hard_bounds=True)
    den_t = banana_density(A, Q, bounds)
    rng = np.random.default_rng(0)
    # starts around the banana's ridge, per-chain metric and step size;
    # two chains get a step size large enough to diverge
    xo = (A.T @ np.ones(D))[None] + rng.normal(size=(C, D)) * 0.05
    q0 = np.asarray(den_t.from_original(xo))
    var = np.exp(rng.normal(size=(C, D)) * 0.2) * 1e-3
    eps = np.exp(rng.normal(size=C) * 0.3) * 0.3
    eps[:2] *= 40.0
    return den_j, den_t, q0, var, eps


def _lpg(den_t):
    f = den_t.device_logp_and_grad(original_space=False)
    return lambda x: f((), x)


def _to_port_layout(name, a):
    """JAX kernel layouts (lane-minor) to the port's."""
    a = np.asarray(a)
    if a.ndim == 3 and a.shape[1] == 1:      # (K, 1, C) rows
        return a[:, 0]
    if a.ndim == 3:                          # (K, D, C)
        return np.swapaxes(a, 1, 2)
    if a.shape[0] == 1:                      # (1, C)
        return a[0]
    return a.T                               # (D, C)


def _compare(got, want, rtol=1e-6, atol=1e-8):
    scale = np.abs(want['energy']).max()
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape, k
        if k in ('tree_depth', 'tree_size', 'diverging'):
            assert np.array_equal(g, w), k
        elif k in ('energy_change', 'max_de'):
            np.testing.assert_allclose(g, w, rtol=rtol,
                                       atol=atol + rtol * scale, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=k)


_TWO_PI_F32 = float(np.float32(2 * np.pi))


def _gauss_rounded_jax(seed, counter, salt, shape, lane_off):
    u1 = jnpl._uniforms(seed, counter, salt, shape, lane_off)
    u2 = jnpl._uniforms(seed, counter, salt + 1, shape, lane_off)
    u1, u2 = u1.astype(jnp.float64), u2.astype(jnp.float64)
    return (jnp.sqrt(-2.0 * jnp.log(1.0 - u1))
            * jnp.cos(_TWO_PI_F32 * u2)).astype(jnp.float32)


def _gauss_rounded_torch(seed, counter, salt, rows, lane):
    u1 = tnc._uniforms(seed, counter, salt, rows, lane).double()
    u2 = tnc._uniforms(seed, counter, salt + 1, rows, lane).double()
    return (torch.sqrt(-2.0 * torch.log(1.0 - u1))
            * torch.cos(_TWO_PI_F32 * u2)).float()


def use_rounded_momenta(monkeypatch):
    """Replace both packages' Box-Muller with the same correctly rounded
    one; returns the float tolerances (rtol, atol) that then hold."""
    monkeypatch.setattr(jnpl, '_gauss_from_uniforms', _gauss_rounded_jax)
    monkeypatch.setattr(tnc, '_gauss_from_uniforms', _gauss_rounded_torch)
    return 1e-9, 1e-10


@pytest.fixture(params=['real', 'rounded'])
def momenta(request, monkeypatch):
    """'real': both packages' own float32 Box-Muller; 'rounded': the same
    correctly rounded Box-Muller on both sides. Returns the float
    tolerances (rtol, atol) for the case."""
    if request.param == 'real':
        return 1e-6, 1e-8
    return use_rounded_momenta(monkeypatch)


@pytest.mark.parametrize('seed,i0,chain_start', [(123456789, 7, 0),
                                                 (2 ** 31 - 2, 400, 1000)])
def test_frozen_chunk_matches_pallas(seed, i0, chain_start, momenta):
    den_j, den_t, q0, var, eps = _setup()
    run = jnpl.make_nuts_pallas_multi(
        den_j.device_logp_and_grad(False), (), D, C, K, MAXDEPTH,
        MAX_CHANGE, jnp.float64, interpret=True)
    o = run(jnp.int32(seed), jnp.int32(i0), jnp.int32(chain_start),
            jnp.asarray(q0.T), jnp.asarray(var.T), jnp.asarray(eps)[None],
            [])
    want = {k: _to_port_layout(k, v) for k, v in o.items()}
    got = tnc.nuts_chunk_plain(
        seed, torch.as_tensor(q0), torch.as_tensor(var),
        torch.as_tensor(eps), K, MAXDEPTH, MAX_CHANGE, _lpg(den_t), i0,
        chain_start)
    _compare(got, want, *momenta)
    # the case covers divergence, max depth and ordinary trees
    assert want['diverging'].any() and (want['tree_depth'] == MAXDEPTH).any()
    assert (want['tree_depth'] < MAXDEPTH).sum() > C


def _warm_inputs(q0, var, eps):
    rng = np.random.default_rng(5)
    log_step = np.log(eps)
    step = (log_step, log_step + 0.1, rng.normal(size=C) * 0.01,
            np.full(C, 5.0), np.log(10 * eps))
    metric = (var, q0 + rng.normal(size=(C, D)) * 0.01, var * 10.0,
              np.full(C, 10.0), q0, var * 3.0, np.full(C, 3.0))
    return step, metric


@pytest.mark.parametrize('adapt_step,adapt_metric', [(True, True),
                                                     (False, True),
                                                     (True, False)])
def test_warmup_chunk_matches_pallas(adapt_step, adapt_metric, monkeypatch):
    tol = use_rounded_momenta(monkeypatch)
    den_j, den_t, q0, var, eps = _setup()
    eps[:2] /= 40.0
    step, metric = _warm_inputs(q0, var, eps)
    # a refresh on every other step and a window switch inside the chunk
    wsched, _ = jnpl._window_schedule(4, 0, 5, K, 2, True)
    assert wsched[0].any() and wsched[1].any()
    seed, i0, chain_start = 987654321, 33, 0
    args = (0.8, 0.05, 0.75, 10.)
    run = jnpl.make_nuts_pallas_warmup(
        den_j.device_logp_and_grad(False), (), D, C, K, MAXDEPTH,
        MAX_CHANGE, jnp.float64, wsched, *args, adapt_step, adapt_metric,
        interpret=True)
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
        *args, adapt_step, adapt_metric, wsched, _lpg(den_t), i0,
        chain_start)
    # every output, the whole final adaptation state included
    assert set(got) == set(want)
    _compare(got, want, *tol)


def test_chain_start_split_is_bitwise():
    """Chains [0, C) in one call equal [0, C/2) and [C/2, C) with the
    matching chain_start: the property mesh-sharded runs rest on."""
    _, den_t, q0, var, eps = _setup()
    q0, var, eps = (torch.as_tensor(a) for a in (q0, var, eps))
    h = C // 2
    args = (K, MAXDEPTH, MAX_CHANGE, _lpg(den_t), 11)
    full = tnc.nuts_chunk_plain(5, q0, var, eps, *args, 0)
    a = tnc.nuts_chunk_plain(5, q0[:h], var[:h], eps[:h], *args, 0)
    b = tnc.nuts_chunk_plain(5, q0[h:], var[h:], eps[h:], *args, h)
    for k in full:
        cat = torch.cat([a[k], b[k]], dim=-2 if k in ('q', 'q_final')
                        else -1)
        assert torch.equal(full[k], cat), k


def test_wrappers_on_cpu():
    """On CPU tensors the wrappers run the plain versions (and count no
    launch); kernel='cuda' raises instead of falling back."""
    _, den_t, q0, var, eps = _setup()
    q0t = torch.as_tensor(q0)
    metric = init_diag_metric(q0t, torch.as_tensor(var))
    n0 = tnc.nuts_chunk_batched.launches
    qs, q_last, stats = tnc.nuts_chunk_batched(
        3, q0t, metric, torch.as_tensor(eps), 2, MAXDEPTH, MAX_CHANGE,
        density=den_t, i0=4)
    ref = tnc.nuts_chunk_plain(3, q0t, torch.as_tensor(var),
                               torch.as_tensor(eps), 2, MAXDEPTH,
                               MAX_CHANGE, tnc.plain_lpg(den_t), 4)
    assert torch.equal(qs, ref['q']) and torch.equal(q_last, ref['q_final'])
    assert torch.equal(stats.tree_size, ref['tree_size'])
    assert tnc.nuts_chunk_batched.launches == n0
    with pytest.raises(RuntimeError):
        tnc.nuts_chunk_batched(3, q0t, metric, torch.as_tensor(eps), 2,
                               MAXDEPTH, MAX_CHANGE, density=den_t,
                               kernel='cuda')
    with pytest.raises(RuntimeError):
        tnc.nuts_warmup_chunk_batched(
            3, q0t, init_step_size(torch.as_tensor(eps)), metric, 2, MAXDEPTH, MAX_CHANGE, 0.8, 0.05, 0.75,
            10., True, True, np.zeros((2, 2), np.int32), density=den_t,
            kernel='cuda')


def test_driver_torch_mode_matches_auto_on_cpu():
    """nuts_kernel='torch' calls the plain versions directly; on CPU tensors
    'auto' reaches the same plain versions through the wrappers."""
    from bayesfast_tpu_torch.samplers.chain import ChainCarry, ChainDriver
    _, den_t, q0, var, eps = _setup()
    q0t = torch.as_tensor(q0)
    carry = ChainCarry(17, q0t, init_step_size(torch.as_tensor(eps)),
                       init_diag_metric(q0t, torch.as_tensor(var), 10., 2))
    outs = []
    for mode in ('auto', 'torch'):
        drv = ChainDriver(den_t, max_treedepth=MAXDEPTH, nuts_kernel=mode)
        c, (qw, (sw, ew)), wi = drv.run_warmup_chunk(carry, 3)
        c, (qf, (sf, _)) = drv.run_frozen_chunk(c, 2, i0=3)
        outs.append((qw, *sw, *ew.values(), wi, qf, *sf, c.q,
                     *c.step, c.metric.var))
    for a, b in zip(*outs):
        assert (a == b) if isinstance(a, tuple) else torch.equal(a, b)
