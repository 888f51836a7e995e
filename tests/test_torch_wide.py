"""The CUDA NUTS kernels past D = 64 (``csrc/nuts_densities.cuh``'s units
of one compiled-in density at NE = 3..8, a traced functor at NE = 8 that
streams its matrices from device memory) and their routing, on the CPU.

* The port's plain chunk, warmup and block transitions against the JAX
  Pallas kernels in interpret mode (``make_nuts_pallas_multi`` /
  ``_warmup`` / ``make_nuts_pallas``, the same int32 seed), as
  ``tests/test_torch_trace.py`` holds them at D = 32: the compiled-in
  ``DiagGaussian`` at D = 72 (NE = 3), and Hoffman & Gelman's 250-d MVN
  (``examples/wide_gaussians.py``, NE = 8) traced, at a few chains, K = 2,
  depth 5. Tolerances are ``tests/test_torch_nuts_kernel.py``'s: the
  tree statistics exactly equal; floats to rtol 1e-6, atol 1e-8 with
  both packages' own float32 Box-Muller (about one momentum in ten
  differs by an ulp: XLA's float32 log / cos are not correctly rounded),
  and to rtol 1e-9, atol 1e-10 with the same correctly rounded one on
  both sides (what is left is the order of the sums: XLA's dot against
  the warp's order).
* Routing: ``kernel_refusal`` is None at D = 256 and names the limit at
  257; the compiled-in banana past its shared memory names its own (a
  ``Density`` plan's: ``tests/test_torch_wide_plan.py``).
* The generated source of an NE = 8 program whose matrices do not fit a
  block's shared memory streams them from device memory through shared
  tiles (``tests/test_torch_stream.py`` holds the schedule and the loop
  order), ``check_limits`` accepts it, and ``launch_params`` lays them out
  as the tiles are cut from them; the units of the compiled-in densities
  at NE = 3..8.
* The new module imports no JAX.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesfast_tpu as bf
from bayesfast_tpu.samplers import nuts_pallas as jnpl
import bayesfast_tpu_torch as bt
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.examples.wide_gaussians import mvn_250, neal_100
from bayesfast_tpu_torch.interop import banana_density
from bayesfast_tpu_torch.ops.codegen import (_Layout, check_limits,
                                             launch_params)
from bayesfast_tpu_torch.ops.densities import DENSITY_IDS
from bayesfast_tpu_torch.samplers import nuts_cuda as tnc
from test_torch_nuts_kernel import (_compare, _to_port_layout, momenta,  # noqa
                                    use_rounded_momenta)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_CHANGE = 1000.


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU,
    in float64."""
    old = tconfig.set_device('cpu')
    old_dtype = tconfig.get_dtype()
    tconfig.set_dtype(torch.float64)
    yield
    tconfig.set_device(old)
    tconfig.set_dtype(old_dtype)


def _gaussian_72():
    """The compiled-in ``DiagGaussian`` at D = 72 (NE = 3), mean 2,
    standard deviations 0.1 .. 1.0, and its jnp twin; per-chain metrics
    off the variances by a factor of ~2, so that trees run deep, and two
    steps large enough to diverge. (The mean keeps every position of
    order 1, where the real momenta's ulp is within rtol 1e-6; around 0
    it is not, for a position near 0.)"""
    D, C, K, depth = 72, 8, 3, 6
    sd = np.linspace(0.1, 1.0, D)
    mean = np.full(D, 2.0)
    den_t = bt.DensityLite(logp=bt.ops.DiagGaussian(mean, sd ** 2),
                           input_size=D)
    mean_j, var_j = jnp.asarray(mean), jnp.asarray(sd ** 2)

    def logp(x):
        return -0.5 * jnp.sum((x - mean_j) ** 2 / var_j)

    den_j = bf.DensityLite(logp=logp, input_size=D)
    rng = np.random.default_rng(3)
    q0 = mean + rng.normal(size=(C, D)) * sd
    var = sd ** 2 * np.exp(rng.normal(size=(C, D)) * 0.7)
    eps = np.exp(rng.normal(size=C) * 0.3) * 0.4
    eps[:2] *= 8.0
    return den_j, den_t, q0, var, eps, (D, C, K, depth)


def _mvn_250():
    """Hoffman & Gelman's MVN-250 traced, its jnp twin written per point
    (``x @ P @ x``), starts in its bulk, per-chain metrics around 1 /
    diag(P) and steps of the scale a run adapts to, two of them eighty
    times as long."""
    den_t, info = mvn_250()
    P = info['P']
    D, C, K, depth = 250, 4, 2, 5
    Pj = jnp.asarray(P)

    def logp(x):
        return -0.5 * x @ Pj @ x

    den_j = bf.DensityLite(logp=logp, input_size=D)
    rng = np.random.default_rng(4)
    q0 = np.linalg.solve(np.linalg.cholesky(P).T,
                         rng.normal(size=(D, C))).T
    var = np.exp(rng.normal(size=(C, D)) * 0.2) / np.diag(P)
    eps = np.exp(rng.normal(size=C) * 0.3) * 0.03
    eps[:2] *= 80.0
    return den_j, den_t, q0, var, eps, (D, C, K, depth)


CASES = {'gaussian_72': _gaussian_72, 'mvn_250': _mvn_250}


@pytest.mark.parametrize('case', list(CASES))
def test_frozen_chunk_matches_pallas(case, momenta):
    den_j, den_t, q0, var, eps, (D, C, K, depth) = CASES[case]()
    seed, i0, chain_start = 123456789, 7, 5
    run = jnpl.make_nuts_pallas_multi(
        den_j.device_logp_and_grad(False), (), D, C, K, depth, MAX_CHANGE,
        jnp.float64, interpret=True)
    o = run(jnp.int32(seed), jnp.int32(i0), jnp.int32(chain_start),
            jnp.asarray(q0.T), jnp.asarray(var.T), jnp.asarray(eps)[None],
            [])
    want = {k: _to_port_layout(k, v) for k, v in o.items()}
    got = tnc.nuts_chunk_plain(
        seed, torch.as_tensor(q0), torch.as_tensor(var),
        torch.as_tensor(eps), K, depth, MAX_CHANGE, tnc.plain_lpg(den_t),
        i0, chain_start)
    _compare(got, want, *momenta)
    # divergent and ordinary trees, some past the first doubling
    assert want['diverging'].any() and (want['tree_depth'] > 2).any()


@pytest.mark.parametrize('case', list(CASES))
def test_warmup_chunk_matches_pallas(case, monkeypatch):
    tol = use_rounded_momenta(monkeypatch)
    den_j, den_t, q0, var, eps, (D, C, K, depth) = CASES[case]()
    eps[:2] = eps[2:4]
    rng = np.random.default_rng(5)
    log_step = np.log(eps)
    step = (log_step, log_step + 0.1, rng.normal(size=C) * 0.01,
            np.full(C, 5.0), np.log(10 * eps))
    metric = (var, q0 + rng.normal(size=(C, D)) * 0.01, var * 10.0,
              np.full(C, 10.0), q0, var * 3.0, np.full(C, 3.0))
    # a refresh and a window switch inside the chunk
    wsched, _ = jnpl._window_schedule(4, 0, 5, K, 1, True)
    assert wsched[0].any() and wsched[1].any()
    seed, i0, args = 987654321, 33, (0.8, 0.05, 0.75, 10.)
    run = jnpl.make_nuts_pallas_warmup(
        den_j.device_logp_and_grad(False), (), D, C, K, depth, MAX_CHANGE,
        jnp.float64, wsched, *args, True, True, interpret=True)
    row = lambda a: jnp.asarray(a).reshape(1, C)  # noqa: E731
    mat = lambda a: jnp.asarray(a).T  # noqa: E731
    o = run(jnp.int32(seed), jnp.int32(i0), jnp.int32(0), jnp.asarray(q0.T),
            tuple(row(a) for a in step),
            (mat(metric[0]), mat(metric[1]), mat(metric[2]), row(metric[3]),
             mat(metric[4]), mat(metric[5]), row(metric[6])), [], wsched)
    want = {k: _to_port_layout(k, v) for k, v in o.items()}
    got = tnc.nuts_warmup_chunk_plain(
        seed, torch.as_tensor(q0), [torch.as_tensor(a) for a in step],
        [torch.as_tensor(a) for a in metric], K, depth, MAX_CHANGE, *args,
        True, True, wsched, tnc.plain_lpg(den_t), i0)
    assert set(got) == set(want)
    _compare(got, want, *tol)


@pytest.mark.parametrize('case', list(CASES))
def test_block_matches_pallas(case, momenta):
    den_j, den_t, q0, var, eps, (D, C, K, depth) = CASES[case]()
    seed, chain_start = 2 ** 31 - 2, 1000
    run = jnpl.make_nuts_pallas(den_j.device_logp_and_grad(False), (), D, C,
                                depth, MAX_CHANGE, jnp.float64,
                                interpret=True)
    o = run(jnp.int32(seed), jnp.int32(chain_start), jnp.asarray(q0.T),
            jnp.asarray(var.T), jnp.asarray(eps), [])
    want = {k: _to_port_layout(k, v) for k, v in o.items()}
    got = tnc.nuts_block_plain(seed, torch.as_tensor(q0),
                               torch.as_tensor(var), torch.as_tensor(eps),
                               depth, MAX_CHANGE, tnc.plain_lpg(den_t),
                               chain_start)
    assert set(got) == set(want)
    _compare(got, want, *momenta)
    assert want['diverging'].any()


# ---------------------------------------------------------------------------
# Routing

@pytest.mark.parametrize('make', [lambda: neal_100()[0], lambda: mvn_250()[0]],
                         ids=['compiled_in', 'traced'])
def test_refusal_names_the_limit_past_256(make):
    den = make()
    assert tnc.kernel_refusal(den, 256) is None
    assert tnc.kernel_refusal(den, den.input_size) is None
    why = tnc.kernel_refusal(den, 257)
    assert 'D <= 256' in why and '257' in why


def test_the_banana_past_its_shared_memory():
    """The compiled-in banana stages A and A^T: D = 160 fits a block in
    float32, 161 does not, nor 128 in float64."""
    for D, dt, ok in ((160, torch.float32, True), (161, torch.float32, False),
                      (96, torch.float64, True), (128, torch.float64, False)):
        den = banana_density(np.eye(D))
        why = tnc.kernel_refusal(den, D, dt)
        assert (why is None) == ok, (D, dt, why)
        if not ok:
            assert 'shared memory' in why and str(D) in why
        assert (tnc._banana_smem(D, dt.itemsize) <= tnc._MAX_SMEM) == ok


# ---------------------------------------------------------------------------
# The generated units

@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_mvn_reads_its_matrices_from_device_memory(dtype):
    """MVN-250's precision, read transposed and not, is past a block's
    shared memory in either dtype: the NE = 8 functor streams both from
    the launch's parameters through two shared-memory tiles of 32 rows x
    256 (+ padding) that the block's chains share (``tiled_matvec``, 8
    tiles a product, the second product's first tile 8), ``check_limits``
    accepts the program, and ``launch_params`` puts each matrix, as read,
    zero-padded to 256 rows of the row stride, at the offset the source
    names, 16-byte aligned, where the tiles are cut from it."""
    den, info = mvn_250()
    prog = den.kernel_spec()['program']
    itemsize = dtype.itemsize
    check_limits(prog, itemsize)
    src = prog.source(dtype)
    assert 'constexpr int NE = 8;' in src
    lay = _Layout(prog, itemsize)
    assert [m[1] for m in lay.mats] == [True, False]
    assert not any(m[7] for m in lay.mats)
    stride = 256 + 16 // itemsize
    packed = prog.pack(dtype)
    par = launch_params(prog, packed)
    assert torch.equal(par[:packed.numel()], packed)
    P = torch.as_tensor(info['P'], dtype=dtype)
    for k, (_, tr, m, n, rows, st, off, _) in enumerate(lay.mats):
        assert (m, n, rows, st) == (250, 250, 256, stride)
        assert off * itemsize % 16 == 0
        assert (f'// par + {off}: constant 0{" transposed" if tr else ""}, '
                f'250 x 250, 256 rows of {stride}, streamed' in src)
        assert (f'tiled_matvec<Real, 8, 8, 250, 8, {stride}, {8 * k}>'
                f'(*this, xbuf, ' in src)
        M = par[off:off + rows * st].view(rows, st)
        assert torch.equal(M[:250, :250], P.T if tr else P)
        assert not M[250:].any() and not M[:, 250:].any()
        assert [t[3] for t in lay.tiles[8 * k:8 * k + 8]] == [
            off + 32 * o * stride for o in range(8)]
    assert par.numel() == lay.params_end
    assert '__ldg' not in src and 'true>' not in src
    # nothing is staged: the block's shared memory holds the two tiles,
    # the x buffers and the tiles' two mbarriers (16 bytes)
    assert (f'kSmem = {2 * 32 * stride + 8 * 256 + 16 // itemsize};' in src
            and 'stage' in src)


def test_a_wide_matrix_at_small_d_traces():
    """A 4 x 1000 matrix at D = 4, read as 1024 rows of 34 doubles and
    its adjoint's 32 rows of 1026 (past a block's shared memory, once
    refused), traces: in float64 both stream from device memory, in
    float32 the first is staged and the second streams; the interpreter
    agrees with the eager function and autograd."""
    W = torch.as_tensor(np.random.default_rng(2).normal(size=(4, 1000)))

    def fn(x):
        return torch.sum(torch.exp(0.01 * (x @ W.to(x))), -1)

    prog = bt.ops.trace.trace_density(fn, 4, torch.float64)
    for dt, staged in ((torch.float32, [True, False]),
                       (torch.float64, [False, False])):
        check_limits(prog, dt.itemsize)
        assert [m[7] for m in _Layout(prog, dt.itemsize).mats] == staged
    x = torch.as_tensor(np.random.default_rng(3).normal(size=(3, 4)))
    lp, g = prog.logp_and_grad(x, prog.pack())
    xr = x.clone().requires_grad_(True)
    want = fn(xr)
    (g_want,) = torch.autograd.grad(want.sum(), xr)
    np.testing.assert_allclose(lp.numpy(), want.detach().numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), g_want.numpy(), rtol=1e-12)


def test_a_matrix_that_fits_stays_staged():
    """At D = 32 the banana's rotation is staged as before: the layout
    and the parameters are the packed constants alone."""
    from bayesfast_tpu_torch.examples.user_densities import bench_banana
    prog = bench_banana()[0].kernel_spec()['program']
    lay = _Layout(prog, 4)
    assert all(m[7] for m in lay.mats)
    packed = prog.pack(torch.float32)
    assert launch_params(prog, packed) is packed
    assert 'true>' not in prog.source(torch.float32)


@pytest.mark.parametrize('ne', range(3, 9))
def test_compiled_in_units_at_every_lane_width(ne):
    """One unit a (density, NE, dtype): its entry point instantiates
    ``launch_unit`` with them; the other densities and D <= 64 have
    none."""
    for name in ('banana', 'gaussian', 'funnel', 'ring', 'cauchy'):
        did = DENSITY_IDS[name]
        for dt, real in ((torch.float32, 'float'), (torch.float64, 'double')):
            src = tnc.wide_unit_source(did, 32 * ne, dt)
            assert f'launch_unit<{real}, {ne}, {did}>(' in src
            assert '#include "nuts_densities.cuh"' in src
            assert 'extern "C" int nuts_traced_launch(' in src
            assert src == tnc.wide_unit_source(did, 32 * ne - 31, dt)
    with pytest.raises(ValueError):
        tnc.wide_unit_source(DENSITY_IDS['poly_gaussian'], 32 * ne,
                             torch.float32)
    with pytest.raises(ValueError):
        tnc.wide_unit_source(DENSITY_IDS['traced'], 32 * ne, torch.float32)
    with pytest.raises(ValueError):
        tnc.wide_unit_source(DENSITY_IDS['gaussian'], 64, torch.float32)


def test_new_modules_import_no_jax():
    """The wide targets, the generator and the wrappers, imported in a
    fresh interpreter, load nothing of JAX or of the JAX package."""
    code = ('import sys; import bayesfast_tpu_torch.examples.wide_gaussians, '
            'bayesfast_tpu_torch.ops.codegen, '
            'bayesfast_tpu_torch.samplers.nuts_cuda; '
            'bad = [m for m in sys.modules if m == "jax" or '
            'm.startswith("jax.") or m == "bayesfast_tpu" or '
            'm.startswith("bayesfast_tpu.")]; '
            'print(bad); sys.exit(1 if bad else 0)')
    env = dict(os.environ, PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, '-c', code], env=env, cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
