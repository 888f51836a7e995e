"""The port's KDE cdf (``ops/kde.py``) and ``utils/kde.py`` against the JAX
package's.

* The exact form of the plain version (the CUDA kernel's twin) against
  ``kde_pallas._cdf_batch_impl``, float64: both sum exactly the same terms,
  in another order, so abs 1e-12.
* The A&S form against the Pallas kernel ``_pallas_kernel`` run through
  ``pl.pallas_call(..., interpret=True)`` with ``_cdf_impl``'s BlockSpecs
  and padding, float32: the Pallas kernel sums each block of 1024 terms in
  float32 and the plain version in float64, so abs 2e-6.
* ``utils.kde``'s bandwidth and ``logpdf`` (host numpy on both sides) to
  rel 1e-12; its ``cdf`` against the JAX host path to abs 1e-12.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from bayesfast_tpu.ops import kde_pallas as jkp
from bayesfast_tpu.utils.kde import kde as jkde
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.ops import kde as tkp
from bayesfast_tpu_torch.utils.kde import kde as tkde


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


def _inputs(D, M, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(D, M)) * 2.0
    data = rng.standard_t(4, size=(D, N))
    w = rng.uniform(0.1, 1.0, size=N)
    return x, data, w / w.sum(), rng.uniform(0.05, 0.5, size=D)


@pytest.mark.parametrize('D,M,N', [(1, 300, 1024), (3, 200, 3000),
                                   (5, 64, 2500)])
def test_exact_plain_matches_cdf_batch_impl(D, M, N):
    x, data, w, h = _inputs(D, M, N, D)
    pad = (-N) % jkp._BLK_N   # the JAX wrapper's padding of the data axis
    dp = np.concatenate([data, np.full((D, pad), 1e30)], axis=1)
    wp = np.concatenate([w, np.zeros(pad)])
    want = np.asarray(jkp._cdf_batch_impl(jnp.asarray(x), jnp.asarray(dp),
                                          jnp.asarray(wp), jnp.asarray(h)))
    got = tkp.kde_cdf_batch(*(torch.as_tensor(a) for a in (x, data, w, h)))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def _pallas_interpret(x, data, w, h):
    """``_cdf_impl(use_pallas=True)`` with ``interpret=True``: the same
    padding, grid and BlockSpecs (``kde_pallas.py:84-110``)."""
    n_x = x.shape[0]
    xp = jkp._pad_rows(x, jkp._BLOCK_X, 0.0)
    r = (-xp.shape[0]) % jkp._ROWS
    if r:
        xp = jnp.concatenate([xp, jnp.zeros((r, jkp._BLOCK_X), xp.dtype)])
    dp = jkp._pad_rows(data, jkp._BLOCK_D, 1e30)
    wp = jkp._pad_rows(w, jkp._BLOCK_D, 0.0)
    out = pl.pallas_call(
        jkp._pallas_kernel,
        out_shape=jax.ShapeDtypeStruct(xp.shape, x.dtype),
        grid=(xp.shape[0] // jkp._ROWS,),
        in_specs=[
            pl.BlockSpec((jkp._ROWS, jkp._BLOCK_X), lambda i: (i, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pltpu.SMEM),
        ],
        out_specs=pl.BlockSpec((jkp._ROWS, jkp._BLOCK_X), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        interpret=True,
    )(xp, dp, wp, jnp.reshape(h, (1,)))
    return np.asarray(out).reshape(-1)[:n_x]


@pytest.mark.parametrize('M,N', [(300, 2000), (4100, 1024)])
def test_as_plain_matches_pallas_kernel(M, N):
    x, data, w, h = (a.astype(np.float32) for a in _inputs(1, M, N, M))
    want = _pallas_interpret(jnp.asarray(x[0]), jnp.asarray(data[0]),
                             jnp.asarray(w), jnp.asarray(h[0]))
    got = tkp.kde_cdf_device(torch.as_tensor(x[0]), torch.as_tensor(data[0]),
                             torch.as_tensor(w), float(h[0]), erf='as')
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


def test_device_form_is_the_batch_row_and_counts_no_launch():
    x, data, w, h = (torch.as_tensor(a) for a in _inputs(2, 50, 700, 9))
    before = tkp.kde_cdf_batch.launches
    for erf in ('exact', 'as'):
        row = tkp.kde_cdf_device(x[1], data[1], w, h[1], erf=erf)
        full = tkp.kde_cdf_batch(x, data, w, h, erf=erf)
        assert torch.equal(row, full[1])
        # the exact and A&S forms differ by the A&S error, < 1.5e-7
        assert (tkp.kde_cdf_batch(x, data, w, h, erf='as')
                - tkp.kde_cdf_batch(x, data, w, h)).abs().max() < 1.5e-7
    assert tkp.kde_cdf_batch.launches == before   # CPU: the plain version
    with pytest.raises(ValueError):
        tkp.kde_cdf_batch(x, data, w, h, erf='fast')
    with pytest.raises(ValueError):
        tkp.kde_cdf_batch(x, data[:, :10], w, h)
    with pytest.raises(ValueError):
        tkp.kde_cdf_batch(x, data, w.float(), h)


@pytest.mark.parametrize('bw,factor,weighted,d', [
    ('scott', 1.0, False, 1), ('silverman', 1.3, True, 1),
    ('scott', 0.7, True, 3), (0.4, 1.0, False, 2)])
def test_utils_kde_matches_jax(bw, factor, weighted, d):
    rng = np.random.default_rng(11)
    data = rng.normal(size=(800, d)) * np.arange(1, d + 1)
    w = rng.uniform(0.2, 1.0, size=800) if weighted else None
    kj = jkde(data if d > 1 else data[:, 0], bw, factor, w)
    kt = tkde(data if d > 1 else data[:, 0], bw, factor, w)
    np.testing.assert_allclose(kt.covariance, kj.covariance, rtol=1e-12)
    assert kt.neff == pytest.approx(kj.neff, rel=1e-12)
    pts = rng.normal(size=(40, d)) * 1.5
    np.testing.assert_allclose(kt.logpdf(pts), kj.logpdf(pts), rtol=1e-12)
    # the same numpy generator draws the same resample
    np.testing.assert_array_equal(
        kt.resample(30, np.random.default_rng(5)),
        kj.resample(30, np.random.default_rng(5)))
    if d == 1:
        q = np.linspace(-4.0, 4.0, 33)
        np.testing.assert_allclose(kt.cdf(q), kj.cdf(q), rtol=0, atol=1e-12)


def test_utils_kde_resample_with_torch_generator():
    k = tkde(np.random.default_rng(0).normal(size=(100, 2)))
    a = k.resample(20, torch.Generator().manual_seed(3))
    b = k.resample(20, torch.Generator().manual_seed(3))
    assert a.shape == (20, 2) and np.array_equal(a, b)


@pytest.mark.parametrize('erf', ['exact', 'as'])
@pytest.mark.parametrize('D,M,N', [(2, 100, 5000), (3, 64, 1037)])
def test_float32_groups_hold_to_float64(erf, D, M, N):
    """The plain version sums float32 terms in groups of ``_GROUP`` before
    its float64 sums; that costs under 2e-6 against the same inputs in
    float64."""
    x, data, w, h = _inputs(D, M, N, N)
    want = tkp.kde_cdf_batch_plain(
        *(torch.as_tensor(a) for a in (x, data, w, h)), erf=erf)
    got = tkp.kde_cdf_batch_plain(
        *(torch.as_tensor(a, dtype=torch.float32) for a in (x, data, w, h)),
        erf=erf)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize('N', [1, 7, 8, 511, 512, 513, 1030, 153600])
def test_split_plan_covers_every_point_once(N):
    """S splits of P points, P a multiple of the group and at most the
    split length, the last split short but not empty."""
    S, P = tkp._plan(N)
    assert P % tkp._GROUP == 0 and P <= tkp._SPLIT_N
    assert (S - 1) * P < N <= S * P
