"""The port's counter RNG and host schedules against the JAX package's.

The NUTS chunk kernels draw every random number from a stateless counter
RNG (``bayesfast_tpu/samplers/nuts_pallas.py:54-117``, ``:418-428``,
``:725-743``). The port reproduces it bit for bit in int64 torch
(``bayesfast_tpu_torch/samplers/nuts_cuda.py``); these tests hold the two
against each other.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bayesfast_tpu.samplers import nuts_pallas as jnpl
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.samplers import nuts_cuda as tnc


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


_C = 24


def _lanes(lane_off):
    return (torch.arange(_C, dtype=torch.int64) + lane_off) & 0xFFFFFFFF


def test_fmix32_bitwise():
    x = np.random.default_rng(0).integers(0, 2 ** 32, 4096, dtype=np.uint64)
    x = np.concatenate([x, [0, 1, 2 ** 31, 2 ** 32 - 1]]).astype(np.uint32)
    want = np.asarray(jnpl._fmix32(jnp.asarray(x, jnp.uint32)))
    got = tnc._fmix32(torch.as_tensor(x.astype(np.int64))).numpy()
    assert np.array_equal(got.astype(np.uint32), want)
    # the scalar form used for per-transition seeds
    assert all(tnc._fmix32(int(v)) == int(w) for v, w in zip(x[:64],
                                                             want[:64]))


@pytest.mark.parametrize('seed', [0, 1, 123456789, 2 ** 31 - 2])
@pytest.mark.parametrize('it', [-1, 0, 2 ** 20])
@pytest.mark.parametrize('salt,lane_off', [(0, 0), (3, 5), (7, 2 ** 31 + 17),
                                           (16, 1000)])
def test_uniforms_bitwise(seed, it, salt, lane_off):
    rows = 3
    want = np.asarray(jnpl._uniforms(
        jnp.uint32(seed), jnp.int32(it), salt, (rows, _C),
        jnp.uint32(lane_off)))
    got = tnc._uniforms(seed, it, salt, rows, _lanes(lane_off)).numpy().T
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize('seed,lane_off', [(99, 0), (2 ** 30 + 5, 77)])
def test_box_muller(seed, lane_off):
    D = 6
    want = np.asarray(jnpl._gauss_from_uniforms(
        jnp.uint32(seed), jnp.int32(-9), 16, (D, _C), jnp.uint32(lane_off)))
    got = tnc._gauss_from_uniforms(seed, -9, 16, D, _lanes(lane_off))
    assert got.dtype == torch.float32
    # float32 log/cos may differ by an ulp between the two libraries
    np.testing.assert_allclose(got.numpy().T, want, rtol=1e-6, atol=1e-7)


def test_transition_seed_bitwise():
    for seed, i0 in [(5, 0), (2 ** 31 - 2, 397), (123, 2 ** 31 - 1)]:
        for t in range(3):
            want = int(jnp.uint32(seed) ^ jnpl._fmix32(
                jnp.uint32(i0) + jnp.uint32(t) + jnp.uint32(0x9E3779B9)))
            assert tnc._transition_seed(seed, i0, t) == want


@pytest.mark.parametrize('max_treedepth', range(1, 13))
def test_schedule_table_equal(max_treedepth):
    """The kernels compute each leaf's schedule row from the leaf index
    (csrc/nuts.cu); its Python mirror equals every row of the table the
    JAX kernels read."""
    want = jnpl._schedule_table.__wrapped__(max_treedepth)
    got = np.asarray([tnc._leaf_schedule(it, max_treedepth)
                      for it in range(want.shape[1])], want.dtype).T
    assert np.array_equal(got, want)


@pytest.mark.parametrize('args', [(0, 0, 60, 64, 1, True),
                                  (64, 0, 60, 64, 1, True),
                                  (130, 61, 120, 37, 3, False),
                                  (5, 2, 3, 17, 2, True)])
def test_window_schedule_equal(args):
    wf, wi = jnpl._window_schedule.__wrapped__(*args)
    tf, ti = tnc._window_schedule.__wrapped__(*args)
    assert np.array_equal(tf, wf) and ti == wi

