"""The port's Sobol sequence against the JAX package's."""

import numpy as np
import pytest

from bayesfast_tpu.utils import sobol as jsobol
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.utils import sobol as tsobol


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


@pytest.mark.parametrize('n,d,skip', [(64, 1, 0), (1000, 5, 1),
                                      (257, 32, 1000), (33, 100, 2 ** 20)])
def test_sobol_integers_bitwise(n, d, skip):
    assert np.array_equal(tsobol.direction_numbers(d),
                          jsobol.direction_numbers(d))
    want = np.asarray(jsobol.sobol_uint32(n, d, skip)).astype(np.int64)
    got = tsobol.sobol_uint32(n, d, skip).numpy()
    assert np.array_equal(got, want)


def test_uniform_equal():
    low, high = np.array([-1., 0., 2.]), np.array([1., 5., 2.5])
    np.testing.assert_array_equal(tsobol.uniform(low, high, 300, skip=3),
                                  jsobol.uniform(low, high, 300, skip=3))


@pytest.mark.parametrize('d,size', [(4, 64), (32, 1024)])
def test_multivariate_normal(d, size):
    rng = np.random.default_rng(d)
    mean = rng.normal(size=d)
    L = rng.normal(size=(d, d)) / d
    cov = L @ L.T + np.eye(d)
    want = jsobol.multivariate_normal(mean, cov, size)
    got = tsobol.multivariate_normal(mean, cov, size)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
