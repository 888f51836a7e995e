"""The port's DensityLite and compiled-in densities against the JAX
package's DensityLite, on the bench's bounded rotated banana."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.stats import special_ortho_group

import bayesfast_tpu as bf
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.core.density import DensityLite
from bayesfast_tpu_torch.interop import (banana_density, cauchy_density,
                                         funnel_density, ring_density)
from bayesfast_tpu_torch.ops.densities import (DiagGaussian,
                                               spec_logp_and_grad)


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


def _bench_banana_jax(A, Q, bounds, const):
    """``bench.py:129-149`` at float64."""
    D = A.shape[0]
    Aj = jnp.asarray(A)
    even = jnp.asarray((np.arange(D) % 2) == 0, jnp.float64)

    def logp(x):
        z = x @ Aj.T
        zn = jnp.roll(z, -1, axis=-1)
        t = (z * z - zn) ** 2 / Q + (z - 1.0) ** 2
        return -jnp.sum(t * even) - const

    return bf.DensityLite(logp=logp, input_size=D, input_scales=bounds,
                          hard_bounds=True)


def _bench_setup(D=32):
    A = special_ortho_group.rvs(D, random_state=0)
    bounds = np.stack([np.full(D, -15.), np.full(D, 15.)]).T
    const = float(np.sum(np.log(bounds[:, 1] - bounds[:, 0])))
    return A, bounds, const


def test_bench_banana_logp_grad_matches_jax():
    D = 32
    A, bounds, const = _bench_setup(D)
    den_j = _bench_banana_jax(A, 0.01, bounds, const)
    den_t = banana_density(A, 0.01, bounds, const)
    # transformed-space points around the banana's ridge and further out
    rng = np.random.default_rng(0)
    xo = (A.T @ np.ones(D))[None] + rng.normal(size=(64, D)) * 0.2
    x = np.concatenate([den_t.from_original(xo),
                        rng.normal(size=(64, D)) * 2.0])
    lpg_j = den_j.device_logp_and_grad(original_space=False)
    lp_j, g_j = jax.vmap(lambda xx: lpg_j((), xx))(jnp.asarray(x))
    lp_t, g_t = den_t.device_logp_and_grad(original_space=False)(
        (), torch.as_tensor(x))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-10)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(g_j)).max())
    # the host numpy API and the back-transform
    np.testing.assert_allclose(den_t.logp(x, original_space=False),
                               np.asarray(lp_j), rtol=1e-10)
    np.testing.assert_allclose(den_t.to_original(x), den_j.to_original(x),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        den_t.to_original_density(lp_t.numpy(), x_trans=x),
        den_j.to_original_density(np.asarray(lp_j), x_trans=x), rtol=1e-12)


def _specs():
    A5 = special_ortho_group.rvs(5, random_state=3)
    A32, bounds32, const32 = _bench_setup(32)
    mixed = np.array([[1, 1], [1, 0], [0, 1], [0, 0], [1, 1]], bool)
    sc5 = np.array([[-3., 3.], [-1., 2.], [-4., 5.], [0., 2.], [-2., 6.]])
    return {
        'banana32': banana_density(A32, 0.01, bounds32, const32),
        'banana5_mixed': DensityLite(
            logp=banana_density(A5, 0.05)._logp, input_size=5,
            input_scales=sc5, hard_bounds=mixed),
        'gaussian_unbounded': DensityLite(
            logp=DiagGaussian([1., -2., 0.5], [0.5, 2., 1.]), input_size=3),
        # the GBS anchors (ring and cauchy also past one element a lane)
        'funnel16': funnel_density()[0],
        'ring64': ring_density()[0],
        'ring40': ring_density(40)[0],
        'cauchy48': cauchy_density()[0],
        'cauchy36': cauchy_density(36)[0],
    }


_ANCHORS = ['funnel16', 'ring64', 'ring40', 'cauchy48', 'cauchy36']


@pytest.mark.parametrize('name', ['banana32', 'banana5_mixed',
                                  'gaussian_unbounded'] + _ANCHORS)
def test_kernel_spec_analytic_grad_matches_autograd(name):
    den = _specs()[name]
    D = den.input_size
    x = torch.as_tensor(np.random.default_rng(4).normal(size=(50, D)))
    lp_a, g_a = den.device_logp_and_grad(False)((), x)
    lp_s, g_s = spec_logp_and_grad(den.kernel_spec(), x)
    np.testing.assert_allclose(lp_s.numpy(), lp_a.numpy(), rtol=1e-12)
    np.testing.assert_allclose(g_s.numpy(), g_a.numpy(), rtol=1e-10,
                               atol=1e-10 * g_a.abs().max().item())


@pytest.mark.parametrize('name', ['banana32', 'banana5_mixed',
                                  'gaussian_unbounded'] + _ANCHORS)
def test_dense_order_matches_kernel_order(name):
    """The analytic form in dense torch calls (what the samplers without a
    kernel evaluate) against the kernels' order of operations."""
    den = _specs()[name]
    x = torch.as_tensor(np.random.default_rng(5).normal(
        size=(50, den.input_size)))
    lp_o, g_o = spec_logp_and_grad(den.kernel_spec(), x)
    lp_d, g_d = spec_logp_and_grad(den.kernel_spec(), x, ordered=False)
    np.testing.assert_allclose(lp_d.numpy(), lp_o.numpy(), rtol=1e-12)
    np.testing.assert_allclose(g_d.numpy(), g_o.numpy(), rtol=1e-12,
                               atol=1e-12 * g_o.abs().max().item())


def test_plain_logp_has_no_kernel_spec():
    den = DensityLite(logp=lambda x: -0.5 * torch.sum(x ** 2, dim=-1),
                      input_size=2)
    with pytest.raises(NotImplementedError):
        den.kernel_spec()
