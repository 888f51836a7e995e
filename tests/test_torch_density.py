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
    # a logp outside the kernels' op set (abs): a traceable one has a spec
    den = DensityLite(logp=lambda x: -0.5 * torch.sum(torch.abs(x) ** 2,
                                                      dim=-1),
                      input_size=2)
    with pytest.raises(NotImplementedError):
        den.kernel_spec()


# ---------------------------------------------------------------------------
# The batch convention: logp(x (..., D)) -> (...)

def _quad_point(x):
    """-0.5 |x|^2 of one point, the JAX package's form of a logp."""
    return -0.5 * (x * x).sum()


def _quad_batch(x):
    """The same logp in the port's batched form."""
    return -0.5 * torch.sum(x * x, dim=-1)


@pytest.mark.parametrize('original_space', [True, False],
                         ids=['original', 'transformed'])
def test_single_point_logp_raises(original_space):
    """A logp written for one point sums the batch: every host and device
    evaluation of it raises, naming the port's batched convention, where
    the port used to return the sum (-2.75 on [[1, 2], [0.5, -0.5]],
    where the JAX package returns [-2.5, -0.25])."""
    bounds = np.array([[-4., 4.], [-3., 5.]])
    den = DensityLite(logp=_quad_point, input_size=2, input_scales=bounds,
                      hard_bounds=True)
    x = np.array([[1., 2.], [0.5, -0.5]])
    if not original_space:
        x = den.from_original(x)
    for call in (den.logp, den.logp_and_grad, den.grad):
        with pytest.raises(ValueError, match=r'batch \(\.\.\., D\)'):
            call(x, original_space=original_space)
    xt = torch.as_tensor(x)
    with pytest.raises(ValueError, match='one value a point'):
        den.device_logp(original_space)(xt)
    with pytest.raises(ValueError, match='one value a point'):
        den.device_logp_and_grad(original_space)((), xt)
    # one point of a batch of shape (D,): a scalar is its batch shape
    lp = den.device_logp(True)(torch.tensor([1., 2.], dtype=torch.float64))
    assert lp.shape == () and float(lp) == -2.5


def test_batched_logp_matches_jax_row_by_row():
    """The batched torch form of a logp against the JAX DensityLite over
    its one-point form, row by row, in both spaces (float64)."""
    rng = np.random.default_rng(11)
    D = 5
    bounds = np.stack([np.full(D, -3.), np.full(D, 4.)]).T
    cen = rng.normal(size=D)
    scale = np.exp(rng.normal(size=D) * 0.3)

    def point_j(x):
        return -0.5 * jnp.sum(((x - cen) / scale) ** 2) + jnp.sum(
            jnp.sin(x))

    def batch_t(x):
        c, s = torch.as_tensor(cen).to(x), torch.as_tensor(scale).to(x)
        return -0.5 * torch.sum(((x - c) / s) ** 2, dim=-1) + torch.sum(
            torch.sin(x), dim=-1)

    den_j = bf.DensityLite(logp=point_j, input_size=D, input_scales=bounds,
                           hard_bounds=True)
    den_t = DensityLite(logp=batch_t, input_size=D, input_scales=bounds,
                        hard_bounds=True)
    xo = rng.uniform(-2.5, 3.5, size=(16, D))
    for x, os_ in ((xo, True), (den_t.from_original(xo), False)):
        lp_j = np.asarray(den_j.logp(x, original_space=os_))
        lp_t = den_t.logp(x, original_space=os_)
        assert lp_t.shape == (16,)
        np.testing.assert_allclose(lp_t, lp_j, rtol=1e-12)
        lj, gj = den_j.logp_and_grad(x, original_space=os_)
        lt, gt = den_t.logp_and_grad(x, original_space=os_)
        np.testing.assert_allclose(lt, np.asarray(lj), rtol=1e-12)
        np.testing.assert_allclose(gt, np.asarray(gj), rtol=1e-12,
                                   atol=1e-12 * np.abs(np.asarray(gj)).max())
        for i in range(len(x)):  # each row as its own batch of one
            np.testing.assert_allclose(
                den_t.logp(x[i:i + 1], original_space=os_)[0], lp_j[i],
                rtol=1e-12)


def test_sample_with_batched_logp_unchanged(monkeypatch):
    """sample() on a batched logp draws what it drew without the check:
    the check is a shape comparison that changes no evaluation."""
    import warnings
    import bayesfast_tpu_torch as bt
    from bayesfast_tpu_torch.core import density as tdensity

    def run():
        den = DensityLite(logp=_quad_batch, input_size=3)
        bt.utils.set_generator(5)
        with warnings.catch_warnings():
            warnings.simplefilter('ignore', RuntimeWarning)
            return bt.sample(den, {'n_chain': 4, 'n_iter': 40,
                                   'n_warmup': 20}, verbose=False)

    checked = run()
    monkeypatch.setattr(tdensity.DensityLite, '_logp_x',
                        lambda self, x: self._logp(x))
    unchecked = run()
    assert checked.samples.shape[0] == 4 and checked.samples.shape[-1] == 3
    assert np.isfinite(checked.samples).all()
    assert np.array_equal(checked.samples, unchecked.samples)
    assert np.array_equal(checked.logp, unchecked.logp)
