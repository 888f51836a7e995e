"""The port's constraint transforms against the JAX package's."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bayesfast_tpu.ops import constraint as jcon
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.ops import constraint as tcon


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


_D = 6
_SCALES = np.array([[-2., 3.], [0., 1.], [-15., 15.], [1., 4.],
                    [-5., -1.], [0.5, 2.5]])
# both bounds, lower only, upper only, none
_BOUNDS = [True, False,
           np.array([[1, 1], [1, 0], [0, 1], [0, 0], [1, 1], [1, 0]], bool)]
_FNS = ['from_original', 'from_original_grad', 'from_original_grad2',
        'to_original', 'to_original_grad', 'to_original_grad2']


def _x_orig(n=50):
    u = np.random.default_rng(1).uniform(0.02, 0.98, size=(n, _D))
    return _SCALES[:, 0] + u * (_SCALES[:, 1] - _SCALES[:, 0])


def _x_trans(n=50):
    return np.random.default_rng(2).normal(size=(n, _D)) * 3.0


@pytest.mark.parametrize('name', _FNS)
@pytest.mark.parametrize('bi', range(len(_BOUNDS)))
def test_transforms_and_numpy_twins(name, bi):
    bounds = _BOUNDS[bi]
    x = _x_orig() if name.startswith('from') else _x_trans()
    want = np.asarray(getattr(jcon, name)(x, _SCALES, bounds))
    got = getattr(tcon, name)(torch.as_tensor(x), _SCALES, bounds).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    twin = getattr(tcon, 'np_' + name)(x, _SCALES, bounds)
    np.testing.assert_allclose(twin, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize('bi', range(len(_BOUNDS)))
def test_to_original_with_logdet_value_and_grad(bi):
    bounds = _BOUNDS[bi]
    rng = np.random.default_rng(3)
    # finite |x| <= 85, including the clamp edge
    x = np.concatenate([rng.normal(size=(40, _D)) * 5.0,
                        np.full((1, _D), 85.0), np.full((1, _D), -85.0)])
    r = rng.normal(size=_D)

    def f_j(xx):
        x_o, logdet = jcon.to_original_with_logdet(xx, _SCALES, bounds)
        return jnp.sum(x_o * r) + logdet

    v_j, g_j = jax.vmap(jax.value_and_grad(f_j))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    x_o, logdet = tcon.to_original_with_logdet(xt, _SCALES, bounds)
    want_xo, want_ld = jcon.to_original_with_logdet(jnp.asarray(x), _SCALES,
                                                    bounds)
    # one-sided branches reach e^85 at the clamp edge: an ulp there is 1e21
    np.testing.assert_allclose(x_o.detach().numpy(), np.asarray(want_xo),
                               rtol=1e-14, atol=1e-12)
    np.testing.assert_allclose(logdet.detach().numpy(), np.asarray(want_ld),
                               rtol=1e-12, atol=1e-12)
    v = torch.sum(x_o * torch.as_tensor(r), dim=-1) + logdet
    (g,) = torch.autograd.grad(v.sum(), xt)
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(v_j),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-12,
                               atol=1e-12)
