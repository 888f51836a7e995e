"""The port's PolyModel against the JAX package's, on the CPU in float64.

The same numpy data go through ``bayesfast_tpu.modules.PolyModel`` and
``bayesfast_tpu_torch.modules.PolyModel``: the fitted coefficients (one
multi-RHS least-squares problem per group of outputs that share their
configs) agree to rtol 1e-8, and the evaluation, inside the bound ellipsoid
and beyond it (the linear extrapolation), to 1e-10.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bayesfast_tpu.modules import PolyConfig as JConfig, PolyModel as JPoly
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.interop import poly_from_numpy
from bayesfast_tpu_torch.modules import PolyConfig, PolyModel


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


D, M, N = 6, 24, 120

# name -> list of (order, input_mask, output_mask) per config
CASES = {
    'linear': [('linear', None, None)],
    'quadratic': [('linear', None, None), ('quadratic', None, None)],
    'masked': [('linear', None, None), ('quadratic', [0, 2, 4], None)],
    # outputs 0-9 carry a quadratic block, the rest do not: two groups
    'grouped': [('linear', None, None),
                ('quadratic', [1, 3, 5], list(range(10)))],
}


def _configs(cls, spec):
    return [cls(o, im, om) for o, im, om in spec]


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D))
    W = rng.normal(size=(M, D))
    y = x @ W.T + 0.3 * np.sin(x[:, :1] * x[:, 1:2]) + 0.1 * x[:, 2:3] ** 3
    logp = -0.5 * np.sum(x ** 2, axis=1)
    return x, y, logp


def _fit_both(case):
    x, y, logp = _data()
    pj = JPoly(_configs(JConfig, CASES[case]), input_size=D, output_size=M)
    pt = PolyModel(_configs(PolyConfig, CASES[case]), input_size=D,
                   output_size=M)
    pj.fit(x, y, logp)
    pt.fit(x, y, logp)
    return pj, pt


@pytest.mark.parametrize('case', list(CASES))
def test_fit_matches_jax(case):
    pj, pt = _fit_both(case)
    for cj, ct in zip(pj.configs, pt.configs):
        np.testing.assert_allclose(ct._a, np.asarray(cj._a), rtol=1e-8,
                                   atol=1e-10)
    if case != 'linear':
        np.testing.assert_allclose(pt._mu, pj._mu, rtol=1e-12)
        np.testing.assert_allclose(pt._hess, pj._hess, rtol=1e-10)
        np.testing.assert_allclose(pt._alpha, pj._alpha, rtol=1e-12)
        np.testing.assert_allclose(pt._f_mu, pj._f_mu, rtol=1e-8, atol=1e-10)
    assert pt.n_param == pj.n_param


@pytest.mark.parametrize('case', list(CASES))
def test_eval_inside_and_beyond_bound_matches_jax(case):
    """Evaluation of the JAX model's own state, carried across with
    ``poly_from_numpy``, at points inside the alpha-ellipsoid and far
    beyond it."""
    pj, _ = _fit_both(case)
    pt = poly_from_numpy(
        [(c.order, c.input_mask, c.output_mask, np.asarray(c._a))
         for c in pj.configs], pj._mu, pj._hess, pj._alpha, pj._f_mu,
        input_size=D, output_size=M)
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(size=(20, D)) * 0.3,
                        rng.normal(size=(20, D)) * 6.0])
    p = pj.dynamic_params()
    want = np.asarray(jax.vmap(lambda xi: pj._fun_traced(p, xi))(
        jnp.asarray(x)))
    got = pt._fun_traced(None, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    if case != 'linear':
        beta = np.sqrt(np.einsum('ij,jk,ik->i', x - pj._mu, pj._hess,
                                 x - pj._mu))
        assert (beta <= pj._alpha).any() and (beta > pj._alpha).any()


def test_single_point_call_and_errors():
    """The host wrapper takes one point; too few fit points raise."""
    pj, pt = _fit_both('masked')
    x = np.linspace(-1, 1, D)
    np.testing.assert_allclose(pt(x)[0], np.asarray(pj(x)[0]), rtol=1e-10,
                               atol=1e-10)
    with pytest.raises(ValueError):
        pt.fit(np.zeros((3, D)), np.zeros((3, M)))
    with pytest.raises(ValueError):
        PolyModel([PolyConfig('linear'), PolyConfig('linear')],
                  input_size=D, output_size=M)
