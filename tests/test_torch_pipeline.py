"""The port's module pipeline and its compiled-in surrogate density against
the JAX package, on the CPU in float64.

A DES-like pipeline at a small size (D = 6 parameters, a 24-dim data vector,
quadratic response in 3 of them): an external numpy model, a diagonal
Gaussian likelihood, hard bounds and the decay penalty, with a linear +
quadratic-on-3 PolyModel surrogate. The JAX density is fitted and its
state carried into the port (``interop.poly_from_numpy``,
``density_decay_from_numpy``), so both compute the same logp:

* ``Density.logp_and_grad`` with the surrogate, the decay and the bound
  transform agree to 1e-10;
* the plain version of the kernels' ``PolyGaussian`` density
  (``ops.densities.spec_logp_and_grad``) agrees with that to 1e-10, for
  the quadratic surrogate and for cubic ones (``CONFIGS``: cubic-2 and
  cubic-3 configs, the ``'cubic-3'`` string, all orders mixed, fitted to a
  model with a cubic term in 4 of the inputs), with and without the
  surrogate's own ``input_scales``, the bound off and on;
* the frozen and warmup chunk plain paths on the ``PolyGaussian`` spec
  (quadratic, and the scaled mix of every order) agree with
  ``make_nuts_pallas_multi`` / ``make_nuts_pallas_warmup`` run in
  interpret mode on the JAX pipeline's ``device_logp_and_grad``: equal
  tree statistics, floats to the tolerances of
  ``test_torch_nuts_kernel.py`` (1e-6 with the real momenta, 1e-9 with one
  correctly rounded Box-Muller patched into both sides);
* ``Laplace.run`` finds the same maximum to 1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bayesfast_tpu as bf
from bayesfast_tpu.modules import (Gaussian as JGaussian,
                                   PolyConfig as JConfig, PolyModel as JPoly)
from bayesfast_tpu.samplers import nuts_pallas as jnpl
from bayesfast_tpu.utils import Laplace as JLaplace

import bayesfast_tpu_torch as bt
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.interop import (density_decay_from_numpy,
                                         poly_from_numpy)
from bayesfast_tpu_torch.modules import Gaussian, PolyConfig, PolyModel
from bayesfast_tpu_torch.ops.densities import spec_logp_and_grad
from bayesfast_tpu_torch.samplers import nuts_cuda as tnc
from bayesfast_tpu_torch.utils import Laplace

from test_torch_nuts_kernel import _compare, _to_port_layout, momenta  # noqa


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


D, M, NL, TRUTH = 6, 24, np.arange(3), 0.1
C, K, MAXDEPTH, MAX_CHANGE = 8, 2, 5, 1000.
BOUNDS = np.stack([np.full(D, -5.), np.full(D, 5.)]).T
NLC = np.array([0, 2, 3, 5])        # the cubic model's and configs' inputs
# the surrogate's own input scales: a box around the fit cloud, another
# width in each dimension
SCALES = np.stack([TRUTH - 1.0 - 0.1 * np.arange(D),
                   TRUTH + 0.5 + 0.3 * np.arange(D)]).T
# each surrogate's PolyModel configs: (order, input mask) pairs, or a string
CONFIGS = {
    'quadratic': [('linear', None), ('quadratic', NL)],
    'cubic-2': [('linear', None), ('cubic-2', NLC)],
    'cubic-3': [('linear', None), ('cubic-3', NLC)],
    'sugar': 'cubic-3',
    'mix': [('linear', None), ('quadratic', NLC), ('cubic-2', NLC),
            ('cubic-3', NLC)],
}


def _model(seed=0, cubic=False):
    """The true model: linear, quadratic in ``NL`` and, with ``cubic``, a
    cubic term in ``NLC``."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(M, D)) / np.sqrt(D)
    B = rng.normal(size=(M, 3, 3)) / 6.0
    B = (B + np.swapaxes(B, 1, 2)) / 2
    T = rng.normal(size=(M, 4, 4, 4)) / 16.0 if cubic else None

    def forward(x, *args, **kwargs):
        x = np.asarray(x)
        y = A @ x + np.einsum('dij,i,j->d', B, x[NL], x[NL])
        if cubic:
            xc = x[NLC]
            y = y + np.einsum('dijk,i,j,k->d', T, xc, xc, xc)
        return y

    return forward, forward(np.full(D, TRUTH))


def _cov(kind):
    """The likelihood's covariance: diagonal (the DES example's) or a full
    SPD matrix."""
    if kind == 'diag':
        return np.full(M, 0.05)
    L = np.random.default_rng(9).normal(size=(M, M)) / M
    return 0.05 * np.eye(M) + L @ L.T


def _poly(Conf, Poly, configs, scales=None, bound=None):
    """A PolyModel of ``configs`` (a ``CONFIGS`` entry) over x -> m;
    ``bound`` None keeps the default bound options."""
    if not isinstance(configs, str):
        configs = [Conf(o) if im is None else Conf(o, input_mask=im)
                   for o, im in configs]
    opts = {} if bound is None else {'bound_options': {'use_bound': bound}}
    return Poly(configs, input_size=D, output_size=M, input_vars='x',
                output_vars='m', input_scales=scales, **opts)


def _density(pkg, forward, data, cov='diag', case='quadratic', scales=None,
             bound=None):
    """The DES-like Density of one package (``pkg`` is ``bf`` or ``bt``),
    its ``CONFIGS[case]`` surrogate (default linear + quadratic-on-3)
    attached."""
    J = pkg is bf
    Gauss, Conf, Poly = ((JGaussian, JConfig, JPoly) if J
                         else (Gaussian, PolyConfig, PolyModel))
    model = pkg.Module(fun=forward, input_vars='x', output_vars='m',
                       input_shapes=[D], output_shapes=[M], traceable=False)
    like = Gauss(mean=data, cov=_cov(cov), input_vars='m',
                 output_vars='logp')
    den = pkg.Density(density_name='logp', module_list=[model, like],
                      input_vars='x', input_shapes=[D], input_scales=BOUNDS,
                      hard_bounds=True, decay_options={'use_decay': True})
    su = _poly(Conf, Poly, CONFIGS[case], scales, bound)
    den.surrogate_list = [su]
    return den, su


def _fitted_pair(cov='diag', seed=1, spread=0.3, case='quadratic',
                 scaled=False, bound=None):
    """The JAX density fitted on random points, and the port's with the JAX
    state carried across; the surrogate switched on in both. A cubic
    ``case`` is fitted to the cubic model on 150 points, with ``SCALES``
    as the surrogate's input scales if ``scaled``."""
    quad = case == 'quadratic'
    forward, data = _model(cubic=not quad)
    scales = SCALES if scaled else None
    den_j, su_j = _density(bf, forward, data, cov, case, scales, bound)
    rng = np.random.default_rng(seed)
    x_fit = TRUTH + rng.normal(size=(60 if quad else 150, D)) * spread
    den_j.fit(den_j.fun(x_fit, original_space=True, use_surrogate=False))
    den_j.use_surrogate = True
    den_t, _ = _density(bt, forward, data, cov)
    den_t.surrogate_list = [poly_from_numpy(
        [(c.order, c.input_mask, c.output_mask, np.asarray(c._a))
         for c in su_j.configs], su_j._mu, su_j._hess, su_j._alpha,
        su_j._f_mu, None if bound is None else {'use_bound': bound},
        input_size=D, output_size=M, input_vars='x', output_vars='m',
        input_scales=scales)]
    density_decay_from_numpy(den_t, den_j._mu, den_j._hess,
                             den_j._alpha_2_val)
    den_t.use_surrogate = True
    return den_j, den_t, x_fit


def _test_points(den_j, n=40, seed=2):
    """Transformed-space points near the fit cloud and far beyond it."""
    rng = np.random.default_rng(seed)
    xo = np.concatenate([TRUTH + rng.normal(size=(n // 2, D)) * 0.2,
                         rng.uniform(-4.5, 4.5, size=(n - n // 2, D))])
    return np.asarray(den_j.from_original(xo))


@pytest.mark.parametrize('cov', ['diag', 'full'])
def test_logp_and_grad_match_jax(cov):
    """Surrogate + decay + hard bounds, in the sampling space and in the
    original space; the cases cover inside and beyond the bound ellipsoid
    and the decay on and off."""
    den_j, den_t, _ = _fitted_pair(cov)
    xt = _test_points(den_j)
    for os_ in (False, True):
        x = den_j.to_original(xt) if os_ else xt
        lp_j, g_j = den_j.logp_and_grad(x, original_space=os_)
        lp_t, g_t = den_t.logp_and_grad(x, original_space=os_)
        np.testing.assert_allclose(lp_t, lp_j, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(g_t, g_j, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(den_t.logp(x, original_space=os_), lp_j,
                                   rtol=1e-10, atol=1e-10)
    xo = den_j.to_original(xt)
    su = den_j.surrogate_list[0]
    beta = np.sqrt(np.einsum('ij,jk,ik->i', xo - su._mu, su._hess,
                             xo - su._mu))
    bd = np.einsum('ij,jk,ik->i', xo - den_j._mu, den_j._hess, xo - den_j._mu)
    assert (beta <= su._alpha).any() and (beta > su._alpha).any()
    assert (bd > den_j._alpha_2_val).any() and (bd < den_j._alpha_2_val).any()
    # one point, and the true model's values through fun
    lp1, g1 = den_t.logp_and_grad(xt[0], original_space=False)
    lp1_j, g1_j = den_j.logp_and_grad(xt[0], original_space=False)
    np.testing.assert_allclose(lp1, lp1_j, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(g1, g1_j, rtol=1e-10, atol=1e-10)
    vd_j = den_j.fun(xo[:3], original_space=True, use_surrogate=False)
    vd_t = den_t.fun(xo[:3], original_space=True, use_surrogate=False)
    for a, b in zip(vd_t, vd_j):
        np.testing.assert_allclose(a.fun['logp'], b.fun['logp'], rtol=1e-12)


def _spec_cases():
    """(cov, case, scaled, bound): the quadratic surrogate with the default
    bound under each covariance (ids 'diag' and 'full'), then every
    surrogate x scales off / on x bound off / on x covariance."""
    cases = [pytest.param(cov, 'quadratic', False, None, id=cov)
             for cov in ('diag', 'full')]
    for case in CONFIGS:
        for scaled in (False, True):
            for bound in (False, True):
                if case == 'quadratic' and not scaled and bound:
                    continue            # the default bound, above
                for cov in ('diag', 'full'):
                    cases.append(pytest.param(
                        cov, case, scaled, bound, id='-'.join((
                            case, 'scaled' if scaled else 'unscaled',
                            'bound' if bound else 'nobound', cov))))
    return cases


@pytest.mark.parametrize('cov, case, scaled, bound', _spec_cases())
def test_kernel_spec_plain_density_matches_jax(cov, case, scaled, bound):
    """The plain twin of the compiled-in density, at original-space points
    behind the fused transform, against the JAX pipeline's logp_and_grad:
    a diagonal likelihood, or a full one through the precision matvec; the
    spec counts the surrogate's features and carries its bound flag, and
    the bound, where it was fitted (u = (x - lo) / diff), has test points
    inside and beyond it."""
    den_j, den_t, _ = _fitted_pair(cov, case=case, scaled=scaled,
                                   bound=bound)
    assert den_t.has_kernel_spec
    spec = den_t.kernel_spec()
    su = den_j.surrogate_list[0]
    assert spec['scalars'][3] == sum(c.n_features for c in su.configs)
    assert bool(spec['scalars'][5]) == (bound is not False)
    xt = _test_points(den_j)
    lp_j, g_j = den_j.logp_and_grad(xt, original_space=False)
    lp_p, g_p = spec_logp_and_grad(spec, torch.as_tensor(xt))
    np.testing.assert_allclose(lp_p.numpy(), lp_j, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(g_p.numpy(), g_j, rtol=1e-10, atol=1e-10)
    if bound is not False:
        u = np.asarray(den_j.to_original(xt))
        if scaled:
            u = (u - SCALES[:, 0]) / (SCALES[:, 1] - SCALES[:, 0])
        beta = np.sqrt(np.einsum('ij,jk,ik->i', u - su._mu, su._hess,
                                 u - su._mu))
        assert (beta <= su._alpha).any() and (beta > su._alpha).any()


@pytest.mark.parametrize('cov, case, scaled, bound', _spec_cases())
def test_kernel_spec_dense_density_matches_jax(cov, case, scaled, bound):
    """The same density in dense torch calls (``ordered=False``, what the
    samplers without a kernel evaluate) against the JAX pipeline."""
    den_j, den_t, _ = _fitted_pair(cov, case=case, scaled=scaled,
                                   bound=bound)
    xt = _test_points(den_j)
    lp_j, g_j = den_j.logp_and_grad(xt, original_space=False)
    lp_d, g_d = spec_logp_and_grad(den_t.kernel_spec(), torch.as_tensor(xt),
                                   ordered=False)
    np.testing.assert_allclose(lp_d.numpy(), lp_j, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(g_d.numpy(), g_j, rtol=1e-10, atol=1e-10)


def _chunk_inputs(den_j):
    rng = np.random.default_rng(4)
    xo = TRUTH + rng.normal(size=(C, D)) * 0.3
    xo[:2] += 2.0                       # two chains start beyond the bound
    q0 = np.asarray(den_j.from_original(xo))
    var = np.exp(rng.normal(size=(C, D)) * 0.2) * 1e-3
    eps = np.exp(rng.normal(size=C) * 0.3) * 0.3
    eps[0] *= 30.0                      # one chain diverges
    return q0, var, eps


@pytest.mark.parametrize('cov, case, scaled', [
    pytest.param('diag', 'quadratic', False, id='diag'),
    pytest.param('full', 'quadratic', False, id='full'),
    pytest.param('diag', 'mix', True, id='mix-scaled')])
def test_frozen_chunk_matches_pallas(cov, case, scaled, momenta):
    """The quadratic surrogate under each covariance, and the mix of every
    order with the surrogate's input scales."""
    den_j, den_t, _ = _fitted_pair(cov, case=case, scaled=scaled)
    q0, var, eps = _chunk_inputs(den_j)
    params = den_j.current_params()
    run = jnpl.make_nuts_pallas_multi(
        den_j.device_logp_and_grad(False), params, D, C, K, MAXDEPTH,
        MAX_CHANGE, jnp.float64, interpret=True)
    seed, i0 = 123456789, 5
    o = run(jnp.int32(seed), jnp.int32(i0), jnp.int32(0),
            jnp.asarray(q0.T), jnp.asarray(var.T), jnp.asarray(eps)[None],
            jax.tree.leaves(params))
    want = {k: _to_port_layout(k, v) for k, v in o.items()}
    got = tnc.nuts_chunk_plain(
        seed, torch.as_tensor(q0), torch.as_tensor(var),
        torch.as_tensor(eps), K, MAXDEPTH, MAX_CHANGE, tnc.plain_lpg(den_t),
        i0)
    _compare(got, want, *momenta)
    assert want['diverging'].any() and (want['tree_depth'] > 1).any()


def test_warmup_chunk_matches_pallas(monkeypatch):
    _warmup_vs_pallas(monkeypatch)


def test_warmup_chunk_matches_pallas_cubic(monkeypatch):
    """The mix of every order with the surrogate's input scales."""
    _warmup_vs_pallas(monkeypatch, case='mix', scaled=True)


def _warmup_vs_pallas(monkeypatch, **pair):
    from test_torch_nuts_kernel import use_rounded_momenta
    tol = use_rounded_momenta(monkeypatch)
    den_j, den_t, _ = _fitted_pair(**pair)
    q0, var, eps = _chunk_inputs(den_j)
    eps[0] /= 30.0
    rng = np.random.default_rng(5)
    log_step = np.log(eps)
    step = (log_step, log_step + 0.1, rng.normal(size=C) * 0.01,
            np.full(C, 5.0), np.log(10 * eps))
    metric = (var, q0 + rng.normal(size=(C, D)) * 0.01, var * 10.0,
              np.full(C, 10.0), q0, var * 3.0, np.full(C, 3.0))
    wsched, _ = jnpl._window_schedule(4, 0, 5, K, 1, True)
    args = (0.8, 0.05, 0.75, 10.)
    params = den_j.current_params()
    run = jnpl.make_nuts_pallas_warmup(
        den_j.device_logp_and_grad(False), params, D, C, K, MAXDEPTH,
        MAX_CHANGE, jnp.float64, wsched, *args, True, True, interpret=True)
    row = lambda a: jnp.asarray(a).reshape(1, C)
    mat = lambda a: jnp.asarray(a).T
    seed, i0 = 987654321, 33
    o = run(jnp.int32(seed), jnp.int32(i0), jnp.int32(0), jnp.asarray(q0.T),
            tuple(row(a) for a in step),
            (mat(metric[0]), mat(metric[1]), mat(metric[2]), row(metric[3]),
             mat(metric[4]), mat(metric[5]), row(metric[6])),
            jax.tree.leaves(params), wsched)
    want = {k: _to_port_layout(k, v) for k, v in o.items()}
    got = tnc.nuts_warmup_chunk_plain(
        seed, torch.as_tensor(q0), [torch.as_tensor(a) for a in step],
        [torch.as_tensor(a) for a in metric], K, MAXDEPTH, MAX_CHANGE,
        *args, True, True, wsched, tnc.plain_lpg(den_t), i0)
    assert set(got) == set(want)
    _compare(got, want, *tol)


def test_laplace_matches_jax():
    """Newton-CG on the surrogate logp in the sampling space: the same
    maximum to 1e-6 and the same Hessian-based covariance."""
    den_j, den_t, x_fit = _fitted_pair()
    x0 = np.asarray(den_j.from_original(x_fit[0]))
    tr_j = den_j.device_logp(original_space=False, use_surrogate=True)
    res_j = JLaplace(beta=100.).run(
        logp=lambda x: float(den_j.logp(x, original_space=False)), x_0=x0,
        traceable=tr_j)
    tr_t = den_t.device_logp(original_space=False, use_surrogate=True)
    res_t = Laplace(beta=100.).run(
        logp=lambda x: float(den_t.logp(x, original_space=False)), x_0=x0,
        traceable=tr_t)
    np.testing.assert_allclose(res_t.x_max, res_j.x_max, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(res_t.f_max, res_j.f_max, rtol=1e-8)
    np.testing.assert_allclose(res_t.cov, res_j.cov, rtol=1e-5, atol=1e-9)
    # the tempered Sobol draws come back to beta = 1 the same way
    np.testing.assert_allclose(Laplace.untemper_laplace_samples(res_t),
                               JLaplace.untemper_laplace_samples(res_j),
                               rtol=1e-5, atol=1e-6)


def test_spec_follows_every_refit():
    """The spec the chunk path launches with is the density's as it
    stands: fit, sample, refit in place on other data, and the cached spec
    (``nuts_cuda._spec_for``, and the plain path's) holds the new
    coefficients. A cache keyed on identities would keep the first fit."""
    forward_poly, data = _model()

    def forward(x, *args, **kwargs):
        # off the surrogate's span, so that a refit on other points moves
        # every coefficient
        return forward_poly(x) + 0.3 * np.sin(2.0 * np.asarray(x)[3])

    den, su = _density(bt, forward, data)
    rng = np.random.default_rng(6)
    den.fit(den.fun(TRUTH + rng.normal(size=(60, D)) * 0.3,
                    original_space=True, use_surrogate=False))
    den.use_surrogate = True
    bt.utils.set_generator(3)
    tt = bt.sample(den, bt.NTrace(n_chain=4, n_iter=12, n_warmup=6,
                                  x_0=TRUTH + rng.normal(size=(4, D)) * 0.1),
                   verbose=False)
    like = torch.as_tensor(tt.trace.samples[:, -1], dtype=torch.float64)
    packed_1 = tnc._spec_for(den, like)[2].clone()
    a_1 = su.configs[1]._a.copy()
    den.fit(den.fun(TRUTH + 0.5 + rng.normal(size=(60, D)) * 0.4,
                    original_space=True, use_surrogate=False))
    assert su.configs[1]._a is not None and not np.allclose(
        su.configs[1]._a, a_1)
    packed_2 = tnc._spec_for(den, like)[2]
    fresh = den.kernel_spec()['params'][0]
    assert not torch.equal(packed_1, packed_2)
    assert torch.equal(packed_2, fresh)
    # the plain path reads the same fresh spec
    lp, g = tnc.plain_lpg(den)(like)
    lp2, g2 = spec_logp_and_grad(den.kernel_spec(), like)
    assert torch.equal(lp, lp2) and torch.equal(g, g2)
    lp_a, g_a = den.logp_and_grad(like.numpy(), original_space=False)
    np.testing.assert_allclose(lp.numpy(), lp_a, rtol=1e-10)


def test_user_post_module_has_no_kernel_spec():
    """A pipeline whose surrogate feeds a user module has no compiled-in
    kernel spec: its plan is traced (``ops/trace.py``), and 'auto' samples
    it on the kernels' path (their plain versions on the CPU), not on the
    tree loop; 'cuda' raises on CPU tensors."""
    bt.utils.set_generator(5)
    su = PolyModel('quadratic', input_size=2, output_size=1,
                   input_vars='x', output_vars='m',
                   bound_options={'use_bound': False})
    m_mod = bt.Module(fun=lambda x: torch.sum(x ** 2, -1), input_vars='x',
                      output_vars='m')
    lp_mod = bt.Module(fun=lambda m: -(m - 4.0) ** 2, input_vars='m',
                       output_vars='logp')
    den = bt.Density(density_name='logp', module_list=[m_mod, lp_mod],
                     surrogate_list=[su], input_vars='x', input_shapes=[2])
    rng = np.random.default_rng(0)
    den.fit(den.fun(rng.normal(size=(30, 2)) * 2, use_surrogate=False))
    den.use_surrogate = True
    assert den._kernel_parts() is None
    assert den.has_kernel_spec and den.has_traced_spec
    assert den.kernel_spec()['density'] == 'traced'
    # what a launch on the card would take: the traced program's constants
    spec = tnc._spec_for(den, torch.zeros(4, 2, dtype=torch.float64))
    assert spec[0] == tnc.DENSITY_IDS['traced']
    trace = dict(n_chain=4, n_iter=10, n_warmup=5,
                 x_0=rng.normal(size=(4, 2)))
    n0 = bt.samplers.nuts.nuts_transition_batched.transitions
    tt = bt.sample(den, bt.NTrace(**trace), verbose=False)
    assert np.isfinite(tt.get()).all()
    assert bt.samplers.nuts.nuts_transition_batched.transitions - n0 == 0
    tconfig.set_nuts_kernel('cuda')
    try:
        with pytest.raises((NotImplementedError, RuntimeError)):
            bt.sample(den, bt.NTrace(**trace), verbose=False)
    finally:
        tconfig.set_nuts_kernel('auto')
    # and the compiled-in case is: the DES-like density with its surrogate
    den_j, den_t, _ = _fitted_pair()
    assert den_t.has_kernel_spec
    den_t.use_surrogate = False
    assert not den_t.has_kernel_spec


def test_fun_and_jac_and_modules_match_jax():
    """Module composition, Jacobians through it, the Sum and full-covariance
    Gaussian modules, against the JAX pipeline."""
    from bayesfast_tpu.modules import Sum as JSum
    from bayesfast_tpu_torch.modules import Sum
    rng = np.random.default_rng(7)
    cov = np.cov(rng.normal(size=(20, 3)), rowvar=False)
    mean = rng.normal(size=3)

    def build(pkg, Gauss, S, f):
        m_mod = pkg.Module(fun=f, input_vars='x', output_vars='m')
        g1 = Gauss(mean, cov, input_vars='m', output_vars='lp1')
        g2 = Gauss(np.zeros(2), np.array([1., 2.]), input_vars='y',
                   output_vars='lp2')
        s = S(input_vars=['lp1', 'lp2'], output_vars='logp', b=[1., 0.5])
        return pkg.Density(density_name='logp',
                           module_list=[m_mod, g1, g2, s],
                           input_vars=['x', 'y'], input_shapes=[3, 2],
                           input_scales=np.stack([np.full(5, -3.),
                                                  np.full(5, 4.)]).T,
                           hard_bounds=True)

    den_j = build(bf, JGaussian, JSum, lambda x: jnp.sin(x) + x ** 2)
    den_t = build(bt, Gaussian, Sum, lambda x: torch.sin(x) + x ** 2)
    x = rng.uniform(-2.5, 3.5, size=(5, 5))
    for a, b in zip(den_t.fun_and_jac(x), den_j.fun_and_jac(x)):
        for k in ('m', 'lp1', 'lp2', 'logp'):
            np.testing.assert_allclose(a.fun[k], b.fun[k], rtol=1e-12)
            np.testing.assert_allclose(a.jac[k], b.jac[k], rtol=1e-10,
                                       atol=1e-12)
    xt = den_j.from_original(x)
    lp_j, g_j = den_j.logp_and_grad(xt, original_space=False)
    lp_t, g_t = den_t.logp_and_grad(xt, original_space=False)
    np.testing.assert_allclose(lp_t, lp_j, rtol=1e-12)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-10, atol=1e-12)


def test_warm_start_step_size_and_metric():
    """The Recipe's warm start from a finished trace
    (``sample_trace.py:_get_step_size``, ``_get_metric``): the mean
    dual-averaged step size times D^0.25, and the metric from the draws'
    covariance in the sampling space or from the adapted per-chain one."""
    from bayesfast_tpu_torch.samplers import _get_metric, _get_step_size
    bt.utils.set_generator(2)
    den = bt.DensityLite(logp=bt.ops.DiagGaussian(np.zeros(3),
                                                  [1., 4., 9.]),
                         input_size=3)
    tt = bt.sample(den, bt.NTrace(n_chain=4, n_iter=40, n_warmup=20),
                   verbose=False)
    carry = tt.trace._carry
    np.testing.assert_allclose(
        _get_step_size(tt),
        np.mean(np.exp(carry.step.log_bar.numpy())) * 3 ** 0.25,
        rtol=1e-12)
    cov = np.cov(tt.get(original_space=False, flatten=True), rowvar=False)
    np.testing.assert_allclose(_get_metric(tt, 'full'), cov, rtol=1e-12)
    np.testing.assert_allclose(_get_metric(tt, 'diag'), np.diag(cov),
                               rtol=1e-12)
    np.testing.assert_allclose(
        _get_metric(tt, 'diag', from_samples=False),
        carry.metric.var.numpy().mean(axis=0), rtol=1e-12)
    with pytest.raises(ValueError):
        _get_metric(tt, 'dense')
