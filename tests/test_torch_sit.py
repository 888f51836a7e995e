"""The port's FastICA and SIT flow against the JAX package's.

ICA draws: the JAX SIT draws each layer's initial unmixing matrix from its
key, ``_sym_decorrelation(normal(key, (d, d)))``; the tests record that
draw and hand it to the port's ``fast_ica`` as ``w_init``. The whitening
matrix comes from ``eigh``, and LAPACK builds may return an eigenvector
with the opposite sign (JAX's and torch's do on some of these inputs).
FastICA from the same start then converges to other components. Flipping
the matching columns of the initial matrix makes the two iterations
identical (``W`` carries the same sign flips as the whitened data), so the
injected draw is aligned to the port's eigenvector signs first. On data
whose sources are close to Gaussian the fixed point is ill-defined and
the iteration wanders: rounding differences of 1e-12 grow to O(1) within
50 iterations. So the fit comparisons use data of non-Gaussian sources,
where FastICA converges within a few iterations in every layer.

Tolerances:
* ICA components, float64: 1e-8.
* SIT carried across (``interop.sit_from_numpy``): the same flow evaluated
  by both packages, float64, rel 1e-9.
* SIT fitted by the port against the JAX host path (float64 KDE, x64):
  ``logq`` on held-out points to mean |d| < 1e-4. Under auto on the CPU
  both packages take their host routes (``test_torch_sit_host.py`` holds
  the two host routes to 1e-8).
* Against the JAX device path, whose KDE sums run in float32: the
  tolerance of ``tests/test_sit_evidence.py::test_device_kde_fit_matches_
  host``, mean |d| < 0.01 and |mean d| < 1e-3. The port's side is pinned
  to its device route (``set_kde_device(True)``), as is the knot-stage
  test's.
"""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bayesfast_tpu import config as bfc
from bayesfast_tpu.ops import ica as jica
from bayesfast_tpu.transforms import sit as jsit
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch import interop
from bayesfast_tpu_torch.ops import ica as tica
from bayesfast_tpu_torch.transforms import sit as tsit


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


@pytest.fixture
def kde_device():
    """The port's SIT fits of ``n_rows * dim >= 100_000`` on the device
    route for one test (auto, on the CPU, is the host route)."""
    tconfig.set_kde_device(True)
    yield
    tconfig.set_kde_device(None)


def _jax_draw(key, d, dtype=jnp.float64):
    return np.array(jica._sym_decorrelation(jax.random.normal(key, (d, d),
                                                              dtype)))


def _aligned(w0, x):
    """``w0`` with its columns flipped where torch's eigenvectors of the
    data covariance have the opposite sign of JAX's."""
    x = np.asarray(x, np.float64)
    xc = x - x.mean(0)
    cov = xc.T @ xc / x.shape[0]
    vj = np.asarray(jnp.linalg.eigh(jnp.asarray(cov))[1])
    vt = torch.linalg.eigh(torch.as_tensor(cov))[1].numpy()
    return w0 * np.sign(np.sum(vj * vt, axis=0))[None, :]


def _record_jax_draws(monkeypatch):
    draws = []
    orig = jsit.fast_ica

    def rec(x, key, **kw):
        draws.append(_jax_draw(key, x.shape[1], jnp.asarray(x).dtype))
        return orig(x, key, **kw)

    monkeypatch.setattr(jsit, 'fast_ica', rec)
    return draws


def _inject_draws(monkeypatch, draws):
    it = iter(draws)
    orig = tsit.fast_ica

    def inj(x, gen, **kw):
        return orig(x, gen, w_init=_aligned(next(it), x.cpu().numpy()), **kw)

    monkeypatch.setattr(tsit, 'fast_ica', inj)


def _mixed(n, seed):
    rng = np.random.default_rng(seed)
    s = np.stack([rng.laplace(size=n), rng.uniform(-1, 1, n),
                  rng.normal(size=n), rng.standard_t(5, size=n)], axis=-1)
    mix = np.array([[1.0, 0.5, 0.2, 0.0], [-0.3, 1.2, 0.1, 0.4],
                    [0.2, 0.1, 0.9, -0.2], [0.0, 0.3, -0.4, 1.1]])
    return s, s @ mix.T


@pytest.mark.parametrize('seed,d', [(0, 2), (3, 3), (4, 4)])
def test_fast_ica_matches_jax(seed, d):
    s, x = _mixed(6000, seed)
    x = x[:, :d]
    key = jax.random.PRNGKey(seed)
    cj, mj = jica.fast_ica(x, key)
    w0 = _aligned(_jax_draw(key, d), x)
    ct, mt = tica.fast_ica(torch.as_tensor(x), w_init=w0)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-8)


def test_fast_ica_own_draw_unmixes():
    s, x = _mixed(20000, 1)
    comps, mean = tica.fast_ica(torch.as_tensor(x[:, :2]),
                                torch.Generator().manual_seed(0))
    y = (x[:, :2] - mean.numpy()) @ comps.numpy().T
    np.testing.assert_allclose(np.cov(y, rowvar=False), np.eye(2), atol=0.05)


def _sources(n, d, seed=0):
    """Independent non-Gaussian columns, mixed when d = 4."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.normal(size=n) ** 3, rng.gamma(2, size=n),
                  rng.standard_t(3, size=n), rng.laplace(size=n)][:d], 1)
    if d == 4:
        x = x @ np.array([[1, .3, 0, 0], [0, 1, .2, 0], [0, 0, 1, .4],
                          [.1, 0, 0, 1]]).T
    return x


def _corr_data(n, seed=4):
    rng = np.random.default_rng(seed)
    cov = np.array([[2.0, 0.6, 0.2, 0.0], [0.6, 1.0, 0.3, 0.1],
                    [0.2, 0.3, 1.5, 0.2], [0.0, 0.1, 0.2, 0.8]])
    x = rng.multivariate_normal(np.zeros(4), cov, n)
    x[:, 0] = np.sinh(x[:, 0])
    return x


def _fit_pair(monkeypatch, data, n_iter, kde_device, **opts):
    """A JAX SIT fitted with the KDE on the host or the device path, and a
    port SIT fitted to the same data from the same ICA draws, both
    float64."""
    draws = _record_jax_draws(monkeypatch)
    bfc.set_kde_device(kde_device)
    try:
        sj = jsit.SIT(n_iter=n_iter, random_generator=3, m_ica=None,
                      flow_dtype=jnp.float64, **opts)
        sj.fit(data)
    finally:
        bfc.set_kde_device(None)
    _inject_draws(monkeypatch, draws)
    st = tsit.SIT(n_iter=n_iter, m_ica=None, flow_dtype=torch.float64,
                  **opts)
    st.fit(data)
    return sj, st


@pytest.mark.parametrize('d,n_iter,opts', [
    (3, 4, {}), (4, 2, {}),
    (3, 3, {'bw_factor': 0.8, 'cubic_options': {'bins': 60}})])
def test_sit_fit_matches_jax_host_path(monkeypatch, d, n_iter, opts):
    x = _sources(10000, d)
    sj, st = _fit_pair(monkeypatch, x[:8000], n_iter, False, **opts)
    np.testing.assert_allclose(st._A, sj._A, rtol=1e-6, atol=1e-8)
    diff = st.logq(x[8000:]) - sj.logq(x[8000:])
    assert np.abs(diff).mean() < 1e-4


def test_sit_fit_matches_jax_device_path(monkeypatch, kde_device):
    # above the JAX device fit's threshold (n * dim >= 1e5)
    data = _sources(40000, 3)
    sj, st = _fit_pair(monkeypatch, data, 3, True)
    assert st.last_routes == ['device'] * 3
    d = st.logq(data[:2000]) - sj.logq(data[:2000])
    assert np.abs(d).mean() < 0.01
    assert abs(d.mean()) < 1e-3


def test_knot_stage_matches_jax(kde_device):
    rng = np.random.default_rng(5)
    y = np.stack([rng.normal(size=5000), rng.gamma(2., size=5000),
                  rng.standard_t(3, size=5000)])
    w = rng.uniform(0.5, 1.0, size=5000)
    want = np.asarray(jsit._knot_stage_device(jnp.asarray(y), jnp.asarray(w),
                                              100, 1, 10))
    got = tsit._knot_stage(torch.as_tensor(y), torch.as_tensor(w), 100, 1,
                           10).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.fixture(scope='module')
def carried():
    """A JAX SIT (host path, float64) and the port's copy of its layers."""
    x = _corr_data(5000, seed=6)
    sj = jsit.SIT(n_iter=3, random_generator=1)
    sj.fit(x)
    st = interop.sit_from_numpy(
        sj._A, sj._B, sj._m, sj._logdetA,
        [[(s._x, s._y, s._c) for s in ss.splines]
         for ss in sj._spline_sets], data=sj.data,
        flow_dtype=torch.float64)
    return x, sj, st


@pytest.mark.parametrize('fn', ['forward_transform', 'backward_transform',
                                'logq'])
def test_carried_flow_matches_jax(carried, fn):
    x, sj, st = carried
    pts = np.concatenate([x[:300], x[:20] * 3.0])
    if fn == 'backward_transform':
        pts = sj.forward_transform(pts)[0]
    want, got = getattr(sj, fn)(pts), getattr(st, fn)(pts)
    for a, b in zip(want if fn != 'logq' else [want],
                    got if fn != 'logq' else [got]):
        np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-10)


def test_carried_sample_matches_jax(carried):
    _, sj, st = carried
    xj, lj, yj = sj.sample(500)
    xt, lt, yt = st.sample(500)
    # the shared Sobol normals (ndtri and the eigh factor may round an ulp
    # apart)
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-15)
    np.testing.assert_allclose(xt, xj, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(lt, lj, rtol=1e-9, atol=1e-10)


def test_carried_flow_in_row_chunks(carried, monkeypatch):
    x, _, st = carried
    whole = st.logq(x[:1000])
    monkeypatch.setattr(type(st), '_chunk_rows', 128)
    np.testing.assert_array_equal(st.logq(x[:1000]), whole)


def test_sit_drops_non_finite_rows():
    x = _corr_data(3000, seed=7)
    x[5] = np.inf
    st = tsit.SIT(n_iter=2, random_generator=0)
    with pytest.warns(RuntimeWarning, match='inf encountered'):
        st.fit(x)
    assert st.data.shape == (2999, 4) and np.isfinite(st.data).all()
    assert np.isfinite(st.logq(x[6:106])).all()


def test_triangle_plot_fallback():
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    rng = np.random.default_rng(0)
    st = tsit.SIT(n_iter=1, random_generator=0, m_plot=3)
    st.fit(rng.normal(size=(500, 3)) * [1.0, 2.0, 0.5])
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        fig = st.triangle_plot(show=False)
    assert len(fig.axes) >= 6
    plt.close(fig)
