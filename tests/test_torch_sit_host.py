"""The SIT fit's two routes on the port, and its host route against the
JAX package's.

* The host route (``n_rows * dim < 100_000``, or ``set_kde_device(False)``):
  one ``_gaussianize_1d`` a dimension over a thread pool, every KDE sum on
  the host library. It is the JAX package's host route, the same C code
  on the same data, so from the same ICA draws (``test_torch_sit``'s
  ``_record_jax_draws`` / ``_inject_draws``) the fitted rotations agree to
  rtol 1e-6 (FastICA in torch against JAX) and ``logq`` on held-out rows to
  a mean |d| < 1e-8 (measured ~5e-12).
* The route of a fit (3703 and 3704 rows x 27 dims, either side of
  100 000) and of ``kde.cdf`` (``x.size * n`` 99 999 and 100 000) under
  ``set_kde_device(True)`` on the CPU; ``set_kde_device(None)`` restores
  auto (on for a CUDA device, off for the CPU); data on a CUDA device
  takes the device route at every size unless ``set_kde_device(False)``
  (``config.kde_device_route``).
* Both routes drop non-finite rows; the host route calls no KDE batch.
* GBS whose SIT fit takes the device route (pinned) against the JAX
  package's host route, within max(logz_err, 0.02) as
  ``test_torch_evidence`` holds the host route.
"""

import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bayesfast_tpu import evidence as jev
from bayesfast_tpu.transforms import sit as jsit
from bayesfast_tpu.utils.kde import kde as jkde
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch import evidence as tev
from bayesfast_tpu_torch.transforms import sit as tsit
from bayesfast_tpu_torch.utils.kde import kde as tkde
from test_torch_sit import _inject_draws, _record_jax_draws, _sources


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


@pytest.fixture
def kde_device():
    """``set_kde_device(True)`` for one test, auto again after it."""
    tconfig.set_kde_device(True)
    yield
    tconfig.set_kde_device(None)


def _spy_routes(monkeypatch):
    """Record which fit each layer runs (``_fit_splines``: the device
    route; ``_fit_host``: the host route) and count ``kde_cdf_batch``
    calls."""
    seen = {'fits': [], 'kde_batches': 0}
    for name, route in (('_fit_splines', 'device'), ('_fit_host', 'host')):
        fn = getattr(tsit.SIT, name)

        def spy(self, y, fn=fn, route=route):
            seen['fits'].append(route)
            return fn(self, y)
        monkeypatch.setattr(tsit.SIT, name, spy)
    batch = tsit.kde_cdf_batch

    def counted(*a, **kw):
        seen['kde_batches'] += 1
        return batch(*a, **kw)
    monkeypatch.setattr(tsit, 'kde_cdf_batch', counted)
    return seen


def _host_pair(monkeypatch, data, n_iter, weights=None, **opts):
    """A JAX SIT and a port SIT fitted to ``data`` on the host route from
    the same ICA draws, both float64."""
    draws = _record_jax_draws(monkeypatch)
    sj = jsit.SIT(n_iter=n_iter, random_generator=3, m_ica=None,
                  flow_dtype=jnp.float64, **opts)
    sj.fit(data, weights=weights)
    _inject_draws(monkeypatch, draws)
    st = tsit.SIT(n_iter=n_iter, m_ica=None, flow_dtype=torch.float64,
                  **opts)
    st.fit(data, weights=weights)
    return sj, st


@pytest.mark.parametrize('d,n_iter,weighted,opts', [
    (3, 4, False, {}), (4, 2, False, {}), (4, 2, True, {}),
    (3, 3, False, {'bw_factor': 0.8, 'cubic_options': {'bins': 60}})])
def test_host_route_matches_jax_host_route(monkeypatch, d, n_iter, weighted,
                                           opts):
    x = _sources(10000, d)
    w = (np.random.default_rng(d).uniform(0.5, 1.5, 8000) if weighted
         else None)
    seen = _spy_routes(monkeypatch)
    sj, st = _host_pair(monkeypatch, x[:8000], n_iter, w, **opts)
    assert st.last_routes == ['host'] * n_iter
    assert seen == {'fits': ['host'] * n_iter, 'kde_batches': 0}
    np.testing.assert_allclose(st._A, sj._A, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(st._B, sj._B, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(st.data, sj.data, rtol=0, atol=1e-6)
    diff = st.logq(x[8000:]) - sj.logq(x[8000:])
    assert np.abs(diff).mean() < 1e-8


def test_host_route_profile(monkeypatch):
    st = tsit.SIT(n_iter=2, random_generator=0)
    st.fit(_sources(3000, 4))
    assert st.last_routes == ['host', 'host']
    assert set(st.last_profile) == {'evaluate_s', 'ica_s', 'host_copy_s',
                                    'host_fits_s', 'host_kde_thread_s'}
    assert st.last_profile['host_kde_thread_s'] > 0


@pytest.mark.parametrize('n_rows,route', [(3703, 'host'), (3704, 'device')])
def test_fit_route_at_the_threshold(monkeypatch, kde_device, n_rows, route):
    x = np.random.default_rng(n_rows).standard_t(5, size=(n_rows, 27))
    seen = _spy_routes(monkeypatch)
    st = tsit.SIT(n_iter=1, random_generator=0)
    st.fit(x)
    assert seen['fits'] == [route] and st.last_routes == [route]
    assert (seen['kde_batches'] > 0) == (route == 'device')
    assert np.isfinite(st.logq(x[:50])).all()


@pytest.mark.parametrize('n,m,route', [(33333, 3, 'host'),
                                       (25000, 4, 'device')])
def test_kde_cdf_route_at_the_threshold(monkeypatch, kde_device, n, m,
                                        route):
    rng = np.random.default_rng(n)
    data = rng.standard_t(4, size=n)
    w = rng.uniform(0.5, 1.0, size=n)
    x = rng.normal(size=m) * 2.0
    calls = []
    for name in ('_cdf_host', '_cdf_device'):
        fn = getattr(tkde, name)

        def spy(self, q, fn=fn, name=name):
            calls.append(name[5:])
            return fn(self, q)
        monkeypatch.setattr(tkde, name, spy)
    k = tkde(data, weights=w)
    got = k.cdf(x)
    assert calls == [route]
    np.testing.assert_allclose(got, jkde(data, weights=w).cdf(x), rtol=0,
                               atol=1e-12)
    tconfig.set_kde_device(None)      # auto on the CPU: the host library
    calls.clear()
    np.testing.assert_allclose(k.cdf(x), got, rtol=0, atol=1e-12)
    assert calls == ['host']


def test_set_kde_device_none_restores_auto(monkeypatch):
    assert tconfig.kde_on_device() is False          # auto, the CPU
    for mode in (True, False):
        tconfig.set_kde_device(mode)
        assert tconfig.kde_on_device() is mode
    tconfig.set_kde_device(None)
    assert tconfig.kde_on_device() is False
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    old = tconfig.set_device('cuda')
    try:
        assert tconfig.kde_on_device() is True       # auto, a CUDA device
        tconfig.set_kde_device(False)
        assert tconfig.kde_on_device() is False
        tconfig.set_kde_device(None)
        assert tconfig.kde_on_device() is True
    finally:
        tconfig.set_kde_device(None)
        tconfig.set_device(old)


@pytest.mark.parametrize('mode,device,n,want', [
    (None, 'cpu', 10 ** 7, False), (True, 'cpu', 99_999, False),
    (True, 'cpu', 100_000, True), (False, 'cpu', 10 ** 7, False),
    (None, 'cuda', 1, True), (True, 'cuda', 1, True),
    (False, 'cuda', 10 ** 7, False)])
def test_kde_device_route(monkeypatch, mode, device, n, want):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    old = tconfig.set_device(device)
    tconfig.set_kde_device(mode)
    try:
        assert tconfig.kde_device_route(n, torch.device(device)) is want
    finally:
        tconfig.set_kde_device(None)
        tconfig.set_device(old)


@pytest.mark.parametrize('kde_mode,n_rows', [(None, 3000), (True, 25001)])
def test_both_routes_drop_non_finite_rows(monkeypatch, kde_mode, n_rows):
    x = _sources(n_rows, 4)
    x[5] = np.inf
    seen = _spy_routes(monkeypatch)
    tconfig.set_kde_device(kde_mode)
    try:
        st = tsit.SIT(n_iter=2, random_generator=0)
        with pytest.warns(RuntimeWarning, match='inf encountered'):
            st.fit(x)
    finally:
        tconfig.set_kde_device(None)
    route = 'host' if kde_mode is None else 'device'
    assert st.last_routes == [route] * 2 and set(seen['fits']) == {route}
    assert st.data.shape == (n_rows - 1, 4) and np.isfinite(st.data).all()
    assert np.isfinite(st.logq(x[6:106])).all()


def test_gbs_device_route_matches_jax_host_path(monkeypatch, kde_device):
    # 8 chains x 6250 draws: the fit half is 25000 rows x 4 dims = 1e5
    rng = np.random.default_rng(9)
    cov = np.array([[2.0, 0.6, 0.2, 0.0], [0.6, 1.0, 0.3, 0.1],
                    [0.2, 0.3, 1.5, 0.2], [0.0, 0.1, 0.2, 0.8]])
    x = rng.multivariate_normal(np.zeros(4), cov, 50000)
    prec = np.linalg.inv(cov)

    def logp(v):
        return -0.5 * np.einsum('...i,ij,...j->...', v, prec, v)

    x_chains = x.reshape(8, 6250, 4)
    opts = {'n_iter': 4, 'random_generator': 0}
    draws = _record_jax_draws(monkeypatch)
    lz_j, _ = jev.GBS(sit=dict(opts), n_q=4000).run(x_chains, logp)
    _inject_draws(monkeypatch, draws)
    seen = _spy_routes(monkeypatch)
    gbs = tev.GBS(sit=dict(opts, flow_dtype=torch.float64), n_q=4000)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        lz_t, err_t = gbs.run(x_p=x_chains, logp=logp)
    assert gbs.sit.last_routes == ['device'] * 4
    assert seen['kde_batches'] > 0
    truth = 0.5 * np.linalg.slogdet(2 * np.pi * cov)[1]
    assert abs(lz_t - truth) < max(5 * err_t, 0.1)
    assert abs(lz_t - lz_j) < max(err_t, 0.02)
