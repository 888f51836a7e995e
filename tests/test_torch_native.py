"""The port's host library (``bayesfast_tpu_torch/native``) against the JAX
package's and against its own plain numpy versions.

* Each entry point bitwise against ``bayesfast_tpu.native``: the same C
  code, built with the same flags on the same host.
* Each within 1e-12 of its plain numpy version (absolute: the C sums take
  Phi as ``0.5 * (1 + erf)``, whose far left tail cancels to ~1e-16
  absolute), and ``spline_solve`` (60 bisections) against the plain
  bracketed Newton to 1e-12; the spline functions within
  ``tests/test_native.py``'s tolerances of the fitted spline's own
  evaluation.
* ``sobol_points`` bitwise against the port's ``utils/sobol`` integers
  scaled by 2^-32.
* ``kde_cdf_sorted`` at one OpenMP thread against the full team, bitwise.
* A failed build raises ``RuntimeError`` with gcc's output, on every entry
  point, and ``available()`` is False.
* After a native call has run its OpenMP team, the port's process pool
  still starts and maps.
"""

import numpy as np
import pytest

from bayesfast_tpu import native as jnative
from bayesfast_tpu.native import bindings as jb
from bayesfast_tpu_torch import _build, native
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.native import bindings as tb
from bayesfast_tpu_torch.utils import sobol
from bayesfast_tpu_torch.utils.cubic import cubic_spline


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


@pytest.fixture(scope='module')
def has_native():
    if not native.available():
        pytest.skip('bf_native could not be built on this host')
    if not jnative.available():
        pytest.skip("the JAX package's bf_native could not be built")
    return True


def _kde_inputs(n=3200, m=420, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.standard_t(4, size=n)
    w = rng.uniform(0.2, 1.0, size=n)
    w /= w.sum()
    x = np.concatenate([rng.normal(size=m) * 2.0, [-40.0, 40.0]])
    return data, w, 0.21, x


def _sorted(data, w):
    order = np.argsort(data, kind='stable')
    sw = w[order]
    return data[order], sw, np.concatenate(([0.0], np.cumsum(sw)))


@pytest.mark.parametrize('d,n,skip', [(12, 257, 1), (27, 1000, 0),
                                      (3, 64, 1000)])
def test_sobol_points(has_native, d, n, skip):
    V = sobol.direction_numbers(d)
    got = tb.sobol_points(V, n, skip)
    np.testing.assert_array_equal(got, jb.sobol_points(V, n, skip))
    np.testing.assert_array_equal(got, tb.sobol_points_plain(V, n, skip))
    ref = sobol.sobol_uint32(n, d, skip, device='cpu').double() * 2.0 ** -32
    np.testing.assert_array_equal(got, ref.numpy())


@pytest.mark.parametrize('n,m', [(5000, 101), (3200, 420), (10, 7)])
def test_kde_cdf(has_native, n, m):
    data, w, h, x = _kde_inputs(n, m, seed=n)
    got = tb.kde_cdf(data, w, h, x)
    np.testing.assert_array_equal(got, jb.kde_cdf(data, w, h, x))
    np.testing.assert_allclose(got, tb.kde_cdf_plain(data, w, h, x),
                               rtol=0, atol=1e-12)
    # tests/test_native.py's case
    rng = np.random.default_rng(0)
    d = rng.normal(size=5000)
    u = np.full(5000, 1.0 / 5000)
    q = np.linspace(-3, 3, 101)
    np.testing.assert_allclose(tb.kde_cdf(d, u, 0.3, q),
                               tb.kde_cdf_plain(d, u, 0.3, q), atol=1e-12)


@pytest.mark.parametrize('n,m', [(3200, 420), (741, 60), (18519, 97)])
def test_kde_cdf_sorted(has_native, n, m):
    data, w, h, x = _kde_inputs(n, m, seed=n)
    sd, sw, prefix = _sorted(data, w)
    got = tb.kde_cdf_sorted(sd, sw, prefix, h, x)
    np.testing.assert_array_equal(got, jb.kde_cdf_sorted(sd, sw, prefix, h,
                                                         x))
    np.testing.assert_allclose(
        got, tb.kde_cdf_sorted_plain(sd, sw, prefix, h, x), rtol=0,
        atol=1e-12)
    # the window drops terms below Phi(-8) ~ 6e-16 each: the dense sum
    np.testing.assert_allclose(got, tb.kde_cdf(data, w, h, x), rtol=0,
                               atol=1e-12)


def test_one_thread_is_the_full_team_bitwise(has_native):
    data, w, h, x = _kde_inputs(20000, 3000, seed=5)
    sd, sw, prefix = _sorted(data, w)
    assert tb.team_size() >= 1
    full = tb.kde_cdf_sorted(sd, sw, prefix, h, x)
    dense = tb.kde_cdf(data, w, h, x)
    tb.set_threads(1)
    try:
        one = tb.kde_cdf_sorted(sd, sw, prefix, h, x)
        dense_one = tb.kde_cdf(data, w, h, x)
    finally:
        tb.set_threads(0)
    np.testing.assert_array_equal(one, full)
    np.testing.assert_array_equal(dense_one, dense)


@pytest.fixture(scope='module')
def spline():
    rng = np.random.default_rng(1)
    return cubic_spline(rng.normal(size=4000) * 2,
                        lambda x: np.arctan(x) + 0.2 * x)


@pytest.mark.parametrize('fn,own,tol', [('spline_eval', 'evaluate', 1e-8),
                                        ('spline_deriv', 'derivative',
                                         1e-8)])
def test_spline_eval_and_deriv(has_native, spline, fn, own, tol):
    sp = spline
    xt = np.concatenate([np.linspace(-9, 9, 2001), sp._x, [sp._x[-1]]])
    got = getattr(tb, fn)(sp._c, sp._x, xt)
    np.testing.assert_array_equal(got, getattr(jb, fn)(sp._c, sp._x, xt))
    np.testing.assert_allclose(got, getattr(tb, fn + '_plain')(sp._c, sp._x,
                                                                xt),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, getattr(sp, own)(xt), rtol=0, atol=tol)


def test_spline_solve(has_native, spline):
    sp = spline
    xt = np.linspace(-9, 9, 2001)
    ev = tb.spline_eval(sp._c, sp._x, xt)
    got = tb.spline_solve(sp._c, sp._x, sp._y, ev)
    np.testing.assert_array_equal(got, jb.spline_solve(sp._c, sp._x, sp._y,
                                                       ev))
    np.testing.assert_allclose(
        got, tb.spline_solve_plain(sp._c, sp._x, sp._y, ev), rtol=0,
        atol=1e-12)
    np.testing.assert_allclose(got, xt, atol=1e-6)
    np.testing.assert_allclose(got, sp.solve(ev), rtol=0, atol=1e-10)


def test_sizes_are_checked(has_native, spline):
    """The C code reads as many elements as the sizes it is passed: a
    mismatched array raises before any pointer is passed."""
    sp, q = spline, np.zeros(3)
    data, w, h, x = _kde_inputs(50, 5)
    sd, sw, prefix = _sorted(data, w)
    calls = {'c should be': [lambda: tb.spline_eval(sp._c[:-1], sp._x, q),
                             lambda: tb.spline_deriv(sp._c, sp._x[:1], q)],
             'y has': [lambda: tb.spline_solve(sp._c, sp._x, sp._y[:-1], q)],
             'weights has': [lambda: tb.kde_cdf(data, w[:-1], h, x)],
             'sweights has': [lambda: tb.kde_cdf_sorted(sd, sw[1:], prefix,
                                                        h, x)],
             'prefix has': [lambda: tb.kde_cdf_sorted(sd, sw, prefix[1:], h,
                                                      x)],
             'V should be': [lambda: tb.sobol_points(np.zeros(32), 4)]}
    for match, fns in calls.items():
        for fn in fns:
            with pytest.raises(ValueError, match=match):
                fn()


def test_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / 'bf_native.c'
    bad.write_text('this is not C;\n')
    monkeypatch.setitem(_build.HOST_LIBRARIES, 'native', str(bad))
    monkeypatch.setattr(tb, '_lib', None)
    monkeypatch.setattr(tb, '_error', None)
    assert not tb.available()
    assert 'error' in tb._error and 'bf_native.c' in tb._error
    data, w, h, x = _kde_inputs(50, 5)
    sd, sw, prefix = _sorted(data, w)
    V = sobol.direction_numbers(3)
    c, k = np.zeros((5, 4)), np.arange(4.0)
    calls = [lambda: tb.sobol_points(V, 4), lambda: tb.kde_cdf(data, w, h, x),
             lambda: tb.kde_cdf_sorted(sd, sw, prefix, h, x),
             lambda: tb.spline_eval(c, k, x), lambda: tb.spline_deriv(c, k, x),
             lambda: tb.spline_solve(c, k, k, x), lambda: tb.set_threads(1),
             tb.team_size]
    for call in calls:
        with pytest.raises(RuntimeError, match='gcc failed'):
            call()
    # the route that needs the library raises too
    from bayesfast_tpu_torch.utils.kde import kde
    tconfig.set_kde_device(False)
    try:
        with pytest.raises(RuntimeError, match='bf_native is unavailable'):
            kde(data).cdf(x)
    finally:
        tconfig.set_kde_device(None)


def test_build_is_keyed_by_source_flags_and_cpu(monkeypatch):
    path = _build.host_path('native')
    assert path.startswith(_build.BUILD_DIR)
    monkeypatch.setattr(_build, '_cpu_model', lambda: 'another CPU')
    assert _build.host_path('native') != path
    monkeypatch.undo()
    monkeypatch.setattr(_build, 'GCC_FLAGS', _build.GCC_FLAGS + ['-g'])
    assert _build.host_path('native') != path


def test_pool_starts_after_a_native_call(has_native):
    from test_torch_parallel import _run_fresh
    _run_fresh(
        'from bayesfast_tpu_torch.native import bindings as tb\n'
        'd = np.random.default_rng(0).normal(size=20000)\n'
        'w = np.full(d.size, 1.0 / d.size)\n'
        'assert tb.team_size() >= 1\n'
        'tb.kde_cdf(d, w, 0.3, np.linspace(-3, 3, 4000))\n'
        'with warnings.catch_warnings():\n'
        "    warnings.simplefilter('error')\n"
        '    flags = tp._external_map()\n'
        'np.testing.assert_array_equal(flags, np.tile([0., 1., 1., 0.], '
        '(4, 1)))\n')
