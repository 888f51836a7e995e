"""The port's monotone cubic splines (``utils/cubic.py``) against the JAX
package's.

The fit is host numpy on both sides (copied code): on the same queries and
function values it returns identical knots and coefficients. The batched
evaluation, derivative and inverse of ``CubicSplineSet`` run in torch on
the port's side and in jnp on the JAX side, on the same fitted splines, in
float64; they agree to rel 1e-10 (the inverse is 28 Newton sweeps on both
sides), on points inside the knots and beyond both ends.
"""

import numpy as np
import pytest
import torch

from bayesfast_tpu.utils import cubic as jcub
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.utils import cubic as tcub


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


_FUNS = [lambda x: np.arctan(x) * 2 + 0.1 * x,
         lambda x: x ** 3 / 10 + x,
         lambda x: np.tanh(x) * 3 + 0.2 * x,
         lambda x: np.sinh(x / 2) + 0.01 * x]


def _cols(n=3000, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=n) * 1.5, rng.standard_t(3, size=n),
            rng.gamma(2.0, size=n) - 2.0, rng.uniform(-3, 3, size=n)]


def _fun_batch(queries):
    return [f(q) if q.size else np.empty(0) for f, q in zip(_FUNS, queries)]


@pytest.mark.parametrize('opts', [{}, {'bins': 40, 'edge_bins': 2},
                                  {'max_add': 0},
                                  {'max_width': 2, 'split': 3}])
def test_fit_spline_columns_identical(opts):
    sj = jcub.fit_spline_columns(_cols(), _fun_batch, **opts)
    st = tcub.fit_spline_columns(_cols(), _fun_batch, **opts)
    for a, b in zip(sj, st):
        assert a._n == b._n
        for k in ('_x', '_y', '_c'):
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k))


def _points(splines, n=400, seed=3):
    """Per column: points across the knots and beyond both ends."""
    rng = np.random.default_rng(seed)
    out = []
    for s in splines:
        lo, hi = s._x[0], s._x[-1]
        w = hi - lo
        out.append(np.concatenate([
            rng.uniform(lo, hi, n - 6), s._x[[0, 1, -1]],
            [lo - 0.3 * w, lo - 5.0, hi + 7.0]]))
    return np.stack(out)


@pytest.mark.parametrize('fn', ['evaluate', 'derivative', 'solve'])
def test_spline_set_matches_jax(fn):
    splines = jcub.fit_spline_columns(_cols(), _fun_batch)
    sj = jcub.CubicSplineSet(splines)
    ss = tcub.CubicSplineSet(splines, dtype=torch.float64)
    pts = _points(splines)
    if fn == 'solve':
        pts = np.array(sj.evaluate(pts))
    want = np.asarray(getattr(sj, fn)(pts))
    got = getattr(ss, fn)(torch.as_tensor(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    if fn == 'solve':    # and the inverse inverts
        np.testing.assert_allclose(got, _points(splines), rtol=0, atol=1e-7)


def test_single_spline_matches_jax():
    rng = np.random.default_rng(0)
    x_all = rng.normal(size=5000) * 2.0
    sj = jcub.cubic_spline(x_all, _FUNS[0])
    st = tcub.cubic_spline(x_all, _FUNS[0])
    np.testing.assert_array_equal(st._c, sj._c)
    xt = np.linspace(-30, 30, 101)
    for fn in ('evaluate', 'derivative'):
        np.testing.assert_allclose(getattr(st, fn)(xt), getattr(sj, fn)(xt),
                                   rtol=1e-10, atol=1e-12)
    yt = sj(xt)
    np.testing.assert_allclose(st.solve(yt), sj.solve(yt), rtol=1e-10)


def test_degenerate_column_falls_back_to_affine():
    cols = [np.full(500, 2.0), _cols()[0][:500]]
    with pytest.warns(RuntimeWarning, match='degenerate'):
        st = tcub.fit_spline_columns(cols, lambda qs: [
            np.arctan(q) for q in qs])
    ss = tcub.CubicSplineSet(st, dtype=torch.float64)
    y = ss.evaluate(torch.tensor([[1.0, 2.0, 3.0], [0.0, 0.0, 0.0]]))
    assert torch.isfinite(y).all() and y[0, 0] < y[0, 1] < y[0, 2]
