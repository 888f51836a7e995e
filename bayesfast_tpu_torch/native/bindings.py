"""ctypes bindings of the host library ``bf_native`` (``src/bf_native.c``).

Counterpart of ``bayesfast_tpu/native/bindings.py``, with the same names,
ctypes signatures and numpy arrays in and out. ``_build.build_host``
compiles the library with gcc and OpenMP at first use into
``bayesfast_tpu_torch/build/``. A failed build is not hidden: ``available()``
returns False and every entry point raises ``RuntimeError`` with gcc's own
output (no numpy stands in for the library; ``config.set_kde_device(True)``
keeps the SIT fit and ``kde.cdf`` off it).

Beside each entry point stands its plain numpy version (``*_plain``), the
function the tests hold the library to; nothing on a route calls them.
"""

import ctypes

import numpy as np
from scipy.special import ndtr

from .. import _build

__all__ = ['available', 'sobol_points', 'kde_cdf', 'kde_cdf_sorted',
           'spline_eval', 'spline_deriv', 'spline_solve', 'set_threads',
           'team_size', 'sobol_points_plain', 'kde_cdf_plain',
           'kde_cdf_sorted_plain', 'spline_eval_plain', 'spline_deriv_plain',
           'spline_solve_plain']

_lib = None
_error = None   # gcc's output (or the loader's) of the failed first load

_c_dbl_p = ctypes.POINTER(ctypes.c_double)
_c_u32_p = ctypes.POINTER(ctypes.c_uint32)
_i64 = ctypes.c_int64


def _bind(lib):
    lib.bf_sobol_points.argtypes = [_c_u32_p, _i64, _i64, _i64, _i64,
                                    _c_dbl_p]
    lib.bf_kde_cdf.argtypes = [_c_dbl_p, _c_dbl_p, _i64, ctypes.c_double,
                               _c_dbl_p, _i64, _c_dbl_p]
    lib.bf_kde_cdf_sorted.argtypes = [_c_dbl_p, _c_dbl_p, _c_dbl_p, _i64,
                                      ctypes.c_double, _c_dbl_p, _i64,
                                      _c_dbl_p]
    lib.bf_set_threads.argtypes = [ctypes.c_int]
    lib.bf_spline_eval.argtypes = [_c_dbl_p, _c_dbl_p, _i64, _c_dbl_p, _i64,
                                   _c_dbl_p]
    lib.bf_spline_deriv.argtypes = lib.bf_spline_eval.argtypes
    lib.bf_spline_solve.argtypes = [_c_dbl_p, _c_dbl_p, _c_dbl_p, _i64,
                                    _c_dbl_p, _i64, _c_dbl_p]
    # the OpenMP runtime the library links
    lib.omp_get_max_threads.restype = ctypes.c_int
    lib.omp_get_max_threads.argtypes = []
    return lib


def _load():
    """The loaded library; the first call builds it. Raises
    ``RuntimeError`` with the build's output, on this and every later call,
    when it could not be built or loaded."""
    global _lib, _error
    if _lib is None and _error is None:
        try:
            _lib = _bind(ctypes.CDLL(_build.build_host('native')))
        except (RuntimeError, OSError, AttributeError) as e:
            _error = str(e)
    if _lib is None:
        raise RuntimeError('the host library bf_native is unavailable: '
                           + _error)
    return _lib


def available():
    """Whether the host library is built and loaded (building it at the
    first call)."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def set_threads(n):
    """Cap (n > 0) or restore (n = 0) the OpenMP team size of every native
    kernel: callers that fan out over host threads set 1 to avoid
    oversubscription. The cap is one process-wide value."""
    _load().bf_set_threads(int(n))


def team_size():
    """The OpenMP team size of an uncapped native kernel
    (``omp_get_max_threads`` of the runtime the library links)."""
    return int(_load().omp_get_max_threads())


def _dp(a):
    return a.ctypes.data_as(_c_dbl_p)


def _f64(a):
    return np.ascontiguousarray(a, np.float64)


def _check_sizes(*pairs):
    """Raise ``ValueError`` unless each (name, array, size) has ``size``
    elements: the C code reads that many through the pointer."""
    for name, a, size in pairs:
        if a.size != size:
            raise ValueError(f'{name} has {a.size} elements, not {size}.')


def sobol_points(V, n, skip=0):
    """Sobol points from a (d, n_bits) uint32 direction matrix; (n, d)."""
    V = np.ascontiguousarray(V, np.uint32)
    if V.ndim != 2:
        raise ValueError('V should be a (d, n_bits) matrix.')
    d, n_bits = V.shape
    lib = _load()
    out = np.empty((int(n), d))
    lib.bf_sobol_points(V.ctypes.data_as(_c_u32_p), d, n_bits, int(n),
                        int(skip), _dp(out))
    return out


def sobol_points_plain(V, n, skip=0):
    """``sobol_points`` in numpy: the Gray code of each index XORs the
    direction numbers of its set bits."""
    V = np.ascontiguousarray(V, np.uint32)
    d, n_bits = V.shape
    i = np.arange(skip, skip + n, dtype=np.uint64)
    g = i ^ (i >> np.uint64(1))
    X = np.zeros((int(n), d), np.uint32)
    for b in range(n_bits):
        mask = ((g >> np.uint64(b)) & np.uint64(1)).astype(bool)
        X[mask] ^= V[:, b]
    return X.astype(np.float64) * 2.0 ** -32


def kde_cdf(data, weights, h, x):
    """Weighted 1-d Gaussian KDE cdf at points x."""
    data, weights, x = _f64(data), _f64(weights), _f64(x)
    _check_sizes(('weights', weights, data.size))
    lib = _load()
    out = np.empty_like(x)
    lib.bf_kde_cdf(_dp(data), _dp(weights), data.size, float(h), _dp(x),
                   x.size, _dp(out))
    return out


def kde_cdf_plain(data, weights, h, x):
    """``kde_cdf`` in numpy: every term's normal cdf, summed by weight."""
    data, weights, x = _f64(data), _f64(weights), _f64(x)
    return ndtr((x[:, None] - data[None, :]) / h) @ weights


def kde_cdf_sorted(sdata, sweights, prefix, h, x):
    """Windowed KDE cdf on presorted data with prefix weight sums: only the
    +-8h kernel window needs erf terms; the caller sorts once per kde."""
    sdata, sweights, prefix, x = (_f64(sdata), _f64(sweights), _f64(prefix),
                                  _f64(x))
    _check_sizes(('sweights', sweights, sdata.size),
                 ('prefix', prefix, sdata.size + 1))
    lib = _load()
    out = np.empty_like(x)
    lib.bf_kde_cdf_sorted(_dp(sdata), _dp(sweights), _dp(prefix),
                          sdata.size, float(h), _dp(x), x.size, _dp(out))
    return out


def kde_cdf_sorted_plain(sdata, sweights, prefix, h, x):
    """``kde_cdf_sorted`` in numpy: the prefix weight below each point's
    window, plus the window's terms."""
    sdata, sweights, prefix, x = (_f64(sdata), _f64(sweights), _f64(prefix),
                                  _f64(x))
    lo = np.searchsorted(sdata, x - 8 * h, side='right')
    out = prefix[lo]
    for i, xi in enumerate(x):
        hi = np.searchsorted(sdata, xi + 8 * h, side='right')
        sl = slice(lo[i], hi)
        out[i] += ndtr((xi - sdata[sl]) / h) @ sweights[sl]
    return out


def _check_spline(c, x):
    c, x = _f64(c), _f64(x)
    if not (x.ndim == 1 and x.size >= 2 and c.shape == (x.size + 1, 4)):
        raise ValueError('c should be (m + 1, 4) for m >= 2 knots x.')
    return c, x


def spline_eval(c, x, xp):
    """A spline's values at ``xp``: ``c`` (m + 1, 4) its coefficients with
    both linear extension rows, ``x`` (m,) its knots."""
    c, x = _check_spline(c, x)
    xp = _f64(xp)
    lib = _load()
    out = np.empty_like(xp)
    lib.bf_spline_eval(_dp(c), _dp(x), x.size, _dp(xp), xp.size, _dp(out))
    return out


def spline_deriv(c, x, xp):
    """The spline's derivative at ``xp``."""
    c, x = _check_spline(c, x)
    xp = _f64(xp)
    lib = _load()
    out = np.empty_like(xp)
    lib.bf_spline_deriv(_dp(c), _dp(x), x.size, _dp(xp), xp.size, _dp(out))
    return out


def spline_solve(c, x, y, yp):
    """The spline's inverse at ``yp`` (``y`` its values at the knots): 60
    bisections of the interval."""
    c, x = _check_spline(c, x)
    y, yp = _f64(y), _f64(yp)
    _check_sizes(('y', y, x.size))
    lib = _load()
    out = np.empty_like(yp)
    lib.bf_spline_solve(_dp(c), _dp(x), _dp(y), x.size, _dp(yp), yp.size,
                        _dp(out))
    return out


# the plain spline versions: ``utils/cubic.py``'s set arithmetic
# (``_set_evaluate``, ``_set_derivative``, ``_set_solve``) for one spline

def _interval(knots, v):
    """The interval ``j`` of each point (``x[j - 1] <= v < x[j]``, 0
    below, m above) and its clip to [1, m]."""
    m = knots.size
    j = np.minimum(np.searchsorted(knots, v, side='right'), m)
    return j, np.clip(j, 1, m)


def _eval_c(c, t):
    return ((c[:, 0] * t + c[:, 1]) * t + c[:, 2]) * t + c[:, 3]


def _deriv_c(c, t):
    return (3.0 * c[:, 0] * t + 2.0 * c[:, 1]) * t + c[:, 2]


def spline_eval_plain(c, x, xp):
    """``spline_eval`` in numpy."""
    c, x = _check_spline(c, x)
    xp = _f64(xp)
    m = x.size
    j, j_in = _interval(x, xp)
    inner = _eval_c(c[j], xp - x[j_in - 1])
    lo = c[0, 2] * (xp - x[0]) + c[0, 3]
    hi = c[m, 2] * (xp - x[m - 1]) + c[m, 3]
    return np.where(j == 0, lo, np.where(j == m, hi, inner))


def spline_deriv_plain(c, x, xp):
    """``spline_deriv`` in numpy."""
    c, x = _check_spline(c, x)
    xp = _f64(xp)
    m = x.size
    j, j_in = _interval(x, xp)
    inner = _deriv_c(c[j], xp - x[j_in - 1])
    return np.where(j == 0, c[0, 2], np.where(j == m, c[m, 2], inner))


def spline_solve_plain(c, x, y, yp):
    """``spline_solve`` in numpy: the bracketed Newton iteration of 28
    lockstep sweeps from a linear-interpolation start."""
    c, x = _check_spline(c, x)
    y, yp = _f64(y), _f64(yp)
    m = x.size
    j, j_in = _interval(y, yp)
    j_hi = np.minimum(j_in, m - 1)
    x0, y0 = x[j_in - 1], y[j_in - 1]
    b = x[j_hi] - x0
    dy = y[j_hi] - y0
    cj = c[j]
    slope = np.where(np.abs(dy) > 0, dy, 1.0)
    t = np.minimum(np.maximum((yp - y0) / slope * b, 0.0), b)
    a = np.zeros_like(yp)
    with np.errstate(divide='ignore', invalid='ignore'):
        for _ in range(28):
            f = _eval_c(cj, t) - yp
            df = _deriv_c(cj, t)
            pos = f > 0
            a = np.where(pos, a, t)
            b = np.where(pos, t, b)
            t_n = t - f / np.where(df > 0, df, 1.0)
            ok = (t_n >= a) & (t_n <= b) & np.isfinite(t_n) & (df > 0)
            t = np.where(ok, t_n, 0.5 * (a + b))
    inner = x0 + np.minimum(np.maximum(t, a), b)
    lo = x[0] + (yp - c[0, 3]) / c[0, 2]
    hi = x[m - 1] + (yp - c[m, 3]) / c[m, 2]
    return np.where(j == 0, lo, np.where(j == m, hi, inner))
