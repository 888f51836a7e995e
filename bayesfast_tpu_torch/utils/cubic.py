"""Monotone piecewise-cubic interpolators for the SIT flow.

Counterpart of ``bayesfast_tpu/utils/cubic.py``, in two parts:

* ``cubic_spline`` and ``fit_spline_columns``: the host-side fit (numpy),
  copied from the JAX package (percentile knots, regression edge slopes,
  C2 tridiagonal solve, per-interval monotonicity check with knot-insertion
  refinement and linear fallback; the function evaluations of each stage
  are batched across columns);
* ``CubicSplineSet``: batched evaluation in torch on the device. Splines of
  different knot counts are padded with +inf knots; a batched
  ``torch.searchsorted`` finds each point's interval, the coefficients are
  gathered column by column, and the inverse is a bracketed Newton
  iteration of 28 lockstep sweeps.
"""

import warnings

import numpy as np
import torch
from scipy.linalg import solve_banded

from ..config import get_device, get_dtype

__all__ = ['cubic_spline', 'CubicSplineSet', 'fit_spline_columns']


def _is_monotone_interval(c, dx):
    """Reference's per-interval monotonicity test (``_cubic.pyx:171-186``).

    ``c`` are the 4 local coefficients, interval is [0, dx].
    """
    A = 3 * c[0] * 0 ** 2 + 2 * c[1] * 0 + c[2]
    B = 3 * c[0] * dx ** 2 + 2 * c[1] * dx + c[2]
    C = 3 * c[0] * 0 + c[1]
    D = 3 * c[0] * dx + c[1]
    delta = c[1] * c[1] - 3 * c[0] * c[2]
    if A > 0 and B > 0 and (C * D) >= 0:
        return True
    if c[0] > 0 and delta < 0:
        return True
    return False


class cubic_spline:
    """Monotone-ish cubic interpolator fitted to percentile knots of data.

    Parameters mirror the reference (``cubic.py:61``): ``x_all`` are data
    samples, ``fun`` the function to interpolate (the KDE-cdf Gaussian map).
    The fitting logic lives in ``fit_spline_columns`` (which batches the
    expensive ``fun`` evaluations across many columns per stage); this
    constructor is the single-column convenience form.
    """

    __slots__ = ('_x', '_n', '_c', '_y')

    def __init__(self, x_all, fun, bins=100, edge_bins=1, edge_points=10,
                 max_width=5, split=4, max_add=5, save_fun=False):
        fitted = fit_spline_columns(
            [x_all], lambda qs: [np.asarray(fun(q), np.float64)
                                 if q.size else np.empty(0) for q in qs],
            bins=bins, edge_bins=edge_bins, edge_points=edge_points,
            max_width=max_width, split=split, max_add=max_add)[0]
        self._x = fitted._x
        self._y = fitted._y
        self._n = fitted._n
        self._c = fitted._c

    @classmethod
    def _degenerate(cls, x_all):
        """(Near-)degenerate data: all percentile knots collapse. The
        reference crashes here; fall back to the affine map y = (x - m) / s
        so the transform stays well-defined."""
        m = float(np.mean(x_all))
        s = float(np.std(x_all))
        s = max(s, 1e-6 * max(abs(m), 1.0))
        warnings.warn('cubic_spline: degenerate data, falling back to '
                      'an affine map.', RuntimeWarning)
        self = cls.__new__(cls)
        self._x = np.array([m - 3 * s, m + 3 * s])
        self._y = np.array([-3.0, 3.0])
        self._n = 2
        k = 1.0 / s
        self._c = np.zeros((3, 4))
        self._c[:, 2] = k
        self._c[0, 3] = self._y[0]
        self._c[1, 3] = self._y[0]
        self._c[2, 3] = self._y[1]
        return self

    def _fit(self, k_edge_1, k_edge_2):
        """C2 cubic fit with clamped edge slopes (``cubic.py:153-194``)."""
        self._c = np.zeros((self._n + 1, 4))
        self._c[0, 2:] = (k_edge_1, self._y[0])
        self._c[-1, 2:] = (k_edge_2, self._y[-1])

        dx = np.diff(self._x)
        slope = np.diff(self._y) / dx
        n = self._n
        A = np.zeros((3, n))
        b = np.empty(n)
        A[1, 1:-1] = 2 * (dx[:-1] + dx[1:])
        A[0, 2:] = dx[:-1]
        A[-1, :-2] = dx[1:]
        b[1:-1] = 3 * (dx[1:] * slope[:-1] + dx[:-1] * slope[1:])
        A[1, 0] = 1
        A[0, 1] = 0
        b[0] = k_edge_1
        A[1, -1] = 1
        A[-1, -2] = 0
        b[-1] = k_edge_2
        s = solve_banded((1, 1), A, b, overwrite_ab=True, overwrite_b=True,
                         check_finite=False)
        t = (s[:-1] + s[1:] - 2 * slope) / dx
        self._c[1:-1, 0] = t / dx
        self._c[1:-1, 1] = (slope - s[:-1]) / dx - t
        self._c[1:-1, 2] = s[:-1]
        self._c[1:-1, 3] = self._y[:-1]

    def _check(self):
        out = np.empty(self._n - 1, dtype=bool)
        dxs = np.diff(self._x)
        for i in range(1, self._n):
            out[i - 1] = _is_monotone_interval(self._c[i], dxs[i - 1])
        return out

    def _regularize_y(self):
        """Flatten near-non-increasing runs of y (``cubic.py:196-224``)."""
        x_diff = np.diff(self._x)
        k = np.diff(self._y) / x_diff
        bad_index = np.where(k < 1e-10)[0]
        n_b = bad_index.size
        while n_b > 0:
            while n_b > 0:
                i_b = 0
                start_b = max(bad_index[i_b] - 1, 0)
                while i_b < n_b - 1:
                    if bad_index[i_b + 1] - bad_index[i_b] <= 2:
                        i_b += 1
                    else:
                        break
                end_b = min(bad_index[i_b] + 1, k.size - 1)
                k_b = (self._y[end_b + 1] - self._y[start_b]) / (
                    self._x[end_b + 1] - self._x[start_b])
                for j_b in range(start_b + 1, end_b + 1):
                    self._y[j_b] = self._y[start_b] + k_b * (
                        self._x[j_b] - self._x[start_b])
                bad_index = bad_index[(i_b + 1):]
                n_b = bad_index.size
            k = np.diff(self._y) / x_diff
            bad_index = np.where(k < 1e-8)[0]
            n_b = bad_index.size

    # ---- single-spline evaluation through the batched set ----

    def _as_set(self):
        return CubicSplineSet([self])

    def _run(self, fn, x):
        x = np.atleast_1d(np.asarray(x, np.float64))
        s = self._as_set()
        xt = torch.as_tensor(x[None, :], dtype=s.xs.dtype, device=s.xs.device)
        return getattr(s, fn)(xt)[0].cpu().numpy().astype(np.float64)

    def evaluate(self, x):
        return self._run('evaluate', x)

    __call__ = evaluate

    def derivative(self, x):
        return self._run('derivative', x)

    def solve(self, y):
        return self._run('solve', y)


def fit_spline_columns(cols, fun_batch, bins=100, edge_bins=1,
                       edge_points=10, max_width=5, split=4, max_add=5,
                       knots=None):
    """Fit one monotone percentile-knot spline per data column, with the
    expensive target-function evaluations batched across columns.

    ``fun_batch(queries)`` takes a list with one 1-d query array per column
    (possibly empty) and returns the function values in the same layout —
    the SIT fit implements it as ONE padded device kernel per stage, where
    per-column evaluation (the reference's pool-map, ``sit.py:230``) would
    pay one device round trip per column.

    ``knots`` (optional) supplies per-column stage-A data computed on
    device (``transforms.sit._knot_stage``): dicts with ``x0``,
    ``xe1``, ``xe2`` (or ``degenerate`` = raw column for collapsed dims),
    so the host never touches the full data columns — ``cols`` may then be
    ``None``. The stage-A batch also evaluates every interval's would-be
    refinement midpoints, so the FIRST monotonicity-refinement round
    consumes cached values instead of paying another device round trip
    (the JAX package's default, ``speculative=True``).

    Stage structure (identical arithmetic to the reference's sequential
    constructor, ``cubic.py:61-151``): percentile knots + edge-regression
    points + wide-interval splits need no function values, so they form one
    batched evaluation; each later refinement round across all columns
    forms another.
    """
    n_col = len(cols) if knots is None else len(knots)
    if cols is not None:
        cols = [np.ascontiguousarray(c, np.float64) for c in cols]
    eb = min(edge_bins, bins // 4)
    splines = [None] * n_col
    st = [None] * n_col
    mid_x = [None] * n_col
    t_mid = np.arange(1, split, dtype=np.float64)

    # ---- stage A (no function values): knots, edge offsets, width splits
    queries = []
    for d in range(n_col):
        if knots is not None:
            kd = knots[d]
            if 'degenerate' in kd:
                splines[d] = cubic_spline._degenerate(kd['degenerate'])
                queries.append(np.empty(0))
                continue
            x0 = np.asarray(kd['x0'], np.float64)
            xe1 = np.asarray(kd['xe1'], np.float64)
            xe2 = np.asarray(kd['xe2'], np.float64)
        else:
            x_all = cols[d]
            x0 = np.unique(np.percentile(
                x_all, np.linspace(0, 100, bins + 1)[eb:-eb]))
            if x0.shape[0] < max(4, eb + 2):
                splines[d] = cubic_spline._degenerate(x_all)
                queries.append(np.empty(0))
                continue
            xe1 = np.percentile(x_all[x_all < x0[eb]] - x0[0],
                                np.linspace(0, 100, edge_points + 2)[1:-1])
            xe2 = np.percentile(x_all[x_all > x0[-eb - 1]] - x0[-1],
                                np.linspace(0, 100, edge_points + 2)[1:-1])

        # split overly wide intervals (x-spacing only; ``cubic.py:96-115``)
        x = x0
        n = x.shape[0]
        diff = np.diff(x)
        diff_r = diff / np.mean(diff)
        i_1 = 0
        while i_1 < n - 2 and diff_r[i_1] > max_width:
            i_1 += 1
        i_2 = n - 2
        while i_2 > 0 and diff_r[i_2] > max_width:
            i_2 -= 1
        if i_1 <= i_2:
            sparse_index = np.where(
                diff_r[i_1:(i_2 + 1)] > max_width)[0] + i_1
            if sparse_index.size:
                x_aug = np.empty(0)
                for j in sparse_index:
                    n_j = int(np.ceil(diff_r[j] / split))
                    x_aug = np.concatenate(
                        (x_aug, np.linspace(x[j], x[j + 1], n_j + 1)[1:-1]))
                x = np.insert(x, np.searchsorted(x, x_aug), x_aug)

        st[d] = {'x': x, 'xe1': xe1, 'xe2': xe2}
        q = [x, xe1 + x0[0], xe2 + x0[-1]]
        if max_add > 0:
            # same formula as np.linspace's interior points
            step = np.diff(x) / split
            mids = x[:-1, None] + step[:, None] * t_mid[None, :]
            mid_x[d] = mids                      # (n_x - 1, split - 1)
            q.append(mids.ravel())
        queries.append(np.concatenate(q))

    ys = fun_batch(queries)

    # ---- first fit per column
    mid_y = [None] * n_col
    for d in range(n_col):
        if splines[d] is not None:
            continue
        x = st[d]['x']
        n_x = x.shape[0]
        ep = st[d]['xe1'].shape[0]
        y = np.asarray(ys[d][:n_x], np.float64)
        y_e1 = np.asarray(ys[d][n_x:n_x + ep]) - y[0]
        y_e2 = np.asarray(ys[d][n_x + ep:n_x + 2 * ep]) - y[-1]
        if mid_x[d] is not None:
            mid_y[d] = np.asarray(
                ys[d][n_x + 2 * ep:], np.float64).reshape(mid_x[d].shape)
        xe1, xe2 = st[d]['xe1'], st[d]['xe2']
        k1 = np.sum(xe1 * y_e1) / np.sum(xe1 * xe1)
        k2 = np.sum(xe2 * y_e2) / np.sum(xe2 * xe2)
        s = cubic_spline.__new__(cubic_spline)
        s._x, s._y, s._n = x, y, n_x
        s._fit(k1, k2)
        st[d].update(k1=k1, k2=k2, check=s._check())
        splines[d] = s

    # ---- monotonicity-refinement rounds, batched across columns
    add_points = 0
    while add_points < max_add:
        cached = add_points == 0
        queries = []
        live = []
        for d in range(n_col):
            if st[d] is None or np.all(st[d]['check']):
                queries.append(np.empty(0))
                continue
            s = splines[d]
            bad = np.where(~st[d]['check'])[0]
            if cached and mid_x[d] is not None:
                x_aug = mid_x[d][bad].ravel()
                queries.append(x_aug)
                st[d]['y_aug'] = mid_y[d][bad].ravel()
            else:
                x_aug = np.empty(0)
                for j in bad:
                    x_aug = np.concatenate(
                        (x_aug, np.linspace(s._x[j], s._x[j + 1],
                                            split + 1)[1:-1]))
                queries.append(x_aug)
            live.append(d)
        if not live:
            break
        if cached and all(st[d].get('y_aug') is not None for d in live):
            ys = [st[d].pop('y_aug', None) if d in live else None
                  for d in range(n_col)]
        else:
            ys = fun_batch(queries)
        for d in live:
            s = splines[d]
            x_aug = queries[d]
            idx = np.searchsorted(s._x, x_aug)
            s._x = np.insert(s._x, idx, x_aug)
            s._y = np.insert(s._y, idx, np.asarray(ys[d], np.float64))
            if add_points == max_add - 1:
                s._regularize_y()
            s._n = s._x.shape[0]
            s._fit(st[d]['k1'], st[d]['k2'])
            st[d]['check'] = s._check()
        add_points += 1

    # ---- linear fallback on still-non-monotone intervals
    for d in range(n_col):
        if st[d] is None:
            continue
        check = st[d]['check']
        if not np.all(check):
            s = splines[d]
            for i_b in np.where(~check)[0] + 1:
                s._c[i_b, 0] = 0
                s._c[i_b, 1] = 0
                s._c[i_b, 2] = (s._y[i_b] - s._y[i_b - 1]) / (
                    s._x[i_b] - s._x[i_b - 1])
                s._c[i_b, 3] = s._y[i_b - 1]
            if not np.all(s._check()):
                warnings.warn('Not all the intervals are monotone.',
                              RuntimeWarning)
    return splines


# ------------------- batched device kernels -------------------
# xs (D, M) knots padded with +inf, ys (D, M), cs (D, M + 1, 4)
# coefficients, m (D,) int64 knot counts, points (D, n).


def _interval(knots, m, pts):
    """The interval index ``j`` (searchsorted, side right, capped at m) and
    its clip to [1, m]."""
    j = torch.searchsorted(knots, pts.contiguous(), right=True)
    j = torch.minimum(j, m[:, None])
    return j, torch.minimum(torch.clamp(j, min=1), m[:, None])


def _gather_coeffs(cs, j):
    """The four coefficients of interval ``j``, one column at a time."""
    return tuple(torch.gather(cs[:, :, k], 1, j) for k in range(4))


def _eval_cols(cols, t):
    a, b, cc, d = cols
    return ((a * t + b) * t + cc) * t + d


def _deriv_cols(cols, t):
    a, b, cc, _ = cols
    return (3.0 * a * t + 2.0 * b) * t + cc


def _at(a, idx):
    """Row-wise ``a[d, idx[d]]`` for a (D,) index: (D, 1)."""
    return torch.gather(a, 1, idx[:, None])


def _set_evaluate(xs, cs, m, xp):
    j, j_in = _interval(xs, m, xp)
    dx_in = xp - torch.gather(xs, 1, j_in - 1)
    dx_lo = xp - xs[:, :1]
    inner = _eval_cols(_gather_coeffs(cs, j), dx_in)
    lo = cs[:, 0, 2:3] * dx_lo + cs[:, 0, 3:4]
    c_hi = cs[torch.arange(cs.shape[0], device=cs.device), m]   # (D, 4)
    hi = c_hi[:, 2:3] * (xp - _at(xs, m - 1)) + c_hi[:, 3:4]
    return torch.where(j == 0, lo, torch.where(j == m[:, None], hi, inner))


def _set_derivative(xs, cs, m, xp):
    j, j_in = _interval(xs, m, xp)
    dx_in = xp - torch.gather(xs, 1, j_in - 1)
    inner = _deriv_cols(_gather_coeffs(cs, j), dx_in)
    c_hi = cs[torch.arange(cs.shape[0], device=cs.device), m]
    return torch.where(j == 0, cs[:, 0, 2:3],
                       torch.where(j == m[:, None], c_hi[:, 2:3], inner))


def _set_solve(xs, ys, cs, m, yp):
    """Inverse via bracketed Newton (28 lockstep sweeps), as the JAX
    package's ``_set_solve``: safeguarded Newton from a linear-interpolation
    start, the bracket keeping the bisection worst case. The bracket test
    is inclusive: after the sign update one bracket end is the current
    point, and a converged Newton step lands exactly there."""
    j, j_in = _interval(ys, m, yp)
    j_hi = torch.minimum(j_in, (m - 1)[:, None])
    x0 = torch.gather(xs, 1, j_in - 1)
    x1 = torch.gather(xs, 1, j_hi)
    y0 = torch.gather(ys, 1, j_in - 1)
    y1 = torch.gather(ys, 1, j_hi)
    cj = _gather_coeffs(cs, j)

    b = x1 - x0
    dy = y1 - y0
    slope = torch.where(torch.abs(dy) > 0, dy, torch.ones_like(dy))
    t = torch.minimum(torch.clamp((yp - y0) / slope * b, min=0.0), b)
    a = torch.zeros_like(yp)
    for _ in range(28):
        f = _eval_cols(cj, t) - yp
        df = _deriv_cols(cj, t)
        pos = f > 0
        a = torch.where(pos, a, t)
        b = torch.where(pos, t, b)
        t_n = t - f / torch.where(df > 0, df, torch.ones_like(df))
        mid = 0.5 * (a + b)
        ok = (t_n >= a) & (t_n <= b) & torch.isfinite(t_n) & (df > 0)
        t = torch.where(ok, t_n, mid)
    inner = x0 + torch.minimum(torch.maximum(t, a), b)
    c_hi = cs[torch.arange(cs.shape[0], device=cs.device), m]
    lo = xs[:, :1] + (yp - cs[:, 0, 3:4]) / cs[:, 0, 2:3]
    hi = _at(xs, m - 1) + (yp - c_hi[:, 3:4]) / c_hi[:, 2:3]
    return torch.where(j == 0, lo, torch.where(j == m[:, None], hi, inner))


class CubicSplineSet:
    """A batch of fitted 1-d splines (one per dimension) with padded storage
    for batched evaluation. Inputs and outputs are tensors of shape
    (D, n_points) on the set's device, in its dtype (default
    ``config.get_dtype()`` on ``config.get_device()``)."""

    def __init__(self, splines, dtype=None, device=None):
        self.splines = list(splines)
        D = len(self.splines)
        m = np.array([s._n for s in self.splines], np.int64)
        M = int(m.max())
        xs = np.full((D, M), np.inf)
        ys = np.full((D, M), np.inf)
        cs = np.zeros((D, M + 1, 4))
        for d, s in enumerate(self.splines):
            xs[d, :s._n] = s._x
            ys[d, :s._n] = s._y
            cs[d, :s._n + 1] = s._c
        kw = dict(dtype=dtype or get_dtype(), device=device or get_device())
        self.xs = torch.as_tensor(xs, **kw)
        self.ys = torch.as_tensor(ys, **kw)
        self.cs = torch.as_tensor(cs, **kw)
        self.m = torch.as_tensor(m, device=kw['device'])

    def _pts(self, p):
        return torch.as_tensor(p, dtype=self.xs.dtype, device=self.xs.device)

    def evaluate(self, xp):
        return _set_evaluate(self.xs, self.cs, self.m, self._pts(xp))

    def derivative(self, xp):
        return _set_derivative(self.xs, self.cs, self.m, self._pts(xp))

    def solve(self, yp):
        return _set_solve(self.xs, self.ys, self.cs, self.m, self._pts(yp))
