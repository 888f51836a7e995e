"""Sliced Iterative Transform: a Gaussianizing normalizing flow fitted to
samples.

Counterpart of ``bayesfast_tpu/transforms/sit.py``. Each layer is (i) a
FastICA rotation (``ops.ica``) and (ii) a per-dimension Gaussianization
``ndtri(KDE_cdf(x))`` approximated by a monotone cubic spline. The spline
fits take one of the JAX package's two routes, chosen per layer by
``config.kde_device_route`` of the layer's ``n_rows * dim``: with
``config.kde_on_device()`` on (auto on a CUDA device) the device route,
for data on the card at every size and for data on the CPU from
``config.KDE_DEVICE_MIN`` (100 000) up, as the JAX package chooses; else
the host route.

* Device route, the JAX package's batched device-fit structure on the
  device of ``config.get_device()``: the knot stage (percentile knots,
  edge-regression offsets, weighted bandwidths, the finite-row count) runs
  in torch on the device and comes back to the host as one small pack;
  the spline fits (``utils.cubic.fit_spline_columns``) run on the host and
  evaluate the KDE cdf of every dimension at once, one ``ops.kde``
  ``kde_cdf_batch`` call per fit stage: on the card the KDE-cdf kernel,
  on the CPU its plain version.
* Host route: the rotated data comes to the host in float64 numpy, and
  each dimension is fitted on its own (``_gaussianize_1d``: a ``kde`` and
  a ``cubic_spline`` of ``ndtri`` of its ``kde.cdf``, which sums on the
  host library ``native/``, the windowed sorted sum, below its own
  threshold), the dimensions fanned out over a thread pool with the
  library's OpenMP team capped at one thread.

Either way the fitted layer maps the data on the device for the next
layer. Everything runs in the flow dtype, the run dtype
(``config.get_dtype()``) unless ``flow_dtype`` is set (the host route's fits
in float64). The forward and backward flows are loops over the stacked
layers; the public methods take and return numpy arrays.
"""

import os
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from scipy.special import ndtri

from ..config import get_device, get_dtype, kde_device_route
from ..ops.ica import fast_ica
from ..ops.kde import kde_cdf_batch
from ..utils.cubic import (CubicSplineSet, cubic_spline, fit_spline_columns,
                           _set_derivative, _set_evaluate, _set_solve)
from ..utils.kde import kde
from ..utils.random import generator_from_seed, get_generator
from ..utils.sobol import multivariate_normal

__all__ = ['SIT']


def _knot_stage(y_T, w, bins, eb, edge_points):
    """Stage A of the per-dimension spline fits, on the device: percentile
    knots, edge-regression offsets, weighted Scott bandwidths and the
    finite-row count, as one packed (D, n_q + 2 * edge_points + 2) tensor
    [x0 | xe1 | xe2 | h | n_finite] (the JAX package's
    ``_knot_stage_impl``). The percentiles interpolate linearly, as
    ``np.percentile`` does, between the entries of the rows this stage
    sorts anyway."""
    D, N = y_T.shape
    dt, dev = y_T.dtype, y_T.device
    n_fin = torch.isfinite(y_T).all(dim=0).sum().to(dt)
    ys = torch.sort(y_T, dim=1).values

    def interp(lo, hi, frac):
        a = torch.gather(ys, 1, lo)
        return a + (torch.gather(ys, 1, hi) - a) * frac.to(dt)

    pos = torch.as_tensor(np.linspace(0.0, 100.0, bins + 1)[eb:-eb] / 100.0
                          * (N - 1), device=dev)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=N - 1)
    x0 = interp(lo.expand(D, -1), hi.expand(D, -1), (pos - lo).expand(D, -1))

    # np.percentile over the points below x0[eb] and above x0[-eb - 1]:
    # the first c1 and the last c2 entries of the sorted rows
    ps = torch.as_tensor(np.linspace(0.0, 100.0, edge_points + 2)[1:-1]
                         / 100.0, device=dev)
    c1 = torch.searchsorted(ys, x0[:, eb:eb + 1].contiguous(), right=False)
    c2 = N - torch.searchsorted(ys, x0[:, -eb - 1:x0.shape[1] - eb]
                                .contiguous(), right=True)

    def edge(base, count):
        p = ps[None, :] * (count - 1).double()
        lo = torch.floor(p).long()
        hi = torch.minimum(lo + 1, torch.clamp(count - 1, min=1))
        return interp(torch.clamp(base + lo, 0, N - 1),
                      torch.clamp(base + hi, 0, N - 1), p - lo)

    xe1 = edge(0, c1) - x0[:, :1]
    xe2 = edge(N - c2, c2) - x0[:, -1:]

    wn = w / torch.sum(w)
    s2 = torch.sum(wn * wn)
    diff = y_T - (y_T @ wn)[:, None]
    cov = torch.sum(diff * diff * wn[None, :], dim=1) / (1.0 - s2)
    h = torch.sqrt(cov) * (1.0 / s2) ** (-0.2)
    return torch.cat([x0, xe1, xe2, h[:, None],
                      n_fin.expand(D)[:, None]], dim=1)


class _NonFiniteLayer(Exception):
    """Raised when a layer's input has non-finite rows; ``SIT.fit`` drops
    them and reruns the layer."""


class SIT:
    """Sliced Iterative Transform generative model.

    Parameters mirror the JAX package's. ``random_generator`` is an int
    seed, a ``torch.Generator`` or None (the port's global generator).
    ``flow_dtype`` defaults to ``config.get_dtype()``; the fit and the flow
    run on ``config.get_device()``. ``parallel_backend`` is accepted and
    ignored, as in the JAX package (the per-dimension fits are batched on
    the device, or run on the host's threads); ``mvn_generator(mean, cov,
    n)`` draws ``sample``'s latents (default:
    ``utils.sobol.multivariate_normal``). After ``fit``, ``last_profile``
    holds the fit's host seconds by stage and ``last_routes`` each fitted
    layer's route, ``'device'`` or ``'host'``.
    """

    def __init__(self, n_iter=10, parallel_backend=None, bw_factor=1.,
                 m_ica=20000, random_generator=None, m_plot=8,
                 cubic_options=None, ica_options=None, mvn_generator=None,
                 flow_dtype=None):
        self._data = None
        self._spline_sets = []
        self._stk_key = None
        self.n_iter = n_iter
        self.flow_dtype = flow_dtype
        self.bw_factor = bw_factor
        self.m_ica = m_ica
        self.random_generator = random_generator
        self.m_plot = int(m_plot)
        self.cubic_options = dict(cubic_options or {})
        self.ica_options = dict(ica_options if ica_options is not None
                                else {'max_iter': 100})
        self.mvn_generator = (multivariate_normal if mvn_generator is None
                              else mvn_generator)

    @property
    def flow_dtype(self):
        """Dtype of the fit and of the flow evaluation (``None``: the run
        dtype, resolved per call)."""
        return get_dtype() if self._flow_dtype is None else self._flow_dtype

    @flow_dtype.setter
    def flow_dtype(self, dtype):
        self._flow_dtype = dtype

    @property
    def data(self):
        return self._data

    @property
    def data_init(self):
        return self._data_init

    @property
    def dim(self):
        return self._data.shape[-1]

    @property
    def weights(self):
        return self._weights

    @property
    def n_iter(self):
        return self._n_iter

    @n_iter.setter
    def n_iter(self, n):
        n = int(n)
        if n <= 0:
            raise ValueError('n_iter should be a positive int.')
        self._n_iter = n

    @property
    def i_iter(self):
        return len(self._spline_sets)

    def add_iter(self, n):
        self.n_iter = self.n_iter + n

    @property
    def random_generator(self):
        return get_generator() if self._gen is None else self._gen

    @random_generator.setter
    def random_generator(self, generator):
        if isinstance(generator, (int, np.integer)):
            generator = generator_from_seed(int(generator))
        self._gen = generator

    # ------------- fitting -------------

    def _fit_splines(self, y):
        """All dimensions' spline fits for the layer input ``y`` (N, D):
        the knot stage on the device, then ``fit_spline_columns`` with one
        ``kde_cdf_batch`` call per fit stage. Returns the fitted
        ``CubicSplineSet``."""
        t0 = time.time()
        D = y.shape[1]
        dt, dev = y.dtype, y.device
        data = y.T.contiguous()                          # (D, N)
        w = torch.as_tensor(self._weights, dtype=dt, device=dev)
        co = self.cubic_options
        bins = int(co.get('bins', 100))
        eb = min(int(co.get('edge_bins', 1)), bins // 4)
        edge_points = int(co.get('edge_points', 10))
        pack = _knot_stage(data, w, bins, eb, edge_points).double().cpu() \
            .numpy()
        t0 = self._lap('knots_s', t0)
        n_q = pack.shape[1] - 2 * edge_points - 2
        n_fin = int(pack[0, -1])
        if n_fin < data.shape[1]:
            raise _NonFiniteLayer(data.shape[1] - n_fin)
        knots = []
        for d in range(D):
            x0 = np.unique(pack[d, :n_q])
            if x0.shape[0] < max(4, eb + 2):
                # a collapsed dimension: fetch just this column
                knots.append({'degenerate': data[d].double().cpu().numpy()})
            else:
                knots.append({
                    'x0': x0,
                    'xe1': pack[d, n_q:n_q + edge_points],
                    'xe2': pack[d, n_q + edge_points:n_q + 2 * edge_points]})
        h = torch.as_tensor(pack[:, -2] * self.bw_factor, dtype=dt,
                            device=dev)
        w = w / torch.sum(w)

        def fun_batch(queries):
            m = max(q.size for q in queries)
            if m == 0:
                return [np.empty(0) for _ in queries]
            X = np.full((D, m), 1e30)     # padding queries: cdf 1, unused
            for d, q in enumerate(queries):
                X[d, :q.size] = q
            t_k = time.time()
            cdf = kde_cdf_batch(torch.as_tensor(X, dtype=dt, device=dev),
                                data, w, h).double().cpu().numpy()
            self._lap('kde_s', t_k)
            # guard the tails so ndtri stays finite (the knots are inner
            # percentiles, so this almost never binds)
            cdf = np.clip(cdf, 1e-10, 1.0 - 1e-7)
            return [ndtri(cdf[d, :q.size]) if q.size else np.empty(0)
                    for d, q in enumerate(queries)]

        kde_s = self.last_profile.get('kde_s', 0.0)
        splines = fit_spline_columns(None, fun_batch, knots=knots, **co)
        sset = CubicSplineSet(splines, dtype=dt, device=dev)
        # the host fits: the stage's wall less its KDE calls
        self._lap('splines_s', t0)
        self.last_profile['splines_s'] -= self.last_profile['kde_s'] - kde_s
        return sset

    def _gaussianize_1d(self, x, kde_s):
        """One dimension's spline, ``ndtri`` of its KDE cdf, fitted on the
        host (the JAX package's ``_gaussianize_1d``); appends the seconds
        of its cdf calls to ``kde_s``."""
        k = kde(x, bw_factor=self.bw_factor, weights=self._weights)

        def fun(xx):
            t0 = time.time()
            out = ndtri(k.cdf(xx))
            kde_s.append(time.time() - t0)
            return out

        return cubic_spline(x, fun, **self.cubic_options)

    def _fit_host(self, y):
        """All dimensions' spline fits for the layer input ``y`` (N, D),
        float64 numpy, one ``_gaussianize_1d`` a dimension over a thread
        pool of ``min(D, os.cpu_count())`` workers, with the host
        library's OpenMP team capped at one thread while the pool runs (its
        bits do not depend on the team). Returns the splines."""
        from ..native import bindings as native
        t0 = time.time()
        D = y.shape[1]
        kde_s = []
        n_workers = min(D, os.cpu_count() or 1)
        cols = [np.ascontiguousarray(y[:, i]) for i in range(D)]
        if n_workers > 1:
            native.set_threads(1)    # one OpenMP thread a pool thread
            try:
                with ThreadPoolExecutor(n_workers) as ex:
                    splines = list(ex.map(
                        lambda c: self._gaussianize_1d(c, kde_s), cols))
            finally:
                native.set_threads(0)
        else:
            splines = [self._gaussianize_1d(c, kde_s) for c in cols]
        # the fits' wall, and the seconds of their KDE calls summed over
        # the pool's threads
        self._lap('host_fits_s', t0)
        self.last_profile['host_kde_thread_s'] = \
            self.last_profile.get('host_kde_thread_s', 0.0) + sum(kde_s)
        return splines

    def _layer(self, x):
        """One layer fitted to ``x`` (N, D), a tensor of the flow dtype on
        the device: the ICA rotation, then the spline set. Appends the set
        and returns ``(A, B, m, x_next)`` with numpy float64 ``A``, ``B``,
        ``m``. Adds its walls to ``last_profile``."""
        t0 = time.time()
        if not bool(torch.isfinite(x).all()):
            raise _NonFiniteLayer()
        # the check waits for the previous layer's device evaluation
        t0 = self._lap('evaluate_s', t0)
        gen = self.random_generator
        n_rows = x.shape[0]
        if self.m_ica is not None and n_rows > self.m_ica:
            idx = torch.randperm(n_rows, generator=gen)[:self.m_ica]
            x_fit = x[idx.to(x.device)]
        else:
            x_fit = x
        components, mean = fast_ica(
            x_fit, gen, max_iter=self.ica_options.get('max_iter', 100),
            tol=self.ica_options.get('tol', 1e-4))
        t0 = self._lap('ica_s', t0)
        dt, dev = x.dtype, x.device
        if kde_device_route(n_rows * x.shape[1], dev):
            y = (x - mean) @ components.T
            s = torch.std(y, dim=0, unbiased=False)
            y = y / s
            sset = self._fit_splines(y)
            self._spline_sets.append(sset)
            A = (components.double() / s.double()[:, None]).cpu().numpy()
            m = torch.mean(x, dim=0).double().cpu().numpy()
            self.last_routes.append('device')
            return A, np.linalg.inv(A), m, sset.evaluate(y.T).T
        # the host route: the rotation applied on the host in float64, as
        # the JAX package's host route applies it
        xh = x.double().cpu().numpy()
        comps = components.double().cpu().numpy()
        y = (xh - mean.double().cpu().numpy()) @ comps.T
        s = np.std(y, axis=0)
        y = y / s
        t0 = self._lap('host_copy_s', t0)
        n_bad = int(np.sum(~np.isfinite(y).all(axis=1)))
        if n_bad:
            raise _NonFiniteLayer(n_bad)
        sset = CubicSplineSet(self._fit_host(y), dtype=dt, device=dev)
        self._spline_sets.append(sset)
        A = comps / s[:, None]
        x_next = sset.evaluate(torch.as_tensor(y.T, dtype=dt, device=dev)).T
        self.last_routes.append('host')
        return A, np.linalg.inv(A), np.mean(xh, axis=0), x_next

    def _lap(self, name, t0):
        t1 = time.time()
        self.last_profile[name] = self.last_profile.get(name, 0.0) + t1 - t0
        return t1

    def _init_data(self, data, weights):
        if data is None:
            if self._data is None:
                raise ValueError('no fit data: pass data here or to a '
                                 'previous fit() call.')
            return
        data = np.array(data, np.float64)
        if data.ndim == 2:
            self._data = data
        elif data.ndim >= 3:
            self._data = data.reshape((-1, data.shape[-1]))
        else:
            raise ValueError('invalid shape for data.')
        self._data_init = self._data.copy()
        if self.dim == 1:
            raise ValueError('SIT needs at least 2 dimensions (the '
                             'ICA rotation is undefined in 1-d).')
        n = self._data.shape[0]
        if weights is not None:
            weights = np.asarray(weights)
            if weights.shape != (n,):
                raise ValueError('invalid value for weights.')
            self._weights = weights
        else:
            self._weights = np.ones(n) / n
        self._spline_sets = []
        self._A = np.zeros((0, self.dim, self.dim))
        self._B = np.zeros((0, self.dim, self.dim))
        self._m = np.zeros((0, self.dim))
        self._logdetA = np.zeros(0)

    def fit(self, data=None, weights=None, n_run=None, plot=0):
        """Fit ``n_run`` more Gaussianization layers."""
        self._init_data(data, weights)
        if n_run is None:
            n_run = self.n_iter - self.i_iter
        else:
            n_run = int(n_run)
            if n_run <= 0:
                raise ValueError('invalid value for n_run.')
            if n_run > self.n_iter - self.i_iter:
                self.n_iter = self.i_iter + n_run

        plot = int(plot)
        # host seconds of this fit by stage: evaluate_s (each layer's wait
        # for the previous layer's device evaluation), ica_s; on the device
        # route knots_s, kde_s (the KDE-cdf calls) and splines_s (the host
        # spline fits); on the host route host_copy_s (the rotated data
        # to the host), host_fits_s (the per-dimension fits' wall) and
        # host_kde_thread_s (their KDE calls, summed over the threads)
        self.last_profile = {}
        self.last_routes = []
        x = torch.as_tensor(self._data, dtype=self.flow_dtype,
                            device=get_device())
        for _ in range(n_run):
            try:
                try:
                    A, B, m, x_new = self._layer(x)
                except torch.linalg.LinAlgError:
                    warnings.warn(
                        'the ICA layer failed to converge; retrying once '
                        'with a fresh random seed.', RuntimeWarning)
                    A, B, m, x_new = self._layer(x)
            except _NonFiniteLayer:
                # non-finite rows in the layer input: drop them, as the
                # reference does with the same warning, and rerun the layer
                warnings.warn('inf encountered for some data points. We '
                              'will remove these inf points for now.',
                              RuntimeWarning)
                keep = torch.isfinite(x).all(dim=1)
                x = x[keep]
                self._weights = self._weights[keep.cpu().numpy()]
                A, B, m, x_new = self._layer(x)
            x = x_new
            self._A = np.concatenate((self._A, A[np.newaxis]), axis=0)
            self._B = np.concatenate((self._B, B[np.newaxis]), axis=0)
            self._m = np.concatenate((self._m, m[np.newaxis]), axis=0)
            self._logdetA = np.append(
                self._logdetA, np.log(np.abs(np.linalg.det(A))))
            if plot > 0 and not (self.i_iter % plot):
                self._data = x.double().cpu().numpy()
                self.triangle_plot()
        # the Gaussianized data: diagnostics and further fit() calls
        self._data = x.double().cpu().numpy()
        if plot < 0:
            self.triangle_plot()

    # ------------- transforms -------------

    # rows per device pass: keeps the evidence phase (millions of proposal
    # points through 10+ flow layers) memory-bounded on one device
    _chunk_bytes = 1 << 25

    @property
    def _chunk_rows(self):
        return max(1 << 16, self._chunk_bytes // (8 * max(self.dim, 1)))

    def _stacked(self):
        """Every layer's spline set padded to one width, and the rotations,
        as (L, ...) tensors of the flow dtype on the device (cached per
        layer count, dtype and device)."""
        dt, dev = self.flow_dtype, get_device()
        key = (self.i_iter, dt, dev)
        if self._stk_key == key:
            return self._stk
        L, D = self.i_iter, self.dim
        M = max(s.xs.shape[1] for s in self._spline_sets)
        xs = np.full((L, D, M), np.inf)
        ys = np.full((L, D, M), np.inf)
        cs = np.zeros((L, D, M + 1, 4))
        m = np.zeros((L, D), np.int64)
        for i, ss in enumerate(self._spline_sets):
            for d, s in enumerate(ss.splines):
                n = s._n
                xs[i, d, :n] = s._x
                ys[i, d, :n] = s._y
                cs[i, d, :n + 1] = s._c
                m[i, d] = n

        def t(a):
            return torch.as_tensor(a, dtype=dt, device=dev)

        self._stk = dict(xs=t(xs), ys=t(ys), cs=t(cs),
                         m=torch.as_tensor(m, device=dev), A=t(self._A),
                         B=t(self._B), mu=t(self._m))
        self._stk_key = key
        return self._stk

    def _flow(self, x, forward):
        """(out, log_j) of the whole flow for numpy rows ``x`` (n, D),
        in row chunks; log_j includes the rotations' log-determinants."""
        if x.shape[0] > self._chunk_rows:
            outs = [self._flow(x[o:o + self._chunk_rows], forward)
                    for o in range(0, x.shape[0], self._chunk_rows)]
            return (np.concatenate([o[0] for o in outs]),
                    np.concatenate([o[1] for o in outs]))
        if self.i_iter == 0:
            return x, np.zeros(x.shape[0])
        stk = self._stacked()
        y = torch.as_tensor(x, dtype=self.flow_dtype, device=get_device())
        lj = torch.zeros(y.shape[0], dtype=y.dtype, device=y.device)
        layers = range(self.i_iter) if forward else \
            reversed(range(self.i_iter))
        for i in layers:
            xs, ys, cs, m = (stk[k][i] for k in ('xs', 'ys', 'cs', 'm'))
            if forward:
                yT = ((y - stk['mu'][i]) @ stk['A'][i].T).T.contiguous()
                lj = lj + torch.sum(torch.log(
                    _set_derivative(xs, cs, m, yT)), dim=0)
                y = _set_evaluate(xs, cs, m, yT).T
            else:
                xT = _set_solve(xs, ys, cs, m, y.T.contiguous())
                lj = lj + torch.sum(torch.log(
                    _set_derivative(xs, cs, m, xT)), dim=0)
                y = xT.T @ stk['B'][i].T + stk['mu'][i]
        return (y.double().cpu().numpy(),
                lj.double().cpu().numpy() + np.sum(self._logdetA))

    def _transform(self, x, forward, name):
        x = np.array(x, np.float64)
        if x.ndim == 1:
            x = x[np.newaxis, :]
        if x.shape[-1] != self.dim:
            raise ValueError(f'invalid shape for {name}.')
        shape = x.shape
        out, log_j = self._flow(x.reshape((-1, shape[-1])), forward)
        return out.reshape(shape), log_j.reshape(shape[:-1])

    # ``use_parallel`` is accepted and ignored by the four flow methods, as
    # in the JAX package: the flow runs batched on the device
    def forward_transform(self, x, use_parallel=False):
        """Data space -> latent (approximately N(0, I)); returns
        ``(y, log_j)``, log_j = log|dy/dx|."""
        return self._transform(x, True, 'x')

    def backward_transform(self, y, use_parallel=False):
        """Latent -> data space; returns ``(x, log_j)``, log_j = log|dy/dx|
        at x (the reference's convention for both directions)."""
        return self._transform(y, False, 'y')

    def sample(self, n, use_parallel=False):
        """Draw ``n`` latents with ``mvn_generator`` (Sobol-normal by
        default) and push them back; returns ``(x, log_j, y)``."""
        n = int(n)
        if n <= 0:
            raise ValueError('n should be a positive int.')
        y = self.mvn_generator(np.zeros(self.dim), np.eye(self.dim), n)
        x, log_j = self.backward_transform(y)
        return x, log_j, y

    def logq(self, x, use_parallel=False):
        """Model log-density: the N(0, I) pullback."""
        y, log_j = self.forward_transform(x)
        const = -0.5 * np.log(2 * np.pi)
        return np.sum(const - 0.5 * y ** 2, axis=-1) + log_j

    def triangle_plot(self, show=True):
        """Corner plot of the current (partially Gaussianized) data, with
        getdist when installed, otherwise matplotlib (1-d histograms on the
        diagonal, 2-d histograms below); returns the figure."""
        if 0 < self.m_plot < self.dim:
            plot_data = self._data[:, :self.m_plot]
        else:
            plot_data = self._data
        title = (f'triangle plot after iteration {self.i_iter}'
                 if self.i_iter else 'triangle plot for the initial data')
        try:
            from getdist import plots, MCSamples
            import matplotlib.pyplot as plt
            samples = MCSamples(samples=plot_data)
            g = plots.getSubplotPlotter()
            g.triangle_plot([samples], filled=True,
                            contour_args={'alpha': 0.8},
                            diag1d_kwargs={'normalized': True})
            plt.suptitle(title, fontsize=plot_data.shape[-1] * 4, ha='left')
            fig = plt.gcf()
        except ImportError:
            import matplotlib.pyplot as plt
            d = plot_data.shape[-1]
            fig, axes = plt.subplots(d, d, figsize=(2 * d, 2 * d),
                                     squeeze=False)
            for i in range(d):
                for j in range(d):
                    ax = axes[i][j]
                    if j > i:
                        ax.set_axis_off()
                    elif i == j:
                        ax.hist(plot_data[:, i], bins=40, density=True,
                                histtype='step')
                    else:
                        ax.hist2d(plot_data[:, j], plot_data[:, i], bins=40,
                                  cmap='Blues')
                    if i < d - 1:
                        ax.set_xticklabels([])
                    if j > 0:
                        ax.set_yticklabels([])
            fig.suptitle(title)
            fig.tight_layout()
        if show:
            import matplotlib.pyplot as plt
            plt.show()
        return fig
