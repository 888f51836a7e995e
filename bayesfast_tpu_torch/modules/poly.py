"""Polynomial surrogate model.

Counterpart of ``bayesfast_tpu/modules/poly.py``. Coefficients are kept in
the least-squares monomial basis, so evaluation is a feature map and a
matmul, ``y = A @ phi(x)`` with ``A`` of shape (output_size, n_features),
batched over rows, and autograd differentiates it. The feature orderings
are the JAX package's (``poly.py:43-59``: quadratic ``k <= l`` row-major,
cubic-2 all ``(k, l)`` with ``x_k^2 x_l``, cubic-3 ``k < l < p``), so
fitted coefficients compare one to one. The fit solves all outputs that
share a recipe row in one multi-RHS least-squares problem, on the host in
float64 (``poly.py:345-405``), and the Mahalanobis-bound linear
extrapolation (``poly.py:271-288``, ``:319-341``) is kept exactly.

Sampling does not evaluate this module: ``Density.kernel_spec`` hands the
fitted coefficients, bound and likelihood to the CUDA NUTS kernels, which
compute the same surrogate compiled in (``ops/densities.py``).
"""

from collections import namedtuple

import numpy as np
import torch

from ..core.module import Surrogate

__all__ = ['PolyConfig', 'PolyModel']

BoundOptions = namedtuple('BoundOptions',
                          ('use_bound', 'alpha', 'alpha_p', 'center_max'))

_ORDERS = ('linear', 'quadratic', 'cubic-2', 'cubic-3')


def _feature_indices(order, n):
    """Monomial index arrays for one config (``poly.py:43-59``)."""
    if order == 'linear':
        return None
    if order == 'quadratic':
        k, l = np.triu_indices(n)
        return (k, l)
    if order == 'cubic-2':
        k, l = np.mgrid[0:n, 0:n]
        return (k.reshape(-1), l.reshape(-1))
    if order == 'cubic-3':
        idx = np.array([(k, l, p) for k in range(n) for l in range(k + 1, n)
                        for p in range(l + 1, n)], dtype=int)
        if idx.size == 0:
            idx = idx.reshape(0, 3)
        return (idx[:, 0], idx[:, 1], idx[:, 2])
    raise ValueError(f'unexpected order {order}.')


def _n_features(order, n):
    """Independent coefficient count per output (``poly.py:62-72``)."""
    if order == 'linear':
        return n + 1
    if order == 'quadratic':
        return n * (n + 1) // 2
    if order == 'cubic-2':
        return n * n
    if order == 'cubic-3':
        return n * (n - 1) * (n - 2) // 6
    raise ValueError(f'unexpected order {order}.')


def _features(order, idx, x):
    """Feature rows phi(x) (N, n_features) of one config; x is the masked
    input (N, n)."""
    if order == 'linear':
        return torch.cat([torch.ones_like(x[:, :1]), x], dim=-1)
    if order == 'quadratic':
        k, l = idx
        return x[:, k] * x[:, l]
    if order == 'cubic-2':
        k, l = idx
        return x[:, k] * x[:, k] * x[:, l]
    k, l, p = idx
    return x[:, k] * x[:, l] * x[:, p]


class PolyConfig:
    """One polynomial block (``poly.py:89-173``): order + input/output masks +
    coefficient matrix in the monomial basis."""

    def __init__(self, order, input_mask=None, output_mask=None):
        if order not in _ORDERS:
            raise ValueError(f'order should be one of {_ORDERS}, instead of '
                             f'"{order}".')
        self._order = order
        self._set_input_mask(input_mask)
        self._set_output_mask(output_mask)
        self._a = None      # (output_size, n_features) monomial coefficients
        self._idx = None

    @property
    def order(self):
        return self._order

    @property
    def input_mask(self):
        return self._input_mask

    def _set_input_mask(self, im):
        if im is None:
            self._input_mask = None
        else:
            self._input_mask = np.sort(np.unique(np.asarray(im, dtype=int)))
        self._idx = None

    @property
    def output_mask(self):
        return self._output_mask

    def _set_output_mask(self, om):
        if om is None:
            self._output_mask = None
        else:
            self._output_mask = np.sort(np.unique(np.asarray(om, dtype=int)))

    @property
    def input_size(self):
        return self._input_mask.size if self._input_mask is not None else None

    @property
    def output_size(self):
        return (self._output_mask.size if self._output_mask is not None
                else None)

    @property
    def _a_shape(self):
        return (_n_features(self._order, self.input_size),)

    @property
    def n_features(self):
        return _n_features(self._order, self.input_size)

    def _indices(self):
        if self._idx is None:
            self._idx = _feature_indices(self._order, self.input_size)
        return self._idx

    def _ensure_coef(self):
        if self._a is None:
            self._a = np.zeros((self.output_size, self.n_features))
        return self._a

    def _set(self, a, i):
        """Set the monomial coefficients of output row ``i``."""
        a = np.asarray(a)
        if a.shape != self._a_shape:
            raise ValueError(f'shape of a {a.shape} does not match the '
                             f'expected shape {self._a_shape}.')
        i = int(i)
        if not 0 <= i < self.output_size:
            raise ValueError(f'i = {i} out of range.')
        self._ensure_coef()[i] = a

    def _phi(self, x_masked):
        return _features(self._order, self._indices(), x_masked)

    def _eval(self, a, x_full):
        """Masked gather -> features -> matmul: (N, output_size)."""
        mask = torch.as_tensor(self._input_mask, device=x_full.device)
        return self._phi(x_full[:, mask]) @ a.T


class PolyModel(Surrogate):
    """Polynomial surrogate (``poly.py:176-413``)."""

    def __init__(self, configs, bound_options=None, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if isinstance(configs, str):
            try:
                upto = _ORDERS.index(configs)
            except ValueError:
                raise ValueError('if configs is a str, it should be "linear", '
                                 '"quadratic", "cubic-2" or "cubic-3".')
            configs = list(_ORDERS[:upto + 1])
        if isinstance(configs, PolyConfig):
            configs = [configs]
        if not hasattr(configs, '__iter__'):
            raise ValueError('invalid value for configs.')
        built = []
        for conf in configs:
            if isinstance(conf, str):
                conf = PolyConfig(conf)
            if not isinstance(conf, PolyConfig):
                raise ValueError('invalid element in configs.')
            if conf._input_mask is None:
                conf._set_input_mask(np.arange(self._input_size))
            if conf._output_mask is None:
                conf._set_output_mask(np.arange(self._output_size))
            built.append(conf)
        self._configs = tuple(built)
        self._build_recipe()
        self._mu = np.zeros(self._input_size)
        self._hess = np.eye(self._input_size)
        self._f_mu = np.zeros(self._output_size)
        self._alpha = None
        if bound_options is None:
            bound_options = {}
        if not isinstance(bound_options, dict):
            raise ValueError('bound_options should be a dict.')
        self.set_bound_options(**bound_options)

    @property
    def configs(self):
        return self._configs

    @property
    def n_config(self):
        return len(self._configs)

    @property
    def recipe(self):
        return self._recipe

    def _build_recipe(self):
        """Per-output (linear, quadratic, cubic-2, cubic-3) config table with
        overlap checks (``poly.py:227-243``)."""
        rr = np.full((self._output_size, 4), -1)
        for ii, conf in enumerate(self._configs):
            col = _ORDERS.index(conf.order)
            if np.any(rr[conf._output_mask, col] >= 0):
                raise ValueError(
                    f'multiple {conf.order} PolyConfig(s) share at least one '
                    f'common output variable. Please check your PolyConfig '
                    f'#{ii}.')
            rr[conf._output_mask, col] = ii
        if np.any(np.all(rr < 0, axis=1)):
            raise ValueError('no PolyConfig has output for variable(s) {}.'
                             .format(np.argwhere(np.all(rr < 0,
                                                        axis=1)).flatten()))
        self._recipe = rr

    # ------------- bound options (``poly.py:247-288``) -------------

    @property
    def bound_options(self):
        return BoundOptions(self._use_bound, self._alpha, self._alpha_p,
                            self._center_max)

    def set_bound_options(self, use_bound=True, alpha=None, alpha_p=100.,
                          center_max=True):
        self._use_bound = bool(use_bound)
        if alpha is not None:
            alpha = float(alpha)
            if alpha <= 0:
                raise ValueError('invalid value for alpha.')
            self._alpha = alpha
        if alpha_p is None:
            if alpha is None:
                raise ValueError('alpha and alpha_p cannot both be None.')
            self._alpha_p = None
        else:
            alpha_p = float(alpha_p)
            if alpha_p <= 0:
                raise ValueError('invalid value for alpha_p.')
            self._alpha_p = alpha_p
        self._center_max = bool(center_max)

    def _set_bound(self, x, logp=None):
        x = np.ascontiguousarray(x, dtype=np.float64)
        self._mu = np.mean(x, axis=0)
        self._hess = np.linalg.inv(np.cov(x, rowvar=False))
        if self._alpha_p is not None:
            beta = np.einsum('ij,jk,ik->i', x - self._mu, self._hess,
                             x - self._mu) ** 0.5
            if self._alpha_p < 100.:
                self._alpha = np.percentile(beta, self._alpha_p)
            else:
                self._alpha = np.max(beta) * self._alpha_p / 100.
        if self._center_max and logp is not None:
            logp = np.asarray(logp)
            mu_f = x[np.argmax(logp)]
        else:
            mu_f = self._mu
        with torch.no_grad():
            coefs = [torch.as_tensor(c._ensure_coef(), dtype=torch.float64)
                     for c in self._configs]
            self._f_mu = self._eval_raw(
                coefs, torch.as_tensor(mu_f, dtype=torch.float64)[None])[0]
        self._f_mu = self._f_mu.numpy()

    # ------------- dynamic parameters -------------

    @property
    def bound_active(self):
        """Whether evaluation extrapolates beyond the bound: ``use_bound``
        on, a config that is not linear, and a finite ``alpha``."""
        return (self._use_bound and not self._all_linear
                and self._alpha is not None and np.isfinite(self._alpha))

    def dynamic_params(self):
        """A snapshot (copies) of the coefficients and the bound."""
        alpha = np.inf if self._alpha is None else float(self._alpha)
        return {
            'coefs': tuple(np.array(c._ensure_coef()) for c in self._configs),
            'mu': np.array(self._mu, np.float64),
            'hess': np.array(self._hess, np.float64),
            'alpha': alpha,
            'f_mu': np.array(self._f_mu, np.float64),
        }

    # ------------- batched evaluation -------------

    def _eval_raw(self, coefs, x):
        """Sum of all config contributions, scatter-added over the output
        masks (``poly.py:310-317``); x (N, input_size)."""
        out = x.new_zeros((x.shape[0], self._output_size))
        for conf, a in zip(self._configs, coefs):
            om = torch.as_tensor(conf._output_mask, device=x.device)
            out = out.index_add(1, om, conf._eval(a, x))
        return out

    def _fun_traced(self, ctx, x):
        p = ctx if ctx is not None else self.dynamic_params()

        def t(a):
            return torch.as_tensor(a, dtype=x.dtype, device=x.device)

        coefs = [t(a) for a in p['coefs']]
        if not self._use_bound or self._all_linear:
            return self._eval_raw(coefs, x)
        mu, hess, alpha, f_mu = (t(p['mu']), t(p['hess']), t(p['alpha']),
                                 t(p['f_mu']))
        delta = x - mu
        beta = torch.sqrt(torch.clamp(torch.sum((delta @ hess) * delta, -1),
                                      min=1e-30))
        inside = beta <= alpha
        # Linear extrapolation beyond the alpha-ellipsoid, branch-free; the
        # unselected branch stays finite (beta_safe = 1 inside, alpha_safe
        # = 1 before the first fit) so that its gradient is too.
        alpha_safe = torch.where(torch.isfinite(alpha), alpha,
                                 torch.ones_like(alpha))
        beta_safe = torch.where(inside, torch.ones_like(beta), beta)[:, None]
        x_0 = torch.where(inside[:, None], x,
                          (alpha_safe * x + (beta_safe - alpha_safe) * mu)
                          / beta_safe)
        ff_0 = self._eval_raw(coefs, x_0)
        ff_out = (beta_safe * ff_0
                  - (beta_safe - alpha_safe) * f_mu) / alpha_safe
        return torch.where(inside[:, None], ff_0, ff_out)

    # ------------- fitting -------------

    def fit(self, x, y, logp=None, w=None):
        """Least-squares fit of all configs (``poly.py:345-405``): the
        outputs that share a recipe row are solved in one multi-RHS
        ``torch.linalg.lstsq`` (SVD-based, float64, on the host)."""
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        if not (x.ndim == 2 and x.shape[-1] == self._input_size):
            raise ValueError(f'x should be (n_points, {self._input_size}), '
                             f'got {x.shape}.')
        if not (y.ndim == 2 and y.shape[-1] == self._output_size):
            raise ValueError(f'y should be (n_points, {self._output_size}), '
                             f'got {y.shape}.')
        if x.shape[0] != y.shape[0]:
            raise ValueError('x and y have different # of points.')
        if x.shape[0] < self.n_param:
            raise ValueError(f'I need at least {self.n_param} points, but you '
                             f'only gave me {x.shape[0]}.')
        if w is not None:
            w = np.atleast_1d(w)
            if not (w.ndim == 1 and w.shape[0] == x.shape[0]):
                raise ValueError('invalid shape for w.')

        xd = torch.as_tensor(x)
        # group output dims by identical recipe rows -> shared design matrix
        groups = {}
        for ii, r in enumerate(self._recipe):
            groups.setdefault(tuple(r), []).append(ii)

        for row, out_idx in groups.items():
            conf_ids = [j for j in row if j >= 0]
            blocks = [self._configs[j]._phi(
                xd[:, torch.as_tensor(self._configs[j]._input_mask)])
                for j in conf_ids]
            widths = [b.shape[1] for b in blocks]
            A = torch.cat(blocks, dim=1)
            B = torch.as_tensor(y[:, out_idx])
            if w is not None:
                wj = torch.as_tensor(np.asarray(w, np.float64))[:, None]
                A = A * wj
                B = B * wj
            sol = torch.linalg.lstsq(A, B, driver='gelsd').solution.numpy()
            kk = np.cumsum([0] + widths)
            for bi, j in enumerate(conf_ids):
                conf = self._configs[j]
                block = sol[kk[bi]:kk[bi + 1]]
                for ci, ii in enumerate(out_idx):
                    qq = int(np.argwhere(conf._output_mask == ii)[0, 0])
                    conf._set(block[:, ci], qq)

        if self._use_bound and not self._all_linear:
            self._set_bound(x, logp)

    @property
    def n_param(self):
        return int(np.sum([conf.n_features for conf in self._configs]))

    @property
    def _all_linear(self):
        return all(conf.order == 'linear' for conf in self._configs)
