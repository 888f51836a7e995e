"""Module-graph pipelines and graph densities.

Counterpart of ``bayesfast_tpu/core/pipeline.py``. A ``Pipeline`` walks its
module list over a whole batch of points at once: every variable is an
(N, size) tensor, traceable modules run as batched torch operations and
external ones fan their rows out over the host pool (``_map_external``),
so the JAX package's staged host/device split (``pipeline.py:265-303``)
becomes one loop. Surrogate substitution (``use_surrogate``) picks the
plan; gradients come from autograd through the constraint transform, the
plan and the decay penalty.

A ``Density`` describes its active plan to the CUDA NUTS kernels
(``kernel_spec``) two ways. A ``PolyModel`` surrogate followed by a
``Gaussian`` likelihood is compiled in (``ops/densities.py``,
``PolyGaussian``). Any other plan of traceable modules is traced once, as
the JAX package's kernels trace ``Density.device_logp_and_grad``
(``nuts_pallas.py:576-607``): ``_logp_traced`` on one point, in the
original space, under ``make_fx`` (``ops/trace.py``), with the flattened
``current_params()`` as the program's runtime parameters, so a refit
packs new parameters into the same program and the same generated kernels
(``ops/codegen.py``). A plan that does not trace samples on the tree loop.
"""

from collections import OrderedDict

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..config import get_device, get_dtype
from ..ops import constraint as _con
from ..samplers.nuts_cuda import _MAX_D
from ..utils import all_isinstance
from ..utils.collections import VariableDict, PropertyList
from .density import _PipelineBase, _DensityBase
from .module import ModuleBase, Surrogate

__all__ = ['Pipeline', 'Density']


class Pipeline(_PipelineBase):
    """Composite function over named variables (``pipeline.py:33-365``)."""

    def __init__(self, module_list=(), surrogate_list=(),
                 input_vars='__var__', input_shapes=None, input_scales=None,
                 hard_bounds=False, copy_input=False, module_start=None,
                 module_stop=None, original_space=True, use_surrogate=False):
        self.module_list = module_list
        self.surrogate_list = surrogate_list
        self.input_vars = input_vars
        self.input_shapes = input_shapes
        self.input_scales = input_scales
        self.hard_bounds = hard_bounds
        self.module_start = module_start
        self.module_stop = module_stop
        self.original_space = original_space
        self.use_surrogate = use_surrogate

    # ------------- list plumbing -------------

    @property
    def module_list(self):
        return self._module_list

    @module_list.setter
    def module_list(self, ml):
        if isinstance(ml, ModuleBase):
            ml = [ml]
        if not hasattr(ml, '__iter__'):
            raise ValueError('invalid value for module_list.')
        self._module_list = PropertyList(ml, self._ml_check)

    @staticmethod
    def _ml_check(ml):
        for i, m in enumerate(ml):
            if not isinstance(m, ModuleBase):
                raise ValueError(f'element #{i} of module_list is not a '
                                 'subclass object of ModuleBase.')
        return ml

    @property
    def surrogate_list(self):
        return self._surrogate_list

    @surrogate_list.setter
    def surrogate_list(self, sl):
        if isinstance(sl, Surrogate):
            sl = [sl]
        if not hasattr(sl, '__iter__'):
            raise ValueError('surrogate_list should be a Surrogate, or '
                             'consist of Surrogate(s).')
        self._surrogate_list = PropertyList(sl, self._sl_check)

    def _sl_check(self, sl):
        for i, s in enumerate(sl):
            if not isinstance(s, Surrogate):
                raise ValueError(f'element #{i} of surrogate_list is not a '
                                 'Surrogate')
        self._build_surrogate_recipe(sl)
        return sl

    def _build_surrogate_recipe(self, sl):
        """Sorted, overlap-checked (index, i_step, n_step) table
        (``pipeline.py:94-108``)."""
        ns = len(sl)
        if ns > 0:
            recipe = np.array([[i, *s._scope] for i, s in enumerate(sl)])
            order = np.argsort(recipe[:, 1] % max(self.n_module, 1))
            recipe = recipe[order].astype(int)
            for i in range(ns - 1):
                if np.sum(recipe[i, 1:]) > recipe[i + 1, 1]:
                    raise ValueError(f'the #{i} surrogate model overlaps with '
                                     'the next one.')
            self._surrogate_recipe = recipe
        else:
            self._surrogate_recipe = np.empty((0, 3), dtype=int)

    @property
    def n_module(self):
        return len(self._module_list)

    @property
    def n_surrogate(self):
        return len(self._surrogate_list)

    @property
    def has_surrogate(self):
        return self.n_surrogate > 0

    @property
    def module_start(self):
        return self._module_start

    @module_start.setter
    def module_start(self, start):
        self._module_start = None if start is None else int(start)

    @property
    def module_stop(self):
        return self._module_stop

    @module_stop.setter
    def module_stop(self, stop):
        self._module_stop = None if stop is None else int(stop)

    @property
    def use_surrogate(self):
        return self._use_surrogate

    @use_surrogate.setter
    def use_surrogate(self, us):
        self._use_surrogate = bool(us)

    @property
    def input_vars(self):
        return self._input_vars

    @input_vars.setter
    def input_vars(self, names):
        self._input_vars = PropertyList(
            names, ModuleBase._checker('input', 'raise', 1, np.inf))

    @property
    def input_shapes(self):
        return self._input_shapes

    @input_shapes.setter
    def input_shapes(self, shapes):
        if shapes is None:
            self._input_shapes = None
            self._input_cum = None
        else:
            shapes = np.atleast_1d(shapes).astype(int)
            if not (shapes.size > 0 and shapes.ndim == 1 and
                    np.all(shapes > 0)):
                raise ValueError('input_shapes should be a 1-d array_like of '
                                 'positive int(s), or None.')
            self._input_shapes = shapes
            self._input_cum = np.cumsum(np.insert(shapes, 0, 0))

    @property
    def input_size(self):
        return None if self._input_shapes is None else int(
            np.sum(self._input_shapes))

    def _check_os_us(self, original_space, use_surrogate):
        original_space = (self.original_space if original_space is None
                          else bool(original_space))
        use_surrogate = (self.use_surrogate if use_surrogate is None
                         else bool(use_surrogate))
        return original_space, use_surrogate

    # ------------- evaluation plan -------------

    def _get_start_stop(self):
        start = 0 if self._module_start is None else (
            self._module_start % self.n_module)
        stop = (self.n_module - 1 if self._module_stop is None else
                self._module_stop % self.n_module)
        if start > stop:
            raise ValueError('start should be no larger than stop.')
        return start, stop

    def _plan(self, use_surrogate):
        """Execution plan: a list of ('module' | 'surrogate', index) with
        surrogate substitution applied (``pipeline.py:190-214``)."""
        start, stop = self._get_start_stop()
        plan = []
        si = 0
        us = use_surrogate and self.has_surrogate
        if us:
            si = int(np.searchsorted(self._surrogate_recipe[:, 1], start))
            if si == self.n_surrogate:
                us = False
        i = start
        while i <= stop:
            if us and i == self._surrogate_recipe[si, 1]:
                idx = self._surrogate_recipe[si, 0]
                plan.append(('surrogate', idx))
                i += int(self._surrogate_recipe[si, 2])
                if si == self.n_surrogate - 1:
                    us = False
                else:
                    si += 1
            else:
                plan.append(('module', i))
                i += 1
        return plan

    def _module_by_ref(self, kind, idx):
        return (self._surrogate_list[idx] if kind == 'surrogate'
                else self._module_list[idx])

    def current_params(self):
        """Snapshot of every module's and surrogate's dynamic parameters."""
        return {
            'modules': tuple(m.dynamic_params() for m in self._module_list),
            'surrogates': tuple(s.dynamic_params()
                                for s in self._surrogate_list),
        }

    def _seed_vars(self, x):
        d = OrderedDict()
        if self._input_cum is None:
            d[self._input_vars[0]] = x
        else:
            for i, n in enumerate(self._input_vars):
                d[n] = x[:, self._input_cum[i]:self._input_cum[i + 1]]
        return d

    def _eval_vars(self, x, params, original_space, use_surrogate):
        """Batched evaluation of x (N, D) to a dict of (N, size) tensors."""
        if not original_space:
            x = _con.to_original_with_logdet(x, self._input_scales,
                                             self._hard_bounds)[0]
        d = self._seed_vars(x)
        for kind, idx in self._plan(use_surrogate):
            module = self._module_by_ref(kind, idx)
            p = params[kind + 's'][idx] if params is not None else None
            inputs = [d[n] for n in module.input_vars]
            outputs = module._call_traced(inputs, p)
            for n, o in zip(module.output_vars, outputs):
                d[n] = o
            for n in module._delete_vars:
                del d[n]
        return d

    def _has_external(self, use_surrogate):
        """True if the active plan contains non-traceable (host) modules."""
        return any(not self._module_by_ref(kind, idx).traceable
                   for kind, idx in self._plan(use_surrogate))

    # ------------- host-facing API (numpy in and out) -------------

    @staticmethod
    def _host_points(x):
        """numpy (..., D) -> ((N, D) tensor on the configured device in the
        configured dtype, the leading shape, or None for one point)."""
        x = np.asarray(x)
        lead = None if x.ndim == 1 else x.shape[:-1]
        flat = torch.as_tensor(x.reshape(-1, x.shape[-1]), dtype=get_dtype(),
                               device=get_device())
        return flat, lead

    @staticmethod
    def _var_dicts(vals, jacs, lead):
        n = next(iter(vals.values())).shape[0]
        vds = np.empty(n, dtype=object)
        for i in range(n):
            vd = VariableDict()
            for k in vals:
                vd._fun[k] = vals[k][i]
                if jacs is not None:
                    vd._jac[k] = jacs[k][i]
            vds[i] = vd
        return vds[0] if lead is None else vds.reshape(lead)

    def fun(self, x, original_space=None, use_surrogate=None):
        """Evaluate the pipeline; returns VariableDict(s)
        (``pipeline.py:305-324``)."""
        original_space, use_surrogate = self._check_os_us(original_space,
                                                          use_surrogate)
        flat, lead = self._host_points(x)
        with torch.no_grad():
            out = self._eval_vars(flat, self.current_params(),
                                  original_space, use_surrogate)
        vals = {k: v.cpu().numpy() for k, v in out.items()}
        return self._var_dicts(vals, None, lead)

    __call__ = fun

    def fun_and_jac(self, x, original_space=None, use_surrogate=None):
        """Values and full input-Jacobians (``pipeline.py:328-363``); the
        rows are independent, so each Jacobian row is one backward pass of
        a column sum."""
        original_space, use_surrogate = self._check_os_us(original_space,
                                                          use_surrogate)
        flat, lead = self._host_points(x)
        with torch.enable_grad():
            xg = flat.detach().requires_grad_(True)
            out = self._eval_vars(xg, self.current_params(), original_space,
                                  use_surrogate)
            vals, jacs = {}, {}
            for k, v in out.items():
                vals[k] = v.detach().cpu().numpy()
                cols = []
                for j in range(v.shape[1]):
                    if v.requires_grad:
                        (g,) = torch.autograd.grad(v[:, j].sum(), xg,
                                                   retain_graph=True,
                                                   allow_unused=True)
                    else:
                        g = None
                    cols.append(torch.zeros_like(flat) if g is None else g)
                jacs[k] = torch.stack(cols, dim=1).cpu().numpy()
        return self._var_dicts(vals, jacs, lead)

    jac = fun_and_jac


class Density(Pipeline, _DensityBase):
    """Pipeline specialized for log-densities (``pipeline.py:368-571``)."""

    _trace = None  # (structure key, Program or TraceError), see _program

    def __init__(self, density_name='__var__', decay_options=None,
                 return_dict=False, **kwargs):
        self.density_name = density_name
        self.return_dict = return_dict
        super().__init__(**kwargs)
        if decay_options is None:
            decay_options = {}
        self._mu = None
        self._hess = None
        self._alpha_2_val = np.inf
        self.set_decay_options(**decay_options)

    @property
    def density_name(self):
        return self._density_name

    @density_name.setter
    def density_name(self, name):
        self._density_name = str(name)

    @property
    def return_dict(self):
        return self._return_dict

    @return_dict.setter
    def return_dict(self, rd):
        self._return_dict = bool(rd)

    # ------------- decay penalty (``pipeline.py:401-455``) -------------

    def set_decay_options(self, use_decay=False, alpha=None, alpha_p=150.,
                          gamma=0.1):
        self._use_decay = bool(use_decay)
        if alpha is None:
            self._alpha = None
        else:
            alpha = float(alpha)
            if alpha <= 0:
                raise ValueError('invalid value for alpha.')
            self._alpha = alpha
            self._alpha_2_val = alpha ** 2
        if alpha_p is None:
            if alpha is None:
                raise ValueError('alpha and alpha_p cannot both be None.')
            self._alpha_p = None
        else:
            alpha_p = float(alpha_p)
            if alpha_p <= 0:
                raise ValueError('invalid value for alpha_p.')
            self._alpha_p = alpha_p
        gamma = float(gamma)
        if gamma <= 0:
            raise ValueError('invalid value for gamma.')
        self._gamma = gamma

    def _set_decay(self, x):
        x = np.ascontiguousarray(x, dtype=np.float64)
        if x.ndim != 2:
            raise ValueError('invalid value for x.')
        self._mu = np.mean(x, axis=0)
        self._hess = np.linalg.inv(np.cov(x, rowvar=False))
        if self._alpha_p is not None:
            beta = np.einsum('ij,jk,ik->i', x - self._mu, self._hess,
                             x - self._mu) ** 0.5
            if self._alpha_p < 100:
                self._alpha = np.percentile(beta, self._alpha_p)
            else:
                self._alpha = np.max(beta) * self._alpha_p / 100
            self._alpha_2_val = self._alpha ** 2

    def _decay_params(self):
        """(mu, hess, alpha^2) of the decay penalty as numpy; zeros, the
        identity and the current alpha^2 (inf: no penalty) before a fit."""
        if self._mu is not None:
            dim = self._mu.shape[0]
        else:
            dim = self.input_size if self.input_size is not None else 1
        return (np.zeros(dim) if self._mu is None else np.array(self._mu),
                np.eye(dim) if self._hess is None else np.array(self._hess),
                float(self._alpha_2_val))

    def current_params(self):
        params = super().current_params()
        params['decay'] = self._decay_params()
        return params

    # ------------- batched logp -------------

    def _logp_traced(self, x, params, original_space, use_surrogate):
        """logp (N,) of x (N, D), in x's dtype on x's device."""
        if original_space:
            x_o, logdet = x, None
        else:
            x_o, logdet = _con.to_original_with_logdet(
                x, self._input_scales, self._hard_bounds)
        if params is None:
            params = self.current_params()
        d = self._eval_vars(x_o, params, True, use_surrogate)
        lp = d[self._density_name].reshape(x.shape[0], -1)[:, 0]
        if self._use_decay and use_surrogate:
            mu, hess, alpha_2 = (torch.as_tensor(a, dtype=x.dtype,
                                                 device=x.device)
                                 for a in params['decay'])
            delta = x_o - mu
            beta2 = torch.sum((delta @ hess) * delta, dim=-1)
            lp = lp - self._gamma * torch.clamp(beta2 - alpha_2, min=0.0)
        if logdet is not None:
            lp = lp + logdet
        return lp

    def _logp_and_grad_b(self, x, params, original_space, use_surrogate):
        if self._has_external(use_surrogate):
            raise RuntimeError(
                'the active plan has a non-traceable (external) module, '
                'which has no gradient: sample the surrogate '
                '(use_surrogate=True) instead.')
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            lp = self._logp_traced(x, params, original_space, use_surrogate)
            (g,) = torch.autograd.grad(lp.sum(), x)
        return lp.detach(), g

    def device_logp_and_grad(self, original_space=False, use_surrogate=None):
        """``fn(params, x (C, D)) -> (logp (C,), grad (C, D))`` for the
        sampler; ``params`` is a ``current_params()`` snapshot, or empty
        for the density's state at the call."""
        _, us = self._check_os_us(None, use_surrogate)

        def fn(params, x):
            return self._logp_and_grad_b(x, params or None, original_space,
                                         us)
        return fn

    def device_logp(self, original_space=False, use_surrogate=None):
        """Torch ``fn(x)`` of one point (D,) or a batch (N, D), with the
        current parameters bound, in x's dtype (for Laplace autograd)."""
        _, us = self._check_os_us(None, use_surrogate)
        params = self.current_params()

        def fn(x):
            x = torch.as_tensor(x)
            lp = self._logp_traced(x.reshape(-1, x.shape[-1]), params,
                                   original_space, us)
            return lp[0] if x.dim() == 1 else lp.reshape(x.shape[:-1])
        return fn

    # ------------- host API -------------

    def logp(self, x, original_space=None, use_surrogate=None,
             return_dict=None):
        original_space, us = self._check_os_us(original_space, use_surrogate)
        return_dict = self.return_dict if return_dict is None else return_dict
        flat, lead = self._host_points(x)
        with torch.no_grad():
            lp = self._logp_traced(flat, self.current_params(),
                                   original_space, us).cpu().numpy()
        lp = lp[0] if lead is None else lp.reshape(lead)
        if return_dict:
            return lp, self.fun(np.asarray(x), original_space, us)
        return lp

    __call__ = logp

    def grad(self, x, original_space=None, use_surrogate=None,
             return_dict=None):
        return self.logp_and_grad(x, original_space, use_surrogate,
                                  return_dict)[1]

    def logp_and_grad(self, x, original_space=None, use_surrogate=None,
                      return_dict=None):
        original_space, us = self._check_os_us(original_space, use_surrogate)
        return_dict = self.return_dict if return_dict is None else return_dict
        flat, lead = self._host_points(x)
        lp, g = self._logp_and_grad_b(flat, self.current_params(),
                                      original_space, us)
        lp, g = lp.cpu().numpy(), g.cpu().numpy()
        if lead is None:
            lp, g = lp[0], g[0]
        else:
            lp, g = lp.reshape(lead), g.reshape(np.shape(x))
        if return_dict:
            return lp, g, self.fun_and_jac(np.asarray(x), original_space, us)
        return lp, g

    # ------------- fitting (``pipeline.py:548-571``) -------------

    def fit(self, var_dicts):
        """Fit every surrogate module from collected training VariableDicts."""
        var_dicts = np.asarray(var_dicts).reshape(-1)
        if not all_isinstance(var_dicts, VariableDict):
            raise ValueError('var_dicts should consist of VariableDict(s).')
        x = self._get_var(var_dicts, self.input_vars)
        if self._use_decay:
            self._set_decay(x)
        logp = self._get_logp(var_dicts)
        for su in self._surrogate_list:
            x_s = self._get_var(var_dicts, su.input_vars)
            if su._input_scales is not None:
                x_s = (x_s - su._input_scales[:, 0]) / su._input_scales_diff
            y_s = self._get_var(var_dicts, su.output_vars)
            su.fit(x_s, y_s, logp, **su.fit_options)

    @classmethod
    def _get_var(cls, var_dicts, var_names):
        return np.array([np.concatenate([np.atleast_1d(vd._fun[vn])
                                         for vn in var_names])
                         for vd in var_dicts])

    def _get_logp(self, var_dicts):
        return self._get_var(var_dicts, [self.density_name])[..., 0]

    def __getstate__(self):
        # a checkpoint or a copy keeps the plan, not its trace: traced
        # again at first use
        state = dict(self.__dict__)
        state.pop('_trace', None)
        return state

    # ------------- the CUDA NUTS kernels: a compiled-in or traced plan ---

    def _kernel_parts(self):
        """``(PolyModel, Gaussian)`` when the active plan is exactly the
        surrogate the CUDA kernels compile in, else None: with
        ``use_surrogate`` on, one ``PolyModel`` (any mix of its orders,
        with or without its own ``input_scales``) from the density's input
        vars to one var, then one ``Gaussian`` (diagonal or full
        covariance, no ``input_scales``) from that var to
        ``density_name``, at D <= 256 (``nuts_cuda._MAX_D``)."""
        from ..modules import Gaussian, PolyModel
        if not self.use_surrogate:
            return None
        plan = self._plan(True)
        if [k for k, _ in plan] != ['surrogate', 'module']:
            return None
        su = self._surrogate_list[plan[0][1]]
        ga = self._module_list[plan[1][1]]
        D = self.input_size
        ok = (isinstance(su, PolyModel) and isinstance(ga, Gaussian)
              and D is not None and D <= _MAX_D and su.input_size == D
              and ga.input_scales is None
              and list(su.input_vars) == list(self.input_vars)
              and len(su.output_vars) == 1
              and list(ga.input_vars) == list(su.output_vars)
              and list(ga.output_vars) == [self.density_name]
              and ga.mean.shape[0] == su.output_size)
        return (su, ga) if ok else None

    def _param_leaves(self):
        """``current_params()`` flattened: (its leaves, numpy arrays and
        floats; the tree's structure)."""
        return pytree.tree_flatten(self.current_params())

    def _trace_structure(self):
        """A value equal between two calls exactly when ``_program`` would
        trace the same program: each module of the active plan by its
        ``_trace_key`` (everything but its dynamic parameters), the
        density's own settings and the run's dtype and device."""
        plan = self._plan(self.use_surrogate)
        mods = tuple((kind, int(idx), self._module_by_ref(kind, idx)
                      ._trace_key()) for kind, idx in plan)
        shapes = (None if self._input_shapes is None
                  else self._input_shapes.tobytes())
        return (mods, self.input_size, tuple(self.input_vars), shapes,
                self._density_name, self._use_decay,
                float(self._gamma).hex(), self.use_surrogate,
                str(get_dtype()), str(get_device()))

    def _program(self):
        """The active plan traced (``ops.trace.trace_density``):
        ``_logp_traced`` of one point in the original space, with the
        leaves of ``current_params()`` as the program's runtime parameters,
        in the configured dtype on the configured device; kept until the
        plan's structure (``_trace_structure``) or the parameters' tree
        changes. A ``TraceError`` when it does not trace, when the plan has
        an external module, or at D > 256 (``nuts_cuda._MAX_D``)."""
        from ..ops.trace import TraceError, trace_density
        D = self.input_size
        us = self.use_surrogate
        if D is None:
            return TraceError('input_size is not set: the plan is traced at '
                              'one point of that size')
        if D > _MAX_D:
            return TraceError(f'the CUDA NUTS kernels take a Density plan '
                              f'(the compiled-in PolyGaussian or a traced '
                              f'plan) at D <= {_MAX_D}, got {D}')
        if self._has_external(us):
            names = [self._module_by_ref(k, i).label or f'{k} #{i}'
                     for k, i in self._plan(us)
                     if not self._module_by_ref(k, i).traceable]
            return TraceError(f'the plan has an external (non-traceable) '
                              f'module, {names[0]}: it runs on the host')
        leaves, tree = self._param_leaves()
        key = (self._trace_structure(), str(tree),
               tuple(np.shape(v) for v in leaves))
        if self._trace is None or self._trace[0] != key:
            def logp(x, *params):
                p = pytree.tree_unflatten(list(params), tree)
                return self._logp_traced(x[None], p, True, us)[0]
            try:
                prog = trace_density(logp, D, get_dtype(), get_device(),
                                     self._leaf_tensors(leaves), batch=True)
            except TraceError as exc:
                prog = exc
            self._trace = (key, prog)
        return self._trace[1]

    @staticmethod
    def _leaf_tensors(leaves):
        return [torch.as_tensor(np.asarray(v, np.float64), dtype=get_dtype(),
                                device=get_device()) for v in leaves]

    @property
    def has_traced_spec(self):
        """Whether the kernel spec is the traced plan's (not the
        compiled-in ``PolyGaussian``)."""
        return (self._kernel_parts() is None
                and not isinstance(self._program(), Exception))

    @property
    def has_kernel_spec(self):
        """Whether the CUDA NUTS kernels can sample this density as it
        stands: a PolyModel surrogate then a Gaussian, compiled in (see
        ``_kernel_parts``), or any other plan that traces into the
        kernels' op set (``_program``), at D <= 256."""
        return self._kernel_parts() is not None or self.has_traced_spec

    def kernel_trace_error(self):
        """Why the plan does not trace (a string), or None; None for the
        compiled-in plan."""
        if self._kernel_parts() is not None:
            return None
        prog = self._program()
        return str(prog) if isinstance(prog, Exception) else None

    def _kernel_sources(self):
        """Everything ``kernel_spec`` is built from, as numpy arrays and
        floats."""
        parts = self._kernel_parts()
        if parts is None:
            raise NotImplementedError(
                'this density has no kernel_spec(): the CUDA NUTS kernels '
                'compile in a PolyModel surrogate followed by a Gaussian '
                f'likelihood only, at D <= {_MAX_D}.')
        su, ga = parts
        # the surrogate's own arrays, not copies: the spec (or its key) is
        # built from them at once
        configs = [(c.order, c.input_mask, c.output_mask, c._ensure_coef())
                   for c in su.configs]
        bound = (dict(mu=su._mu, hess=su._hess, alpha=float(su._alpha),
                      f_mu=su._f_mu) if su.bound_active else None)
        alpha_2 = float(self._alpha_2_val)
        decay = None
        if self._use_decay and np.isfinite(alpha_2):
            mu_d, hess_d, _ = self._decay_params()
            decay = dict(mu=mu_d, hess=hess_d, alpha_2=alpha_2,
                         gamma=self._gamma)
        norm_0, norm_1 = ga.norms()
        return dict(dim=self.input_size, configs=configs,
                    n_out=su.output_size, mean=ga.mean, var_inv=ga.var_inv,
                    prec=None if ga.var_inv is not None else ga.cov_inv,
                    norm=norm_0 + norm_1, bound=bound, decay=decay,
                    scales=su.input_scales)

    def kernel_spec_key(self):
        """A value equal between two calls exactly when ``kernel_spec()``
        would be: the bytes of every array and float it is built from, so
        a refit in place (new coefficients in the same arrays), a new
        bound or decay, or new scales (the density's or the surrogate's)
        all change it; for a traced plan, the plan's structure and the
        bytes of its parameters."""
        bounds = (None if self._input_scales is None
                  else self._input_scales.tobytes(),
                  np.asarray(self._hard_bounds).tobytes())
        if self._kernel_parts() is None:
            leaves, tree = self._param_leaves()
            return ('traced', self._trace_structure(), str(tree),
                    tuple(np.asarray(v, np.float64).tobytes()
                          for v in leaves)) + bounds
        src = self._kernel_sources()
        out = [src['dim'], src['n_out'], src['norm']]
        for order, im, om, a in src['configs']:
            out += [order, im.tobytes(), om.tobytes(), a.tobytes()]
        for k in ('mean', 'var_inv', 'prec', 'scales'):
            out.append(None if src[k] is None else src[k].tobytes())
        for k in ('bound', 'decay'):
            d = src[k]
            out.append(None if d is None else tuple(
                (n, np.asarray(v, np.float64).tobytes())
                for n, v in sorted(d.items())))
        out.append(None if self._input_scales is None
                   else self._input_scales.tobytes())
        out.append(np.asarray(self._hard_bounds).tobytes())
        return tuple(out)

    def kernel_spec(self):
        """The description of the density for the CUDA NUTS kernels: the
        compiled-in surrogate (``ops.densities.poly_gaussian_spec``), or
        the traced plan (density ``'traced'``: its ``program`` and the
        program's constants packed from the current parameters), plus the
        fused bound transform; raises ``NotImplementedError`` when
        ``has_kernel_spec`` is False."""
        from ..ops.densities import poly_gaussian_spec
        if self._kernel_parts() is not None:
            spec = poly_gaussian_spec(**self._kernel_sources())
        else:
            prog = self._program()
            if isinstance(prog, Exception):
                raise NotImplementedError(
                    f'this density has no kernel_spec(): the CUDA NUTS '
                    f'kernels take a PolyModel surrogate then a Gaussian '
                    f'compiled in, and any other plan that traces into their '
                    f'op set (ops/trace.py); this one does not: {prog}')
            leaves = self._leaf_tensors(self._param_leaves()[0])
            spec = dict(density='traced', dim=prog.D, program=prog,
                        params=[prog.pack(leaves=leaves)],
                        scalars=(0.0, 0.0))
        D = spec['dim']
        scales = self._input_scales
        if scales is None:
            scales = np.stack([np.zeros(D), np.ones(D)], axis=-1)
            bounds = False
        else:
            bounds = self._hard_bounds
        spec['transform'] = _con.fused_params(scales, bounds, torch.float64)
        return spec
