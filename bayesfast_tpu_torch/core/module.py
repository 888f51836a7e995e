"""Module graph nodes.

Counterpart of ``bayesfast_tpu/core/module.py``. A ``Module`` wraps a
callable as a named-variable graph node with input/output variable names,
optional concat/split reshaping (``input_shapes``/``output_shapes``) and
affine input rescaling (``input_scales``). The port evaluates a whole batch
of points at once:

* every variable is a tensor ``(N, size)``, one row per point, in the dtype
  and on the device of the pipeline's input;
* a traceable module's callable takes torch tensors batched over a leading
  axis, one per input variable, and returns one tensor per output variable,
  ``(N, size)`` or ``(N,)``; Jacobians and gradients come from autograd;
* a non-traceable (external) module's callable takes the numpy arrays of
  ONE point and returns numpy; ``_map_external`` fans the rows out over the
  host pool of ``utils.parallel`` (``module.py:132-200``). Its outputs are
  not differentiable, which the surrogate workflow never needs (fits use
  values only, sampling differentiates the surrogate).

Surrogate coefficients and bound centres are read from the module at each
evaluation (``dynamic_params()``), so a refit is seen by the next call.
"""

from collections import namedtuple
import functools
import warnings

import numpy as np
import torch

from ..config import get_device, get_dtype
from ..utils import all_isinstance
from ..utils.collections import PropertyList

__all__ = ['ModuleBase', 'Module', 'Surrogate', 'SurrogateScope']

SurrogateScope = namedtuple('SurrogateScope', ['i_step', 'n_step'])


def _external_row_job(fun, fun_args, fun_kwargs, np_args):
    """One external evaluation for the host pool: top-level so process pools
    can pickle it, numpy-only so workers never touch torch or CUDA."""
    out = fun(*np_args, *fun_args, **fun_kwargs)
    if not isinstance(out, (list, tuple)):
        out = [out]
    return np.concatenate([np.atleast_1d(np.asarray(o, np.float64))
                           for o in out])


def _as_rows(a, n):
    """A module output as an (n, k) tensor (a (n,) output is one column)."""
    a = torch.as_tensor(a)
    if a.dim() == 0:
        a = a.expand(n)
    return a.reshape(n, -1)


class ModuleBase:
    """Base class: subclasses define ``_fun`` (batched torch); see ``Module``
    for the wrapper that takes user callables."""

    def __init__(self, input_vars='__var__', output_vars='__var__',
                 delete_vars=(), input_shapes=None, output_shapes=None,
                 input_scales=None, label=None, fun_args=(), fun_kwargs=None,
                 jac_args=(), jac_kwargs=None, fun_and_jac_args=(),
                 fun_and_jac_kwargs=None, concat_input=None, traceable=True):
        self._traceable = bool(traceable)
        self.input_vars = input_vars
        self.output_vars = output_vars
        self.delete_vars = delete_vars
        self.input_shapes = input_shapes
        self.output_shapes = output_shapes
        self.input_scales = input_scales
        self.label = label
        self.fun_args = fun_args
        self.fun_kwargs = fun_kwargs
        self.jac_args = jac_args
        self.jac_kwargs = jac_kwargs
        self.fun_and_jac_args = fun_and_jac_args
        self.fun_and_jac_kwargs = fun_and_jac_kwargs
        self.reset_counter()

    # ------------- dynamic parameters -------------

    def dynamic_params(self):
        """Snapshot of the fit-time-mutable arrays (empty for plain
        modules)."""
        return ()

    # ------------- batched evaluation -------------

    def _prepare_inputs(self, args):
        """Concat/rescale/split the (N, d_i) input variables
        (``module.py:83-101``)."""
        shapes = self._input_shapes
        cum = self._input_cum
        if shapes is None:
            if self._input_scales is None:
                return args
            sizes = [int(a.shape[-1]) for a in args]
            cum = np.cumsum([0] + sizes)
            shapes = np.asarray(sizes)
        cargs = torch.cat(args, dim=-1)
        if self._input_scales is not None:
            lo = torch.as_tensor(self._input_scales[:, 0], dtype=cargs.dtype,
                                 device=cargs.device)
            diff = torch.as_tensor(self._input_scales_diff,
                                   dtype=cargs.dtype, device=cargs.device)
            cargs = (cargs - lo) / diff
        if shapes.size > 1:
            return [cargs[:, cum[i]:cum[i + 1]] for i in range(shapes.size)]
        return [cargs]

    def _prepare_outputs(self, out, n):
        """Normalize the callable's output to one (N, k) tensor per output
        variable."""
        if not isinstance(out, (list, tuple)):
            out = [out]
        out = [_as_rows(o, n) for o in out]
        shapes = self._output_shapes
        cum = self._output_cum
        if shapes is None:
            return out
        cargs = torch.cat(out, dim=-1)
        if shapes.size > 1:
            return [cargs[:, cum[i]:cum[i + 1]] for i in range(shapes.size)]
        return [cargs]

    @property
    def traceable(self):
        return getattr(self, '_traceable', True)

    def _call_traced(self, args, params=None):
        """Batched evaluation: list of (N, d_i) inputs -> list of (N, k)
        outputs. ``params`` is a ``dynamic_params()`` snapshot (None: the
        module's current state)."""
        n = int(args[0].shape[0])
        if not self.traceable:
            from ..utils.parallel import get_backend
            return self._map_external(get_backend(), args, n)
        args = self._prepare_inputs(args)
        return self._prepare_outputs(self._fun_traced(params, *args), n)

    def _fun_traced(self, ctx, *args):
        """Default: delegate to ``self._fun`` ignoring the params context."""
        return self._fun(*args, *self._fun_args, **self._fun_kwargs)

    def _map_external(self, backend, batched_inputs, n_rows):
        """Batched external dispatch over a host pool
        (``module.py:169-197``): every row's inputs are prepared here, and
        ONLY the raw user callable plus numpy arrays go to the backend, so
        a process pool never imports or touches torch in its workers."""
        if self._output_shapes is None:
            raise ValueError('non-traceable modules need output_shapes to '
                             'declare their output size.')
        like = batched_inputs[0]
        with torch.no_grad():
            prepped = [p.detach().cpu().numpy()
                       for p in self._prepare_inputs(list(batched_inputs))]
        rows = [tuple(p[i] for p in prepped) for i in range(n_rows)]
        outs = backend.map(_external_row_job,
                           [self._fun] * n_rows, [self._fun_args] * n_rows,
                           [self._fun_kwargs] * n_rows, rows)
        cat = torch.as_tensor(np.stack([np.asarray(o) for o in outs]),
                              dtype=like.dtype, device=like.device)
        shapes = self._output_shapes
        cum = self._output_cum
        if shapes.size > 1:
            return [cat[:, cum[i]:cum[i + 1]] for i in range(shapes.size)]
        return [cat]

    # ------------- host-facing wrappers (one point, numpy) -------------

    @staticmethod
    def _point_tensors(args):
        return [torch.as_tensor(np.atleast_1d(np.asarray(a)),
                                dtype=get_dtype(), device=get_device())[None]
                for a in args]

    @property
    def fun(self):
        self._ncall_fun += 1
        return self._fun_wrapped

    @fun.setter
    def fun(self, function):
        if callable(function) or function is None:
            self._fun = function
        else:
            raise ValueError('fun should be callable, or None if you want to '
                             'reset it.')

    def _fun_wrapped(self, *args):
        with torch.no_grad():
            out = self._call_traced(self._point_tensors(args))
        return [o[0].cpu().numpy() for o in out]

    __call__ = _fun_wrapped

    @property
    def has_fun(self):
        return getattr(self, '_fun', None) is not None

    @property
    def jac(self):
        self._ncall_jac += 1
        return self._jac_wrapped

    @jac.setter
    def jac(self, jacobian):
        if callable(jacobian) or jacobian is None:
            self._jac = jacobian
        else:
            raise ValueError('jac should be callable, or None if you want to '
                             'reset it.')

    def _jac_wrapped(self, *args):
        """Jacobians of each output var w.r.t. the concatenated raw inputs,
        by autograd through the whole evaluation (rescaling included)."""
        parts = self._point_tensors(args)
        sizes = [int(p.shape[-1]) for p in parts]
        cum = np.cumsum([0] + sizes)
        flat = torch.cat(parts, dim=-1)[0]

        def f(x):
            ins = [x[None, cum[i]:cum[i + 1]] for i in range(len(sizes))]
            return tuple(o[0] for o in self._call_traced(ins))

        out = torch.autograd.functional.jacobian(f, flat)
        return [j.cpu().numpy() for j in out]

    @property
    def has_jac(self):
        return getattr(self, '_jac', None) is not None

    @property
    def fun_and_jac(self):
        self._ncall_fun_and_jac += 1
        return lambda *args: (self._fun_wrapped(*args),
                              self._jac_wrapped(*args))

    @fun_and_jac.setter
    def fun_and_jac(self, fun_jac):
        if callable(fun_jac) or fun_jac is None:
            self._fun_and_jac = fun_jac
        else:
            raise ValueError('fun_and_jac should be callable, or None if you '
                             'want to reset it.')

    @property
    def has_fun_and_jac(self):
        return getattr(self, '_fun_and_jac', None) is not None

    # ------------- call counters -------------

    @property
    def ncall_fun(self):
        return self._ncall_fun

    @property
    def ncall_jac(self):
        return self._ncall_jac

    @property
    def ncall_fun_and_jac(self):
        return self._ncall_fun_and_jac

    def reset_counter(self):
        self._ncall_fun = 0
        self._ncall_jac = 0
        self._ncall_fun_and_jac = 0

    # ------------- var-name plumbing (``module.py:302-499``) -------------

    @staticmethod
    def _var_check(names, tag, handle_repeat='remove', min_length=1,
                   max_length=np.inf):
        if isinstance(names, str):
            names = [names]
        else:
            names = list(names)
            if not all_isinstance(names, str):
                raise ValueError(f'{tag}_vars should be a str or an '
                                 'array_like of str.')
            if len(names) != len(set(names)):
                if handle_repeat == 'remove':
                    names = list(dict.fromkeys(names))
                    warnings.warn('removing repeated elements found in '
                                  f'{tag}_vars', RuntimeWarning)
                elif handle_repeat == 'ignore':
                    pass
                elif handle_repeat == 'warn':
                    warnings.warn(f'repeated elements found in {tag}_vars',
                                  RuntimeWarning)
                elif handle_repeat == 'raise':
                    raise ValueError(f'some elements in {tag}_vars are not '
                                     'unique.')
        if len(names) < min_length:
            raise ValueError('the length of this var list is smaller than '
                             f'min_length={min_length}.')
        if len(names) > max_length:
            raise ValueError('the length of this var list is larger than '
                             f'max_length={max_length}.')
        return names

    @staticmethod
    def _checker(tag, handle_repeat, min_length, max_length):
        """The check of a var-name list, picklable (a checkpoint pickles
        the modules)."""
        return functools.partial(ModuleBase._var_check, tag=tag,
                                 handle_repeat=handle_repeat,
                                 min_length=min_length,
                                 max_length=max_length)

    _input_min_length = 1
    _input_max_length = np.inf
    _output_min_length = 1
    _output_max_length = np.inf
    _delete_min_length = 0
    _delete_max_length = np.inf

    @property
    def input_vars(self):
        return self._input_vars

    @input_vars.setter
    def input_vars(self, names):
        self._input_vars = PropertyList(names, self._checker(
            'input', 'ignore', self._input_min_length,
            self._input_max_length))

    @property
    def output_vars(self):
        return self._output_vars

    @output_vars.setter
    def output_vars(self, names):
        self._output_vars = PropertyList(names, self._checker(
            'output', 'raise', self._output_min_length,
            self._output_max_length))

    @property
    def delete_vars(self):
        return self._delete_vars

    @delete_vars.setter
    def delete_vars(self, names):
        self._delete_vars = PropertyList(names, self._checker(
            'delete', 'remove', self._delete_min_length,
            self._delete_max_length))

    def _shape_check(self, shapes, tag):
        shapes = np.atleast_1d(shapes).astype(int)
        if not (shapes.ndim == 1 and shapes.size > 0):
            raise ValueError(f'invalid value for {tag}_shapes.')
        if shapes.size > 1 and not np.all(shapes > 0):
            raise ValueError(f'invalid value for {tag}_shapes.')
        cum = np.cumsum(np.insert(shapes, 0, 0))
        if tag == 'input':
            self._input_cum = cum
        else:
            self._output_cum = cum
        return shapes

    @property
    def input_shapes(self):
        return self._input_shapes

    @input_shapes.setter
    def input_shapes(self, shapes):
        if shapes is None:
            self._input_shapes = None
            self._input_cum = None
        else:
            self._input_shapes = self._shape_check(shapes, 'input')

    @property
    def output_shapes(self):
        return self._output_shapes

    @output_shapes.setter
    def output_shapes(self, shapes):
        if shapes is None:
            self._output_shapes = None
            self._output_cum = None
        else:
            self._output_shapes = self._shape_check(shapes, 'output')

    @property
    def input_scales(self):
        return self._input_scales

    @input_scales.setter
    def input_scales(self, scales):
        if scales is None:
            self._input_scales = None
            self._input_scales_diff = 1.
        else:
            scales = np.ascontiguousarray(scales, dtype=np.float64)
            if scales.ndim == 1:
                scales = np.stack([np.zeros_like(scales), scales], axis=-1)
            if not (scales.ndim == 2 and scales.shape[-1] == 2):
                raise ValueError('invalid value for input_scales.')
            self._input_scales = scales
            self._input_scales_diff = scales[:, 1] - scales[:, 0]

    @property
    def label(self):
        return self._label

    @label.setter
    def label(self, tag):
        if isinstance(tag, str) or tag is None:
            self._label = tag
        else:
            raise ValueError('label should be a str or None.')

    @staticmethod
    def _args_setter(args, tag):
        if args is None:
            return ()
        return tuple(args)

    @staticmethod
    def _kwargs_setter(kwargs, tag):
        if kwargs is None:
            return {}
        return dict(kwargs)

    @property
    def fun_args(self):
        return self._fun_args

    @fun_args.setter
    def fun_args(self, args):
        self._fun_args = self._args_setter(args, 'fun')

    @property
    def fun_kwargs(self):
        return self._fun_kwargs

    @fun_kwargs.setter
    def fun_kwargs(self, kwargs):
        self._fun_kwargs = self._kwargs_setter(kwargs, 'fun')

    @property
    def jac_args(self):
        return self._jac_args

    @jac_args.setter
    def jac_args(self, args):
        self._jac_args = self._args_setter(args, 'jac')

    @property
    def jac_kwargs(self):
        return self._jac_kwargs

    @jac_kwargs.setter
    def jac_kwargs(self, kwargs):
        self._jac_kwargs = self._kwargs_setter(kwargs, 'jac')

    @property
    def fun_and_jac_args(self):
        return self._fun_and_jac_args

    @fun_and_jac_args.setter
    def fun_and_jac_args(self, args):
        self._fun_and_jac_args = self._args_setter(args, 'fun_and_jac')

    @property
    def fun_and_jac_kwargs(self):
        return self._fun_and_jac_kwargs

    @fun_and_jac_kwargs.setter
    def fun_and_jac_kwargs(self, kwargs):
        self._fun_and_jac_kwargs = self._kwargs_setter(kwargs, 'fun_and_jac')

    def print_summary(self):
        raise NotImplementedError


class Module(ModuleBase):
    """Wrapper for user-defined callables (``module.py:505-531``): batched
    torch functions when ``traceable``, one-point numpy functions when
    not."""

    def __init__(self, fun=None, jac=None, fun_and_jac=None, **kwargs):
        self.fun = fun
        self.jac = jac
        self.fun_and_jac = fun_and_jac
        super().__init__(**kwargs)

    def _fun_traced(self, ctx, *args):
        if getattr(self, '_fun', None) is not None:
            return self._fun(*args, *self._fun_args, **self._fun_kwargs)
        if getattr(self, '_fun_and_jac', None) is not None:
            return self._fun_and_jac(*args, *self._fun_and_jac_args,
                                     **self._fun_and_jac_kwargs)[0]
        raise RuntimeError('No valid definition of fun is found.')

    def _jac_wrapped(self, *args):
        if getattr(self, '_jac', None) is not None:
            args_p = [a[0] for a in
                      self._prepare_inputs(self._point_tensors(args))]
            jac_out = self._jac(*args_p, *self._jac_args, **self._jac_kwargs)
            if not isinstance(jac_out, (list, tuple)):
                jac_out = [jac_out]
            jac_out = [np.atleast_2d(np.asarray(torch.as_tensor(j).cpu()))
                       for j in jac_out]
            return [j / self._input_scales_diff for j in jac_out]
        return super()._jac_wrapped(*args)


class Surrogate(ModuleBase):
    """Base class for surrogate modules (``module.py:534-611``)."""

    def __init__(self, input_size=None, output_size=None, scope=(0, 1),
                 fit_options=None, **kwargs):
        self._initialized = False
        if 'input_shapes' not in kwargs:
            kwargs['input_shapes'] = -1
        super().__init__(**kwargs)
        if input_size is None:
            if self.input_shapes is None or self.input_shapes.size <= 1:
                raise ValueError('failed to infer input_size from '
                                 'input_shapes.')
            input_size = int(np.sum(self.input_shapes))
        if output_size is None:
            if self.output_shapes is None or self.output_shapes.size <= 1:
                raise ValueError('failed to infer output_size from '
                                 'output_shapes.')
            output_size = int(np.sum(self.output_shapes))
        self.input_size = input_size
        self.output_size = output_size
        self.scope = scope
        self.fit_options = fit_options
        self._initialized = True

    @property
    def scope(self):
        return self._scope

    @scope.setter
    def scope(self, s):
        i_step, n_step = s
        if n_step <= 0:
            raise ValueError('invalid value for scope.')
        self._scope = SurrogateScope(int(i_step), int(n_step))

    @property
    def fit_options(self):
        return self._fit_options

    @fit_options.setter
    def fit_options(self, options):
        self._fit_options = {} if options is None else dict(options)

    @property
    def input_size(self):
        return self._input_size

    @input_size.setter
    def input_size(self, size):
        if self._initialized:
            raise RuntimeError('input_size cannot be modified after '
                               'initialization.')
        size = int(size)
        if size <= 0:
            raise ValueError('input_size should be a positive int.')
        self._input_size = size

    @property
    def output_size(self):
        return self._output_size

    @output_size.setter
    def output_size(self, size):
        if self._initialized:
            raise RuntimeError('output_size cannot be modified after '
                               'initialization.')
        size = int(size)
        if size <= 0:
            raise ValueError('output_size should be a positive int.')
        self._output_size = size

    def fit(self, *args, **kwargs):
        raise NotImplementedError('Abstract Method.')

    @property
    def n_param(self):
        raise NotImplementedError('Abstract Property.')
