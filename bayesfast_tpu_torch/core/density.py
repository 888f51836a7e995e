"""Probability-density objects: constraint mixins and DensityLite.

Counterpart of ``bayesfast_tpu/core/density.py:34-344``, with its
signature (``logp``, ``grad``, ``logp_and_grad``, ``vectorized``,
``traceable``, ``logp_args``, ``logp_kwargs``). The logp is a torch
callable over a batch of points, ``logp(x (..., D)) -> (...)``, or with
``vectorized=False`` of one point, run under ``torch.func.vmap``; with
``traceable=False`` an external numpy function of one point, mapped over
the host pool. Gradients in the sampling (transformed) space are the
user's, with the transform's corrections, where ``grad`` or
``logp_and_grad`` is given; else they come from autograd over the whole
batch of ``logp(to_original(x)) + logdet``, with the fused transform's
rational backward (``ops.constraint.to_original_with_logdet``).

Densities from ``ops.densities`` also carry a ``kernel_spec()``, which the
CUDA NUTS kernels need: they evaluate a compiled-in density and its
analytic gradient. Any other torch logp that traces into the kernels' op
set (``ops/trace.py``) has a kernel spec too: its program, whose functor
``ops/codegen.py`` generates and ``_build.load_traced`` compiles at first
use; with a gradient of the user's, the program is the trace of the
user's pair, its gradient the user's. One that does not trace has none
(``kernel_trace_error`` says why), and samples on the tree loop.
"""

from functools import partial

import numpy as np
import torch

from ..config import get_device, get_dtype
from ..ops import constraint as _con
from ..utils.parallel import get_backend

__all__ = ['DensityLite']


class _PipelineBase:
    """Constraint-transform utilities (numpy host API + torch device API)."""

    @property
    def input_scales(self):
        return self._input_scales

    @input_scales.setter
    def input_scales(self, scales):
        self._input_scales = _con.normalize_scales(scales)

    @property
    def hard_bounds(self):
        return self._hard_bounds

    @hard_bounds.setter
    def hard_bounds(self, bounds):
        if isinstance(bounds, bool):
            self._hard_bounds = bounds
        else:
            self._hard_bounds = _con.normalize_bounds(
                bounds, np.atleast_1d(bounds).shape[0])

    @property
    def original_space(self):
        return self._original_space

    @original_space.setter
    def original_space(self, os):
        self._original_space = bool(os)

    # host transform API (numpy; any leading batch shape)
    def from_original(self, x):
        return np.asarray(_con.np_from_original(x, self._input_scales,
                                                self._hard_bounds))

    def from_original_grad(self, x):
        return np.asarray(_con.np_from_original_grad(x, self._input_scales,
                                                     self._hard_bounds))

    def from_original_grad2(self, x):
        return np.asarray(_con.np_from_original_grad2(
            x, self._input_scales, self._hard_bounds))

    def to_original(self, x):
        return np.asarray(_con.np_to_original(x, self._input_scales,
                                              self._hard_bounds))

    def to_original_grad(self, x):
        return np.asarray(_con.np_to_original_grad(x, self._input_scales,
                                                   self._hard_bounds))

    def to_original_grad2(self, x):
        return np.asarray(_con.np_to_original_grad2(x, self._input_scales,
                                                    self._hard_bounds))

    def _check_os(self, original_space):
        return (self.original_space if original_space is None
                else bool(original_space))


class _DensityBase:
    """Log-density transform corrections (host numpy)."""

    def _get_diff(self, x=None, x_trans=None):
        # log |dx / dx_trans|
        if x is not None:
            return -np.sum(np.log(np.abs(self.from_original_grad(x))),
                           axis=-1)
        elif x_trans is not None:
            return np.sum(np.log(np.abs(self.to_original_grad(x_trans))),
                          axis=-1)
        raise ValueError('x and x_trans cannot both be None.')

    def to_original_density(self, density, x_trans=None, x=None):
        diff = self._get_diff(x, x_trans)
        density = np.asarray(density)
        if density.size != diff.size:
            raise ValueError('the shape of density is inconsistent with the '
                             'shape of x_trans or x.')
        return density - diff

    def from_original_density(self, density, x=None, x_trans=None):
        diff = self._get_diff(x, x_trans)
        density = np.asarray(density)
        if density.size != diff.size:
            raise ValueError('the shape of density is inconsistent with the '
                             'shape of x or x_trans.')
        return density + diff


def _external_row(logp, args, kwargs, dtype, row):
    """An external logp at one point (a numpy row), as a number of
    ``dtype``: what the host pool maps (a module-level function, so that a
    process pool can pickle it with the user's callable)."""
    return np.asarray(logp(np.asarray(row), *args, **kwargs), dtype=dtype)


def _scalar(v):
    """A per-point logp as a 0-d tensor (a shape (1,) value too, as the
    JAX package's ``_as_scalar``)."""
    return v if v.dim() == 0 else v.reshape(())


class DensityLite(_PipelineBase, _DensityBase):
    """Wrap a torch logp callable, and optionally its gradient.

    The signature is the JAX package's (``bayesfast_tpu/core/density.py:
    164-167``) except for the default of ``vectorized``: the port's
    callers pass batched logps, so the batched form is the default.

    Parameters
    ----------
    logp : callable or None
        With ``vectorized=True`` (the default), ``logp(x, *logp_args,
        **logp_kwargs) -> (...)`` for a batch of points ``x`` of shape
        ``(..., D)``, written in torch; every host and device evaluation
        raises ``ValueError`` when it returns another shape than ``(...)``
        (a logp written for one point would sum the batch). With
        ``vectorized=False``, the JAX package's form: ``logp(x) -> scalar``
        of one point ``x`` (D,), run over a batch under
        ``torch.func.vmap``. An ``nn.Module`` from ``ops.densities`` gives
        the CUDA kernels its ``kernel_spec``; any other logp is traced into
        one when its ops are in the kernels' op set (``ops/trace.py``).
        With ``traceable=False``: a numpy function of one point, an
        external likelihood that runs on the host, its rows mapped over
        ``utils.parallel.get_backend()``.
    grad, logp_and_grad : callable or None
        The user's own gradient, in the form ``vectorized`` says: ``grad(x)
        -> (..., D)`` (or ``(D,)`` of one point), ``logp_and_grad(x) ->
        (logp, grad)``; torch, with no ``logp_args``. Every evaluation of
        the gradient is then the user's, in the transformed space with the
        transform's corrections (``g_o * tog + tog2 / tog``), and the CUDA
        NUTS kernels run the trace of the user's pair (no adjoint is
        derived); a pair that does not trace samples on the tree loop with
        the same functions.
    input_size : int or None
        Dimensionality; used to draw default starting points.
    input_scales, hard_bounds : see ``_PipelineBase``.
    vectorized : bool
        Whether ``logp``, ``grad`` and ``logp_and_grad`` take a batch
        (default True; the JAX package's default is False).
    original_space : bool
        Default interpretation of inputs.
    traceable : bool
        False for an external numpy logp (see ``logp``): it has no
        gradient of its own, so sampling it needs ``grad`` or
        ``logp_and_grad``, or a surrogate (a ``Density``).
    logp_args, logp_kwargs : tuple and dict
        Passed to ``logp`` on every call (host, plain and traced); the
        tensors among them become constants of the trace.
    """

    _trace = None  # (trace key, D, (Program or TraceError)), see _program

    def __init__(self, logp=None, grad=None, logp_and_grad=None,
                 input_size=None, input_scales=None, hard_bounds=False,
                 vectorized=True, original_space=True, traceable=True,
                 logp_args=(), logp_kwargs=None):
        if logp is None and logp_and_grad is None:
            raise ValueError('logp (or logp_and_grad) is required.')
        self._logp = logp
        self._grad = grad
        self._logp_and_grad = logp_and_grad
        self._traceable = bool(traceable)
        self._logp_args = tuple(logp_args)
        self._logp_kwargs = dict(logp_kwargs or {})
        self.input_size = input_size
        self.input_scales = input_scales
        self.hard_bounds = hard_bounds
        self.vectorized = vectorized
        self.original_space = original_space

    @property
    def has_logp(self):
        return self._logp is not None

    @property
    def has_grad(self):
        return self._grad is not None

    @property
    def has_logp_and_grad(self):
        return self._logp_and_grad is not None

    @property
    def vectorized(self):
        return self._vectorized

    @vectorized.setter
    def vectorized(self, vec):
        self._vectorized = bool(vec)

    @property
    def _user_grad(self):
        """Whether the gradient is the user's (``logp_and_grad``, or
        ``grad`` with ``logp``), as the JAX package's ``_logp_and_grad_1``
        takes it."""
        return self._logp_and_grad is not None or (
            self._grad is not None and self._logp is not None)

    def _no_gradient(self):
        """The error of a gradient asked of an external logp without a
        gradient of its own (the JAX package cannot differentiate its host
        callback either), else None."""
        if self._traceable or self._user_grad:
            return None
        return ValueError(
            'traceable=False: the logp is an external function evaluated '
            'on the host, and has no gradient; pair it with a surrogate (a '
            'Density with a surrogate_list, which the gradient samplers '
            'run), or give its gradient (grad= or logp_and_grad=).')

    # ------------- batched evaluation: x (..., D) -------------

    def _each(self, fn, x):
        """``fn`` of one point over the rows of ``x`` (..., D) under
        ``torch.func.vmap``; its outputs reshaped to the batch."""
        flat = x.reshape(-1, x.shape[-1])
        out = torch.func.vmap(fn)(flat)
        lead = tuple(x.shape[:-1])
        if isinstance(out, tuple):
            return tuple(o.reshape(lead + tuple(o.shape[1:])) for o in out)
        return out.reshape(lead + tuple(out.shape[1:]))

    def _check(self, lp, x, what='logp'):
        if tuple(lp.shape) != tuple(x.shape[:-1]):
            raise ValueError(
                f'{what} returned shape {tuple(lp.shape)} for a batch of '
                f'shape {tuple(x.shape)}: the port calls {what}(x) on a '
                f'batch (..., D) and takes one value a point, (...,) = '
                f'{tuple(x.shape[:-1])}; a logp written for one point (the '
                f'JAX package vmaps those) sums the batch instead: pass '
                f'vectorized=False for that form.')
        return lp

    def _external(self, x):
        """The external logp of every row of ``x``, one call a row over
        the host pool (``utils.parallel.get_backend().map``), as the JAX
        package's host callback maps them (``density.py:185-212``)."""
        if self._logp is None:
            raise ValueError('traceable=False needs logp: the external '
                             'function evaluated on the host.')
        xs = x.detach().cpu().numpy()
        one = partial(_external_row, self._logp, self._logp_args,
                      self._logp_kwargs, xs.dtype)
        vals = get_backend().map(one, list(xs.reshape(-1, xs.shape[-1])))
        lp = np.asarray(vals, dtype=xs.dtype).reshape(xs.shape[:-1])
        return torch.as_tensor(lp, device=x.device)

    def _logp_x(self, x):
        """The logp in the original space on the batch ``x`` (..., D):
        the external logp on the host pool, the user's batched logp (its
        shape checked), or the one-point logp under vmap."""
        if not self._traceable:
            return self._external(x)
        if self._logp is None:
            return self._user_lpg(x)[0]
        args, kwargs = self._logp_args, self._logp_kwargs
        if self._vectorized:
            return self._check(self._logp(x, *args, **kwargs), x)
        logp = self._logp
        return self._each(lambda p: _scalar(logp(p, *args, **kwargs)), x)

    def _user_lpg(self, x):
        """The user's (logp, grad) in the original space on the batch
        ``x`` (..., D): ``logp_and_grad``, or ``logp`` and ``grad``."""
        lpg, grad = self._logp_and_grad, self._grad
        if lpg is not None:
            if not self._vectorized:
                return self._each(
                    lambda p: (lambda r: (_scalar(r[0]), r[1]))(lpg(p)), x)
            lp, g = lpg(x)
            self._check(lp, x, 'logp_and_grad')
        else:
            lp = self._logp_x(x)
            g = grad(x) if self._vectorized else self._each(grad, x)
        if tuple(g.shape) != tuple(x.shape):
            raise ValueError(f'the gradient has shape {tuple(g.shape)} at '
                             f'points of shape {tuple(x.shape)}.')
        return lp, g

    def _logp_trans(self, x_t):
        """Batched logp in transformed space, with the log-Jacobian."""
        x_o, logdet = _con.to_original_with_logdet(
            x_t, self._input_scales, self._hard_bounds)
        return self._logp_x(x_o) + logdet

    def _logp_b(self, x, original_space):
        return self._logp_x(x) if original_space else self._logp_trans(x)

    def _logp_and_grad_b(self, x, original_space):
        """(logp, grad) on the batch ``x`` (..., D), branch by branch as the
        JAX package's ``_logp_and_grad_1`` (``density.py:218-250``): the
        user's pair in the original space; in the transformed space the
        user's pair at ``to_original(x)`` with the transform's corrections;
        autograd of the logp otherwise."""
        err = self._no_gradient()
        if err is not None:
            raise err
        if self._user_grad:
            if original_space:
                return self._user_lpg(x)
            sc, hb = self._input_scales, self._hard_bounds
            lp, g_o = self._user_lpg(_con.to_original(x, sc, hb))
            tog = _con.to_original_grad(x, sc, hb)
            tog2 = _con.to_original_grad2(x, sc, hb)
            lp = lp + torch.sum(torch.log(torch.abs(tog)), dim=-1)
            return lp, g_o * tog + tog2 / tog
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            lp = self._logp_b(x, original_space)
            (g,) = torch.autograd.grad(lp.sum(), x)
        return lp.detach(), g

    def current_params(self):
        """No runtime-mutable parameters for a plain DensityLite."""
        return ()

    # ``use_surrogate`` is accepted, and ignored, for the signature of
    # ``Density`` (a DensityLite has no surrogate), as in the JAX package
    def device_logp_and_grad(self, original_space=False, use_surrogate=None):
        """Return ``fn(params, x (C, D)) -> (logp (C,), grad (C, D))``:
        the user's gradient where there is one, else autograd of the logp.

        ``params`` is ignored; the signature matches the JAX package so the
        driver threads density parameters the same way. An external logp
        without a gradient raises ``ValueError`` at the call.
        """
        def fn(params, x):
            return self._logp_and_grad_b(x, original_space)
        return fn

    def device_logp(self, original_space=False, use_surrogate=None):
        """Torch ``fn(x) -> logp`` of a batch ``x`` (..., D), evaluated
        without autograd (the ensemble sampler's evaluation)."""
        def fn(x):
            with torch.no_grad():
                return self._logp_b(x, original_space)
        return fn

    def __getstate__(self):
        # a checkpoint keeps the logp, not its trace: traced again at first
        # use
        state = dict(self.__dict__)
        state.pop('_trace', None)
        return state

    @property
    def _compiled_in(self):
        """Whether the kernels run a compiled-in density (``ops.densities``)
        for this one: its logp is one, and nothing else is the user's (no
        gradient of theirs, no arguments, a traceable logp)."""
        return (hasattr(self._logp, 'kernel_spec') and self._traceable
                and not self._user_grad and not self._logp_args
                and not self._logp_kwargs)

    def _trace_fn(self):
        """(the function of one point x (D,) that the kernels run, whether
        it returns the user's pair (logp, grad)): ``logp_and_grad``, or
        ``logp`` and ``grad``, or the logp alone, whose gradient the
        tracer derives. ``TraceError`` for an external logp that the pair
        would call."""
        from ..ops.trace import TraceError
        lpg, grad, logp = self._logp_and_grad, self._grad, self._logp
        if lpg is not None:
            return (lambda x: tuple(lpg(x))), True
        if not self._traceable:
            raise TraceError(
                'traceable=False: the logp is an external function '
                'evaluated on the host, which the kernels cannot run')
        args, kwargs = self._logp_args, self._logp_kwargs
        if self._user_grad:
            return (lambda x: (logp(x, *args, **kwargs), grad(x))), True
        return (lambda x: logp(x, *args, **kwargs)), False

    def _trace_key(self):
        from ..ops.trace import trace_key
        return trace_key(self._logp, self._grad, self._logp_and_grad,
                         self._logp_args,
                         sorted(self._logp_kwargs.items()))

    def _program(self):
        """What the kernels run traced at ``input_size``
        (``ops.trace.trace_density``, in the configured dtype on the
        configured device): the logp with the tracer's adjoint, or the
        user's pair as it stands (``_trace_fn``); kept until the trace's
        key (``ops.trace.trace_key`` of the user's functions and
        arguments) changes. A ``TraceError`` when it does not trace, or
        when ``input_size`` is not set."""
        from ..ops.trace import TraceError, trace_density
        D = self._input_size
        if D is None:
            return TraceError('input_size is not set: the logp is traced '
                              'at one point of that size')
        key = self._trace_key()
        if self._trace is None or self._trace[:2] != (key, D):
            try:
                fn, pair = self._trace_fn()
                prog = trace_density(fn, D, get_dtype(), get_device(),
                                     with_grad=pair)
            except TraceError as exc:
                prog = exc
            self._trace = (key, D, prog)
        return self._trace[2]

    @property
    def has_traced_spec(self):
        """Whether the kernel spec is the traced logp's, or the traced pair
        of the user's gradient (not a compiled-in density's)."""
        return (not self._compiled_in
                and not isinstance(self._program(), Exception))

    @property
    def has_kernel_spec(self):
        """Whether the CUDA NUTS kernels can evaluate this density: a
        compiled-in density (``ops.densities``), or a logp or the user's
        gradient pair that traces into the kernels' op set
        (``ops/trace.py``). The kernels' own limit on D is the routing's
        (``nuts_cuda.kernel_refusal``)."""
        return self._compiled_in or self.has_traced_spec

    def kernel_trace_error(self):
        """Why the logp (or the user's gradient pair) does not trace (a
        string), or None."""
        if self._compiled_in:
            return None
        prog = self._program()
        return str(prog) if isinstance(prog, Exception) else None

    def kernel_spec_key(self):
        """For a traced logp or pair, a value equal between two calls
        exactly when ``kernel_spec()`` would be: the trace's key (the user's
        functions' identities and the bytes of the tensors and the numbers
        they and ``logp_args`` / ``logp_kwargs`` hold), D and the
        transform's scales and bounds; None for a compiled-in density,
        whose spec the kernels key by its buffers."""
        if self._compiled_in:
            return None
        scales = self._input_scales
        return (self._trace_key(), self._input_size,
                None if scales is None else scales.tobytes(),
                np.asarray(self._hard_bounds).tobytes())

    def kernel_spec(self):
        """The description of this density for the CUDA NUTS kernels: the
        compiled-in density's own spec, or the traced program's (density
        ``'traced'``: its ``program``, whose gradient is the user's where
        there is one, and the program's packed constants), plus the fused
        bound transform (``lo``, ``width``, the three 0/1 masks and
        ``logw``; the identity transform when no scales are set). Raises
        ``NotImplementedError`` for a density that has neither."""
        if not self._compiled_in:
            prog = self._program()
            if isinstance(prog, Exception):
                raise NotImplementedError(
                    f'this density has no kernel_spec(): the CUDA NUTS '
                    f'kernels evaluate compiled-in densities '
                    f'(ops/densities.py) and logps (or a logp and its '
                    f'gradient) that trace into their op set '
                    f'(ops/trace.py); this one does not: {prog}')
            spec = dict(density='traced', dim=prog.D, program=prog,
                        params=[prog.pack()], scalars=(0.0, 0.0))
        else:
            spec = dict(self._logp.kernel_spec())
        D = spec['dim']
        scales = self._input_scales
        if scales is None:
            scales = np.stack([np.zeros(D), np.ones(D)], axis=-1)
            bounds = False
        else:
            bounds = self._hard_bounds
        ref = spec['params'][0]
        spec['transform'] = _con.fused_params(scales, bounds, ref.dtype,
                                              ref.device)
        return spec

    # ------------- host-facing vectorized API -------------

    # numpy in and out; the evaluation runs on ``get_device()`` in
    # ``get_dtype()``
    def _host(self, x):
        return torch.as_tensor(np.asarray(x), dtype=get_dtype(),
                               device=get_device())

    # ``use_surrogate`` is accepted, and ignored, for the signature of
    # ``Density`` (a DensityLite has no surrogate), as in the JAX package
    def logp(self, x, original_space=None, use_surrogate=None):
        original_space = self._check_os(original_space)
        with torch.no_grad():
            return self._logp_b(self._host(x), original_space).cpu().numpy()

    __call__ = logp

    def grad(self, x, original_space=None, use_surrogate=None):
        return self.logp_and_grad(x, original_space)[1]

    def logp_and_grad(self, x, original_space=None, use_surrogate=None):
        original_space = self._check_os(original_space)
        lp, g = self._logp_and_grad_b(self._host(x), original_space)
        return lp.cpu().numpy(), g.cpu().numpy()

    @property
    def input_size(self):
        return self._input_size

    @input_size.setter
    def input_size(self, size):
        if size is None:
            self._input_size = None
        else:
            size = int(size)
            if size <= 0:
                raise ValueError('input_size should be a positive int, or '
                                 f'None, instead of {size}.')
            self._input_size = size


# ``Pipeline`` and ``Density`` (module graphs with surrogates) live in
# core/pipeline.py; re-exported here, as the JAX package's module does
from .pipeline import Pipeline, Density  # noqa: E402,F401
