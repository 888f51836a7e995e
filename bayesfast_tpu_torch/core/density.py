"""Probability-density objects: constraint mixins and DensityLite.

Counterpart of ``bayesfast_tpu/core/density.py:34-344``. The logp is a torch
callable over a batch of points, ``logp(x (..., D)) -> (...)``; gradients in
the sampling (transformed) space come from autograd over the whole batch of
``logp(to_original(x)) + logdet``, with the fused transform's rational
backward (``ops.constraint.to_original_with_logdet``).

Densities from ``ops.densities`` also carry a ``kernel_spec()``, which the
CUDA NUTS kernels need: they evaluate a compiled-in density and its
analytic gradient. Any other torch logp that traces into the kernels' op
set (``ops/trace.py``) has a kernel spec too: its program, whose functor
``ops/codegen.py`` generates and ``_build.load_traced`` compiles at first
use; a logp that does not trace has none (``kernel_trace_error`` says
why), and samples on the tree loop.
"""

import numpy as np
import torch

from ..config import get_device, get_dtype
from ..ops import constraint as _con

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


class DensityLite(_PipelineBase, _DensityBase):
    """Wrap a batched torch logp callable.

    Parameters
    ----------
    logp : callable
        ``logp(x) -> (...)`` for a batch of points ``x`` of shape
        ``(..., D)``, written in torch (an ``nn.Module`` from
        ``ops.densities`` gives the CUDA kernels its ``kernel_spec``; any
        other logp is traced into one when its ops are in the kernels' op
        set, ``ops/trace.py``).
    input_size : int or None
        Dimensionality; used to draw default starting points.
    input_scales, hard_bounds : see ``_PipelineBase``.
    original_space : bool
        Default interpretation of inputs.
    """

    _trace = None  # (trace key, D, Program or TraceError), see _program

    def __init__(self, logp=None, input_size=None, input_scales=None,
                 hard_bounds=False, original_space=True):
        if logp is None:
            raise ValueError('logp is required.')
        self._logp = logp
        self.input_size = input_size
        self.input_scales = input_scales
        self.hard_bounds = hard_bounds
        self.original_space = original_space

    def _logp_trans(self, x_t):
        """Batched logp in transformed space, with the log-Jacobian."""
        x_o, logdet = _con.to_original_with_logdet(
            x_t, self._input_scales, self._hard_bounds)
        return self._logp(x_o) + logdet

    def _logp_b(self, x, original_space):
        return self._logp(x) if original_space else self._logp_trans(x)

    def _logp_and_grad_b(self, x, original_space):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            lp = self._logp_b(x, original_space)
            (g,) = torch.autograd.grad(lp.sum(), x)
        return lp.detach(), g

    def current_params(self):
        """No runtime-mutable parameters for a plain DensityLite."""
        return ()

    def device_logp_and_grad(self, original_space=False):
        """Return ``fn(params, x (C, D)) -> (logp (C,), grad (C, D))``.

        ``params`` is ignored; the signature matches the JAX package so the
        driver threads density parameters the same way.
        """
        def fn(params, x):
            return self._logp_and_grad_b(x, original_space)
        return fn

    def device_logp(self, original_space=False):
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

    def _program(self):
        """The logp traced at ``input_size`` (``ops.trace.trace_density``,
        in the configured dtype on the configured device), kept until
        ``ops.trace.trace_key`` of the logp changes; a ``TraceError`` when
        it does not trace, or when ``input_size`` is not set."""
        from ..ops.trace import TraceError, trace_density, trace_key
        D = self._input_size
        if D is None:
            return TraceError('input_size is not set: the logp is traced '
                              'at one point of that size')
        key = trace_key(self._logp)
        if self._trace is None or self._trace[:2] != (key, D):
            try:
                prog = trace_density(self._logp, D, get_dtype(),
                                     get_device())
            except TraceError as exc:
                prog = exc
            self._trace = (key, D, prog)
        return self._trace[2]

    @property
    def has_traced_spec(self):
        """Whether the kernel spec is the traced logp's (not a compiled-in
        density's)."""
        return (not hasattr(self._logp, 'kernel_spec')
                and not isinstance(self._program(), Exception))

    @property
    def has_kernel_spec(self):
        """Whether the CUDA NUTS kernels can evaluate this density: a
        compiled-in density (``ops.densities``) or a logp that traces into
        the kernels' op set (``ops/trace.py``). The kernels' own limit on D
        is the routing's (``nuts_cuda.kernel_refusal``)."""
        return hasattr(self._logp, 'kernel_spec') or self.has_traced_spec

    def kernel_trace_error(self):
        """Why the logp does not trace (a string), or None."""
        if hasattr(self._logp, 'kernel_spec'):
            return None
        prog = self._program()
        return str(prog) if isinstance(prog, Exception) else None

    def kernel_spec_key(self):
        """For a traced logp, a value equal between two calls exactly when
        ``kernel_spec()`` would be: the trace's key (the logp's identity
        and the bytes of the tensors and the numbers it reads), D and the
        transform's scales and bounds; None for a compiled-in density,
        whose spec the kernels key by its buffers."""
        if hasattr(self._logp, 'kernel_spec'):
            return None
        from ..ops.trace import trace_key
        scales = self._input_scales
        return (trace_key(self._logp), self._input_size,
                None if scales is None else scales.tobytes(),
                np.asarray(self._hard_bounds).tobytes())

    def kernel_spec(self):
        """The description of this density for the CUDA NUTS kernels: the
        compiled-in density's own spec, or the traced logp's (density
        ``'traced'``: its ``program`` and the program's packed constants),
        plus the fused bound transform (``lo``, ``width``, the three 0/1
        masks and ``logw``; the identity transform when no scales are set).
        Raises ``NotImplementedError`` for a logp that has neither."""
        inner = getattr(self._logp, 'kernel_spec', None)
        if inner is None:
            prog = self._program()
            if isinstance(prog, Exception):
                raise NotImplementedError(
                    f'this density has no kernel_spec(): the CUDA NUTS '
                    f'kernels evaluate compiled-in densities '
                    f'(ops/densities.py) and logps that trace into their op '
                    f'set (ops/trace.py); this one does not: {prog}')
            spec = dict(density='traced', dim=prog.D, program=prog,
                        params=[prog.pack()], scalars=(0.0, 0.0))
        else:
            spec = dict(inner())
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
