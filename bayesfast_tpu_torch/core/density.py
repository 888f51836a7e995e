"""Probability-density objects: constraint mixins and DensityLite.

Counterpart of ``bayesfast_tpu/core/density.py:34-344``. The logp is a torch
callable over a batch of points, ``logp(x (..., D)) -> (...)``; gradients in
the sampling (transformed) space come from autograd over the whole batch of
``logp(to_original(x)) + logdet``, with the fused transform's rational
backward (``ops.constraint.to_original_with_logdet``).

Densities from ``ops.densities`` also carry a ``kernel_spec()``, which the
CUDA NUTS kernels need: they cannot trace a torch function, so they
evaluate a compiled-in density and its analytic gradient.
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
        ``ops.densities`` also gives the CUDA kernels its ``kernel_spec``).
    input_size : int or None
        Dimensionality; used to draw default starting points.
    input_scales, hard_bounds : see ``_PipelineBase``.
    original_space : bool
        Default interpretation of inputs.
    """

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

    @property
    def has_kernel_spec(self):
        """Whether the logp is a compiled-in density (``ops.densities``)."""
        return hasattr(self._logp, 'kernel_spec')

    def kernel_spec(self):
        """The compiled-in description of this density for the CUDA NUTS
        kernels: the density's own spec plus the fused bound transform
        (``lo``, ``width``, the three 0/1 masks and ``logw``; the identity
        transform when no scales are set). Raises ``NotImplementedError``
        for a logp without one."""
        inner = getattr(self._logp, 'kernel_spec', None)
        if inner is None:
            raise NotImplementedError(
                'this density has no kernel_spec(): the CUDA NUTS kernels '
                'evaluate compiled-in densities only (ops/densities.py).')
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
