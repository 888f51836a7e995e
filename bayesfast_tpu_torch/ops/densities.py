"""Densities compiled into the CUDA NUTS kernels.

The JAX package's kernels trace any jnp density into Mosaic
(``bayesfast_tpu/samplers/nuts_pallas.py:576-608``, ``_trace_density``).
CUDA cannot trace a torch function, so the port's kernels carry their
densities compiled in (``csrc/nuts.cu``, one functor each). Every density
here is an ``nn.Module`` whose ``forward`` is the plain torch logp over a
batch ``(..., D)``, and whose ``kernel_spec()`` returns the kernel's density
id and its parameter tensors. ``spec_logp_and_grad`` evaluates a spec (with
the fused bound transform) analytically in torch, in the kernel's order of
operations: it is the density of the kernels' plain versions.
"""

import numpy as np
import torch
from torch import nn

__all__ = ['RotatedBanana', 'DiagGaussian', 'spec_logp_and_grad',
           'warp_sum', 'DENSITY_IDS']

# density ids shared with csrc/nuts.cu
DENSITY_IDS = {'banana': 0, 'gaussian': 1}


class RotatedBanana(nn.Module):
    """The bench's rotated banana (``bench.py:139-145``):
    ``z = A x``; ``t_i = (z_i^2 - z_{i+1})^2 / Q + (z_i - 1)^2`` on even
    ``i`` (``z_{i+1}`` wraps, as ``roll`` does); ``logp = -sum t - const``.
    """

    def __init__(self, A, Q=0.01, const=0.0, dtype=None):
        super().__init__()
        A = torch.as_tensor(np.asarray(A, np.float64), dtype=dtype)
        self.register_buffer('A', A)
        self.Q = float(Q)
        self.const = float(const)
        D = A.shape[0]
        self.register_buffer(
            'even', torch.as_tensor((np.arange(D) % 2) == 0, dtype=A.dtype))

    def forward(self, x):
        A = self.A.to(x)
        z = x @ A.T
        zn = torch.roll(z, -1, dims=-1)
        t = (z * z - zn) ** 2 / self.Q + (z - 1.0) ** 2
        return -torch.sum(t * self.even.to(x), dim=-1) - self.const

    def kernel_spec(self):
        # the kernel stages A and its transpose in shared memory
        A = self.A
        return dict(density='banana', dim=A.shape[0],
                    params=[A.reshape(-1)], scalars=(self.Q, self.const))


class DiagGaussian(nn.Module):
    """``logp = -0.5 * sum((x - mean)^2 / var)``: known moments for the
    smoke checks."""

    def __init__(self, mean, var, dtype=None):
        super().__init__()
        self.register_buffer('mean', torch.as_tensor(
            np.asarray(mean, np.float64), dtype=dtype))
        self.register_buffer('var', torch.as_tensor(
            np.asarray(var, np.float64), dtype=dtype))

    def forward(self, x):
        return -0.5 * torch.sum((x - self.mean.to(x)) ** 2 / self.var.to(x),
                                dim=-1)

    def kernel_spec(self):
        return dict(density='gaussian', dim=self.mean.shape[0],
                    params=[torch.cat([self.mean, self.var])],
                    scalars=(0.0, 0.0))


def warp_sum(x):
    """Sum over the last axis in the CUDA kernels' order: lane ``l`` of a
    warp holds elements ``l, l + 32, ...`` (zero past the end) and adds them
    in turn, then an xor butterfly over the 32 lanes halves the width five
    times. The plain versions sum this way so that on the card they round
    exactly as the kernels do."""
    D = x.shape[-1]
    ne = max(1, -(-D // 32))
    x = torch.nn.functional.pad(x, (0, 32 * ne - D))
    x = x.reshape(x.shape[:-1] + (ne, 32))
    s = x[..., 0, :]
    for e in range(1, ne):
        s = s + x[..., e, :]
    for half in (16, 8, 4, 2, 1):
        s = s[..., :half] + s[..., half:2 * half]
    return s[..., 0]


def _matvec_seq(M, x):
    """``y_j = sum_k M[j, k] x_k`` accumulated over k in order, as each
    kernel lane does (x (C, D) -> (C, D))."""
    y = torch.zeros_like(x)
    for k in range(x.shape[-1]):
        y = y + M[:, k] * x[:, k:k + 1]
    return y


def _density_lpg(spec, x):
    """Analytic (logp, grad) of the compiled-in density at original-space
    ``x`` (C, D), operation for operation as ``csrc/nuts.cu`` computes it.
    Divisors are tensors: torch on the card turns division by a Python
    scalar into multiplication by its reciprocal."""
    D = spec['dim']
    par = spec['params'][0].to(x)
    if spec['density'] == 'banana':
        Q, const = (torch.as_tensor(v, dtype=x.dtype, device=x.device)
                    for v in spec['scalars'])
        A = par[:D * D].reshape(D, D)
        idx = torch.arange(D, device=x.device)
        z = _matvec_seq(A, x)
        even = (idx % 2) == 0
        r = z * z - z[:, (idx + 1) % D]
        zm = z - 1.0
        t = torch.where(even, r * r / Q + zm * zm, torch.zeros_like(z))
        logp = -warp_sum(t) - const
        # d t_i / d z_i = 4 z_i r_i / Q + 2 (z_i - 1) on even i, and
        # d t_i / d z_{i+1} = -2 r_i / Q
        prv = (idx - 1) % D
        own = torch.where(even, 4.0 * z * r / Q + 2.0 * (z - 1.0),
                          torch.zeros_like(z))
        nb = torch.where(even[prv], -2.0 * r[:, prv] / Q,
                         torch.zeros_like(z))
        grad_z = -(own + nb)
        return logp, _matvec_seq(A.T, grad_z)
    if spec['density'] == 'gaussian':
        mean, var = par[:D], par[D:]
        dx = x - mean
        return -0.5 * warp_sum(dx * dx / var), -dx / var
    raise NotImplementedError(spec['density'])


def spec_logp_and_grad(spec, x_t):
    """Analytic transformed-space (logp, grad) of a ``DensityLite`` kernel
    spec at ``x_t`` (C, D): ``grad_t = grad_x * g + h`` with the fused
    transform's rational tangent map; the plain twin of the kernels'
    in-kernel density."""
    from .constraint import _fused_core
    tf = {k: (v.to(x_t) if torch.is_tensor(v) else v)
          for k, v in spec['transform'].items()}
    ep, s, s1s, x_o, m_none = _fused_core(
        x_t, tf['lo'], tf['width'], tf['m_lohi'], tf['m_lo'], tf['m_hi'])
    arg = tf['m_lohi'] * s1s + (1.0 - tf['m_lohi'])
    logdet = warp_sum(torch.log(arg) + (tf['m_lo'] + tf['m_hi']) * x_t) \
        + tf['logw']
    g = (tf['m_lohi'] * s1s + (tf['m_lo'] - tf['m_hi']) * ep + m_none) \
        * tf['width']
    h = tf['m_lohi'] * (1.0 - 2.0 * s) + tf['m_lo'] + tf['m_hi']
    logp, grad_x = _density_lpg(spec, x_o)
    return logp + logdet, grad_x * g + h
