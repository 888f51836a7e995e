"""Five densities written as a user writes them, in torch, op for op as
the JAX scripts write them in jnp: ``bench.py:141-145``'s banana-32 and the
densities of ``examples/{banana,funnel,ring,cauchy}_gbs.py``. None of them
is compiled into the CUDA NUTS kernels: a ``DensityLite`` over one traces
it (``ops/trace.py``) and the kernels run the functor generated from the
trace (``ops/codegen.py``).

Each function returns ``(DensityLite, info)``: the bounds of its script
(``input_scales`` with ``hard_bounds=True``), ``input_size`` D, and
``info`` a dict of the script's constants (``A``, the rotation as a
float64 numpy array, for the bananas). Each logp is batched torch, ``(...,
D) -> (...)``; the JAX scripts write one point, and ``x[..., i]`` and
``dim=-1`` are their ``x[i]`` and ``jnp.sum`` on a batch. The closed-over
tensors keep the scripts' dtypes (bench.py's rotation is float32) and
follow ``x`` with ``.to(x)``.
"""

import math
from functools import partial

import numpy as np
import torch
from scipy.stats import special_ortho_group

from ..core.density import DensityLite

__all__ = ['bench_banana', 'banana', 'funnel', 'ring', 'cauchy', 'DENSITIES',
           'bench_banana_user']


def _bounded(logp, lower, upper):
    bound = np.stack((lower, upper)).T
    return DensityLite(logp=logp, input_size=bound.shape[0],
                       input_scales=bound, hard_bounds=True)


def _const(lower, upper):
    return float(np.sum(np.log(upper - lower)))


def bench_banana():
    """``bench.py:129-149``: the rotated banana-32 with Q = 0.01, a float32
    rotation ``special_ortho_group.rvs(32, random_state=0)``, the even-pair
    mask and ``roll``, bounds [-15, 15], less the log volume."""
    D, Q = 32, 0.01
    lower, upper = np.full(D, -15.), np.full(D, 15.)
    const = _const(lower, upper)
    A_np = special_ortho_group.rvs(D, random_state=0)
    A = torch.as_tensor(A_np, dtype=torch.float32)
    # even-pair mask formulation: same math as z[::2] / z[1::2]
    even = torch.as_tensor((np.arange(D) % 2) == 0, dtype=torch.float32)

    def logp(x):
        z = x @ A.to(x).T
        zn = torch.roll(z, -1, dims=-1)
        t = (z * z - zn) ** 2 / Q + (z - 1.0) ** 2
        return -torch.sum(t * even.to(x), dim=-1) - const

    return _bounded(logp, lower, upper), {'A': A_np, 'Q': Q, 'const': const}


def banana():
    """``examples/banana_gbs.py``: the rotated banana-32 with strided
    slices, a float64 rotation, bounds [-15, 15]."""
    D, Q = 32, 0.01
    lower, upper = np.full(D, -15.), np.full(D, 15.)
    const = _const(lower, upper)
    A_np = special_ortho_group.rvs(D, random_state=0)
    A = torch.as_tensor(A_np)

    def logp(x):
        x = x @ A.to(x).T
        return (-torch.sum((x[..., ::2] ** 2 - x[..., 1::2]) ** 2 / Q
                           + (x[..., ::2] - 1) ** 2, dim=-1) - const)

    return _bounded(logp, lower, upper), {'A': A_np, 'Q': Q, 'const': const}


def funnel():
    """``examples/funnel_gbs.py:23-29``: Neal's funnel-16 (a = 1, b =
    0.5), bounds [-4, 4] on x0 and [-30, 30] elsewhere."""
    D, a, b = 16, 1., 0.5
    lower, upper = np.full(D, -30.), np.full(D, 30.)
    lower[0], upper[0] = -4, 4
    const = _const(lower, upper)

    def logp(x):
        n = D
        _a = -0.5 * x[..., 0] ** 2 / a ** 2
        _b = -0.5 * torch.sum(x[..., 1:] ** 2, dim=-1) * torch.exp(
            -2 * b * x[..., 0])
        _c = (-0.5 * math.log(2 * math.pi * a ** 2)
              - 0.5 * (n - 1) * math.log(2 * math.pi) - (n - 1) * b
              * x[..., 0])
        return _a + _b + _c - const

    return _bounded(logp, lower, upper), {'const': const}


def ring():
    """``examples/ring_gbs.py:22-25``: the ring-64 (a = 2, b = 1), its
    neighbours by a ``cat`` of the wrapped ends, bounds [-5, 5]."""
    D, a, b = 64, 2., 1.
    lower, upper = np.full(D, -5.), np.full(D, 5.)
    const = _const(lower, upper)

    def logp(x):
        x2 = x * x
        x2s = torch.cat((x2[..., -1:], x2, x2[..., :1]), dim=-1)
        return -torch.sum((x2s[..., :-2] + x2s[..., 1:-1] - a) ** 2 / b,
                          dim=-1) - const

    return _bounded(logp, lower, upper), {'const': const}


def cauchy():
    """``examples/cauchy_gbs.py:23-27``: the bimodal Cauchy-48 (a = 5),
    bounds [-100, 100]."""
    D, a = 48, 5.
    lower, upper = np.full(D, -100.), np.full(D, 100.)
    const = _const(lower, upper)

    def logp(x):
        _a = 1 / ((x + a) ** 2 + 1)
        _b = 1 / ((x - a) ** 2 + 1)
        return (torch.sum(torch.log(_a + _b), dim=-1)
                + D * math.log(0.5 / math.pi) - const)

    return _bounded(logp, lower, upper), {'const': const}


#: the five, by name
DENSITIES = {'bench_banana': bench_banana, 'banana': banana,
             'funnel': funnel, 'ring': ring, 'cauchy': cauchy}


def bench_banana_user(form='grad'):
    """``bench_banana`` with the gradient written by hand, as a user of the
    JAX package passes it: the same rotation (float32), even-pair mask e,
    Q, bounds, constant and logp. With z = A x and r = z^2 - roll(z, -1),
    logp = -sum((r^2 / Q + (z - 1)^2) e) - const, and the gradient is A^T
    ((2 / Q) (roll(e r, 1) - 2 z (e r)) - 2 e (z - 1)). ``form``:

    * ``'grad'``: ``DensityLite(logp=, grad=, vectorized=False)``, each a
      function of one point (D,), in torch;
    * ``'logp_and_grad'``: ``DensityLite(logp_and_grad=)``, batched
      (the port's default form), one function returning the pair;
    * ``'external'``: ``DensityLite(logp=, traceable=False)``, the logp of
      one point in numpy (float64 arithmetic on the float32 rotation), as
      an external likelihood; it has no gradient.

    The first two trace to one program, whose functor is as fast as the
    tracer's adjoint of ``bench_banana``'s logp; an algebraically equal
    gradient written otherwise (the mask taken into r before the squares,
    say) can cost some 9 % a leapfrog, or a spill in float64 (PR 19's
    chip runs, ``PERF.md``).
    """
    D, Q = 32, 0.01
    lower, upper = np.full(D, -15.), np.full(D, 15.)
    const = _const(lower, upper)
    A_np = special_ortho_group.rvs(D, random_state=0)
    A = torch.as_tensor(A_np, dtype=torch.float32)
    even = torch.as_tensor((np.arange(D) % 2) == 0, dtype=torch.float32)
    kw = dict(input_size=D, input_scales=np.stack((lower, upper)).T,
              hard_bounds=True)
    info = {'A': A_np, 'Q': Q, 'const': const}

    def logp_z(z, e, dim):
        r = z * z - torch.roll(z, -1, dims=dim)
        return -torch.sum((r ** 2 / Q + (z - 1.0) ** 2) * e, dim=dim) - const

    def dlogp_dz(z, e, dim):
        er = e * (z * z - torch.roll(z, -1, dims=dim))
        return ((2.0 / Q) * (torch.roll(er, 1, dims=dim) - 2.0 * z * er)
                - 2.0 * e * (z - 1.0))

    if form == 'grad':
        def logp(x):
            return logp_z(A.to(x) @ x, even.to(x), 0)

        def grad(x):
            return A.to(x).T @ dlogp_dz(A.to(x) @ x, even.to(x), 0)

        return DensityLite(logp=logp, grad=grad, vectorized=False,
                           **kw), info
    if form == 'logp_and_grad':
        def logp_and_grad(x):
            z = x @ A.to(x).T
            return (logp_z(z, even.to(x), -1),
                    dlogp_dz(z, even.to(x), -1) @ A.to(x))

        return DensityLite(logp_and_grad=logp_and_grad, **kw), info
    if form == 'external':
        A32 = A.numpy().astype(np.float64)
        even_np = even.numpy().astype(np.float64)
        return DensityLite(logp=partial(_external_banana, A32, even_np, Q,
                                        const),
                           traceable=False, **kw), info
    raise ValueError(f'unknown form {form!r}')


def _external_banana(A, even, Q, const, x):
    """The bench banana of one point in numpy (a module-level function, so
    that a process pool can pickle it)."""
    z = A @ np.asarray(x, np.float64)
    r = z * z - np.roll(z, -1)
    return float(-np.sum((r ** 2 / Q + (z - 1.0) ** 2) * even) - const)
