"""Densities compiled into the CUDA NUTS kernels.

The JAX package's kernels trace any jnp density into Mosaic
(``bayesfast_tpu/samplers/nuts_pallas.py:576-608``, ``_trace_density``).
The port's kernels carry the densities here compiled in (``csrc/nuts.cu``,
one functor each), and a user's own torch logp traced into a program
(``ops/trace.py``) and generated as a functor of its own
(``ops/codegen.py``; density id ``'traced'``). Every density here is an
``nn.Module`` whose ``forward`` is the plain torch logp over a batch
``(..., D)``, and whose ``kernel_spec()`` returns the kernel's density id
and its parameter tensors. ``spec_logp_and_grad`` evaluates a spec (with
the fused bound transform) analytically in torch, in the kernel's order of
operations: it is the density of the kernels' plain versions.
"""

import numpy as np
import torch
from torch import nn

__all__ = ['RotatedBanana', 'DiagGaussian', 'NealFunnel', 'RingDensity',
           'CauchyPair', 'poly_gaussian_spec', 'spec_logp_and_grad',
           'warp_sum', 'DENSITY_IDS']

# density ids shared with csrc/nuts.cu
DENSITY_IDS = {'banana': 0, 'gaussian': 1, 'poly_gaussian': 2, 'funnel': 3,
               'ring': 4, 'cauchy': 5, 'traced': 6}


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


# ---------------------------------------------------------------------------
# The GBS evidence anchors (benchmarks/suite.py:60-95, examples/*_gbs.py).
# Each kernel spec carries the shape constants in ``params`` and
# ``scalars = (normalizing constant, const)``; ``const`` is subtracted last.

def _buffer(module, name, values):
    module.register_buffer(name, torch.as_tensor(
        np.asarray(values, np.float64)))


class NealFunnel(nn.Module):
    """Neal's funnel: ``x_0 ~ N(0, a^2)`` and ``x_i ~ N(0, e^(2 b x_0))``
    for ``i >= 1``, less ``const``::

        logp = -x_0^2 / (2 a^2) - S e^(-2 b x_0) / 2 + c_0 - (D - 1) b x_0
               - const,   S = sum_{i >= 1} x_i^2,
        c_0 = -log(2 pi a^2) / 2 - (D - 1) log(2 pi) / 2.
    """

    def __init__(self, D=16, a=1., b=0.5, const=0.0):
        super().__init__()
        self.D, self.a, self.b = int(D), float(a), float(b)
        self.const = float(const)
        self.c0 = float(-0.5 * np.log(2 * np.pi * self.a ** 2)
                        - 0.5 * (self.D - 1) * np.log(2 * np.pi))
        # a^2, b, -2 b, (D - 1) b
        _buffer(self, 'par', [self.a ** 2, self.b, -2 * self.b,
                              (self.D - 1) * self.b])

    def forward(self, x):
        x0 = x[..., 0]
        s = torch.sum(x[..., 1:] ** 2, dim=-1)
        return (-0.5 * x0 ** 2 / self.a ** 2
                - 0.5 * s * torch.exp(-2 * self.b * x0)
                + (self.c0 - (self.D - 1) * self.b * x0) - self.const)

    def kernel_spec(self):
        return dict(density='funnel', dim=self.D, params=[self.par],
                    scalars=(self.c0, self.const))


class RingDensity(nn.Module):
    """The ring: cyclic terms ``r_j = x_{j-1}^2 + x_j^2 - a`` (``x_{-1} =
    x_{D-1}``), ``logp = -sum_j r_j^2 / b - const``."""

    def __init__(self, D=64, a=2., b=1., const=0.0):
        super().__init__()
        self.D, self.a, self.b = int(D), float(a), float(b)
        self.const = float(const)
        _buffer(self, 'par', [self.a, self.b])

    def forward(self, x):
        x2 = x * x
        r = torch.roll(x2, 1, dims=-1) + x2 - self.a
        return -torch.sum(r * r / self.b, dim=-1) - self.const

    def kernel_spec(self):
        return dict(density='ring', dim=self.D, params=[self.par],
                    scalars=(0.0, self.const))


class CauchyPair(nn.Module):
    """A pair of Cauchy bumps at +-a in every dimension, ``2^D`` modes::

        logp = sum_i log(1 / ((x_i + a)^2 + 1) + 1 / ((x_i - a)^2 + 1))
               + D log(1 / (2 pi)) - const.
    """

    def __init__(self, D=48, a=5., const=0.0):
        super().__init__()
        self.D, self.a = int(D), float(a)
        self.const = float(const)
        self.c0 = float(self.D * np.log(0.5 / np.pi))
        _buffer(self, 'par', [self.a])

    def forward(self, x):
        ta = 1.0 / ((x + self.a) ** 2 + 1.0)
        tb = 1.0 / ((x - self.a) ** 2 + 1.0)
        return torch.sum(torch.log(ta + tb), dim=-1) + self.c0 - self.const

    def kernel_spec(self):
        return dict(density='cauchy', dim=self.D, params=[self.par],
                    scalars=(self.c0, self.const))


def warp_sum(x):
    """Sum over the last axis in the CUDA kernels' order: lane ``l`` of a
    warp holds elements ``l, l + 32, ...`` (zero past the end) and adds them
    in turn, then an xor butterfly over the 32 lanes halves the width five
    times. The plain versions sum this way so that on the card they round
    exactly as the kernels do."""
    D = x.shape[-1]
    ne = max(1, -(-D // 32))
    if 32 * ne != D:
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


def _dense_matvec(M, x):
    """``y_j = sum_k M[j, k] x_k`` as one matmul (x (C, D) -> (C, D))."""
    return x @ M.T


def _row_sum(x):
    return torch.sum(x, dim=-1)


def _ops(ordered):
    """The (matvec, lane sum) pair: the kernels' order of operations, or
    dense torch calls in their own order."""
    return (_matvec_seq, warp_sum) if ordered else (_dense_matvec, _row_sum)


def _density_lpg(spec, x, ordered=True):
    """Analytic (logp, grad) of the compiled-in density at original-space
    ``x`` (C, D), operation for operation as ``csrc/nuts.cu`` computes it
    (``ordered``), or with each matvec one matmul and each sum one torch
    sum (a few launches, for the samplers that have no kernel to match).
    Divisors are tensors: torch on the card turns division by a Python
    scalar into multiplication by its reciprocal."""
    if spec['density'] == 'traced':
        # the program's interpreter (ops/trace.py) on the packed constants,
        # cast once per dtype and device
        cache = spec.setdefault('_cast', {})
        key = (x.dtype, x.device)
        if key not in cache:
            cache[key] = spec['params'][0].to(x)
        return spec['program'].logp_and_grad(x, cache[key], ordered)
    mv, sm = _ops(ordered)
    D = spec['dim']
    par = spec['params'][0].to(x)
    if spec['density'] == 'banana':
        # Python scalars copy nothing to the device (a scalar tensor made
        # from one is a blocking host-to-device copy each call)
        Q, const = ((torch.as_tensor(v, dtype=x.dtype, device=x.device)
                     for v in spec['scalars']) if ordered
                    else map(float, spec['scalars']))
        A = par[:D * D].reshape(D, D)
        idx = torch.arange(D, device=x.device)
        z = mv(A, x)
        even = (idx % 2) == 0
        r = z * z - z[:, (idx + 1) % D]
        zm = z - 1.0
        t = torch.where(even, r * r / Q + zm * zm, torch.zeros_like(z))
        logp = -sm(t) - const
        # d t_i / d z_i = 4 z_i r_i / Q + 2 (z_i - 1) on even i, and
        # d t_i / d z_{i+1} = -2 r_i / Q
        prv = (idx - 1) % D
        own = torch.where(even, 4.0 * z * r / Q + 2.0 * (z - 1.0),
                          torch.zeros_like(z))
        nb = torch.where(even[prv], -2.0 * r[:, prv] / Q,
                         torch.zeros_like(z))
        grad_z = -(own + nb)
        return logp, mv(A.T, grad_z)
    if spec['density'] == 'gaussian':
        mean, var = par[:D], par[D:]
        dx = x - mean
        return -0.5 * sm(dx * dx / var), -dx / var
    if spec['density'] == 'poly_gaussian':
        return _poly_gaussian_lpg(spec, x, ordered)
    if spec['density'] in ('funnel', 'ring', 'cauchy'):
        return _ANCHORS[spec['density']](spec, par, x, ordered)
    raise NotImplementedError(spec['density'])


def _scalars(spec, x, ordered):
    """The spec's (normalizing constant, const): tensors of x's dtype for
    the kernels' order (as the kernels round them from double), floats
    for the dense calls."""
    if ordered:
        return [torch.as_tensor(v, dtype=x.dtype, device=x.device)
                for v in spec['scalars']]
    return [float(v) for v in spec['scalars']]


def _funnel_lpg(spec, par, x, ordered):
    """``csrc/nuts.cu::Funnel``: S over the lanes in the warp's order (the
    kernel's own butterfly, inside the gradient), then ``g_0 = b S
    e^(-2 b x_0) - x_0 / a^2 - (D - 1) b`` and ``g_i = -x_i e^(-2 b x_0)``."""
    sm = _ops(ordered)[1]
    c0, const = _scalars(spec, x, ordered)
    a2, b, mb2, db = par[0], par[1], par[2], par[3]
    x0 = x[:, 0]
    ex = torch.exp(mb2 * x0)
    sq = x * x
    S = sm(torch.cat([torch.zeros_like(sq[:, :1]), sq[:, 1:]], dim=-1))
    logp = ((-0.5 * (x0 * x0 / a2) - 0.5 * S * ex) + (c0 - db * x0)) - const
    g = -(x * ex[:, None])
    g0 = (b * S * ex - x0 / a2) - db
    return logp, torch.cat([g0[:, None], g[:, 1:]], dim=-1)


def _ring_lpg(spec, par, x, ordered):
    """``csrc/nuts.cu::Ring``: ``r_j = (x_{j-1}^2 + x_j^2) - a`` and
    ``g_k = -(4 x_k (r_k + r_{k+1})) / b``, the neighbours cyclic."""
    sm = _ops(ordered)[1]
    const = _scalars(spec, x, ordered)[1]
    a, b = par[0], par[1]
    D = x.shape[-1]
    idx = torch.arange(D, device=x.device)
    x2 = x * x
    r = (x2[:, (idx - 1) % D] + x2) - a
    logp = -sm(r * r / b) - const
    return logp, -(4.0 * x * (r + r[:, (idx + 1) % D])) / b


def _cauchy_lpg(spec, par, x, ordered):
    """``csrc/nuts.cu::Cauchy``: per element ``t = 1 / ((x + a)^2 + 1) +
    1 / ((x - a)^2 + 1)``, its log summed, and ``g = -2 ((x + a) ta^2 +
    (x - a) tb^2) / t``."""
    sm = _ops(ordered)[1]
    c0, const = _scalars(spec, x, ordered)
    a = par[0]
    u, v = x + a, x - a
    ta = 1.0 / (u * u + 1.0)
    tb = 1.0 / (v * v + 1.0)
    t = ta + tb
    logp = (sm(torch.log(t)) + c0) - const
    return logp, -2.0 * (u * ta * ta + v * tb * tb) / t


_ANCHORS = {'funnel': _funnel_lpg, 'ring': _ring_lpg, 'cauchy': _cauchy_lpg}


# ---------------------------------------------------------------------------
# The surrogate density of a Recipe: PolyModel -> diagonal Gaussian

def _triples(order, im, D):
    """The features of one PolyModel config as index triples over ``xa =
    [u, 1]`` (index ``D`` is the 1), in the JAX ``PolyConfig``'s order
    (``bayesfast_tpu/modules/poly.py:43-86``): linear ``[1, u_i]``,
    quadratic ``u_k u_l`` (k <= l row-major), cubic-2 ``u_k u_k u_l`` over
    all (k, l), cubic-3 ``u_k u_l u_p`` (k < l < p); ``im`` maps a config's
    inputs to the density's dimensions."""
    im = np.append(np.asarray(im, int), D)
    n = im.size - 1
    if order == 'linear':
        idx = [np.append(n, np.arange(n)), np.full(n + 1, n),
               np.full(n + 1, n)]
    elif order == 'quadratic':
        k, l = np.triu_indices(n)
        idx = [k, l, np.full(k.size, n)]
    elif order == 'cubic-2':
        k, l = (a.reshape(-1) for a in np.mgrid[0:n, 0:n])
        idx = [k, k, l]
    elif order == 'cubic-3':
        kl = [(k, l, p) for k in range(n) for l in range(k + 1, n)
              for p in range(l + 1, n)]
        idx = list(np.asarray(kl, int).reshape(-1, 3).T)
    else:
        raise ValueError(f'unexpected order {order}.')
    return np.stack([im[i] for i in idx], axis=-1).reshape(-1, 3)


def poly_gaussian_spec(dim, configs, n_out, mean, var_inv, norm, bound=None,
                       decay=None, prec=None, scales=None):
    """The kernel spec of ``m = PolyModel(x)`` (any mix of linear,
    quadratic, cubic-2 and cubic-3 configs) followed by the Gaussian
    log-likelihood ``-0.5 sum (m - mean)^2 var_inv + norm``, or ``-0.5 r'
    prec r + norm`` with ``r = m - mean`` for a full precision matrix
    ``prec`` (``var_inv`` None), with the PolyModel's input scales and
    bound extrapolation and the Density's decay penalty
    (``bayesfast_tpu/core/module.py:83-101``,
    ``bayesfast_tpu/modules/poly.py:319-341``,
    ``bayesfast_tpu/core/pipeline.py:470-474``).

    ``configs`` is a list of ``(order, input_mask, output_mask, a)``, ``a``
    the (len(output_mask), n_features) coefficients; ``bound`` a dict of
    ``mu``, ``hess``, ``alpha``, ``f_mu`` (None: no extrapolation);
    ``decay`` a dict of ``mu``, ``hess``, ``alpha_2``, ``gamma`` (None: no
    penalty); ``scales`` the surrogate's ``input_scales`` (D, 2) of (lo,
    hi) (None: ``u = x``).

    The surrogate sees ``u = (x - lo) / (hi - lo)``, and its bound was
    fitted there. The features of all configs form one vector phi (F,)
    over ``xa = [u, 1]``: feature f is ``(xa[i1[f]] * xa[i2[f]]) *
    xa[i3[f]]`` (index ``dim`` is the 1; ``_triples``); ``WT`` (F, M) holds
    every config's coefficients at its outputs, so ``m = phi @ WT``. The
    gradient through phi goes by a sparse row per dimension: an entry
    (feature, partner 1, partner 2) for each position of the feature's
    triple that holds the dimension, in position order, the partners the
    triple's other two indices; then it is divided by ``hi - lo``. Both
    Hessians and the precision are symmetrized, which leaves each
    quadratic form as it is and makes its gradient ``2 H delta``; row k of
    the symmetric precision is its column k, which the kernel reads
    coalesced. Returns the spec dict: the structured ``arrays`` for the
    plain version, one packed float64 parameter vector for the kernel
    (``csrc/nuts.cu``, ``PolyGaussian``) and the ``scalars`` (norm, gamma,
    M, F, NNZ, bound on, decay on, alpha, alpha^2, full precision)."""
    D, M = int(dim), int(n_out)
    if D > 64:
        raise NotImplementedError(
            f'the CUDA NUTS kernels take D <= 64, got {D}.')
    trip, blocks = [], []
    for order, im, om, a in configs:
        trip.append(_triples(order, im, D))
        blocks.append((np.asarray(om, int), np.asarray(a, np.float64)))
    trip = np.concatenate(trip)
    F = trip.shape[0]
    WT = np.zeros((F, M))
    off = 0
    for om, a in blocks:
        WT[off:off + a.shape[1], om] = a.T
        off += a.shape[1]
    rows = [[] for _ in range(D)]
    for f, t in enumerate(trip.tolist()):
        for pos in range(3):
            if t[pos] < D:
                rows[t[pos]].append((f, *(t[:pos] + t[pos + 1:])))
    rowptr = np.cumsum([0] + [len(r) for r in rows])
    flat = np.asarray([e for r in rows for e in r], int).reshape(-1, 3)
    NNZ = flat.shape[0]
    L = max(1, max(len(r) for r in rows))
    # padded rows for the plain version: feature F is a zero, partner D a 1
    pad = np.empty((D, L, 3), int)
    pad[...] = (F, D, D)
    for d, r in enumerate(rows):
        if r:
            pad[d, :len(r)] = r

    def sym(h):
        h = np.asarray(h, np.float64)
        return 0.5 * (h + h.T)

    bound_on, decay_on = bound is not None, decay is not None
    if bound_on:
        mup, Hp, fmu = (np.asarray(bound['mu'], np.float64),
                        sym(bound['hess']),
                        np.asarray(bound['f_mu'], np.float64))
        alpha = float(bound['alpha'])
    else:
        mup, Hp, fmu, alpha = np.zeros(D), np.zeros((D, D)), np.zeros(M), 1.
    if decay_on:
        mud, Hd = np.asarray(decay['mu'], np.float64), sym(decay['hess'])
        alpha_2, gamma = float(decay['alpha_2']), float(decay['gamma'])
    else:
        mud, Hd, alpha_2, gamma = np.zeros(D), np.zeros((D, D)), 0., 0.
    dat = np.asarray(mean, np.float64)
    full = prec is not None
    vinv = np.zeros(M) if full else np.asarray(var_inv, np.float64)
    P = sym(prec) if full else np.zeros((0, M))
    # lo = 0 and hi - lo = 1 without scales: u = (x - 0) / 1 and g / 1 are
    # x and g bit for bit
    if scales is None:
        slo, sdiff = np.zeros(D), np.ones(D)
    else:
        scales = np.asarray(scales, np.float64)
        slo, sdiff = scales[:, 0], scales[:, 1] - scales[:, 0]
    packed = np.concatenate([
        WT.ravel(), dat, vinv, fmu, mup, Hp.ravel(), mud, Hd.ravel(), slo,
        sdiff, P.ravel(), trip.T.ravel(), rowptr, flat.T.ravel()]
    ).astype(np.float64)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a))

    arrays = dict(WT=t(WT), dat=t(dat), vinv=t(vinv), fmu=t(fmu), mup=t(mup),
                  Hp=t(Hp), mud=t(mud), Hd=t(Hd), P=t(P), slo=t(slo),
                  sdiff=t(sdiff))
    index = dict(trip=t(trip.T.astype(np.int64)),
                 rows=t(pad.transpose(2, 0, 1).astype(np.int64)))
    return dict(density='poly_gaussian', dim=D, params=[t(packed)],
                scalars=(float(norm), gamma, M, F, NNZ, int(bound_on),
                         int(decay_on), alpha, alpha_2, int(full)),
                arrays=arrays, index=index)


def _spec_arrays(spec, x):
    """The spec's arrays on x's dtype and device, cast once per pair."""
    cache = spec.setdefault('_cast', {})
    key = (x.dtype, x.device)
    if key not in cache:
        cache[key] = (
            {k: v.to(x) for k, v in spec['arrays'].items()},
            {k: v.to(x.device) for k, v in spec['index'].items()})
    return cache[key]


def _feature_sums(WT, phi):
    """``m0_j = sum_f WT[f, j] phi_f`` (WT (F, M), phi (C, F)), each
    output's sum over the features in order, as the kernels' forward pass
    takes it (the staged features, then the streamed tiles)."""
    m0 = torch.zeros((phi.shape[0], WT.shape[1]), dtype=phi.dtype,
                     device=phi.device)
    for f in range(WT.shape[0]):
        m0 = m0 + WT[f] * phi[:, f:f + 1]
    return m0


def _feature_grads(WT, gm0):
    """``d logp / d phi_f = sum_j WT[f, j] gm0_j`` (gm0 (C, M)), each
    feature's sum over the outputs in the warp's order (``warp_sum``), as
    the kernels' back pass takes it."""
    return warp_sum(WT[None] * gm0[:, None, :])


def _poly_gaussian_lpg(spec, x, ordered=True):
    """(logp, grad) of ``poly_gaussian_spec`` at original-space x (C, D),
    operation for operation as ``csrc/nuts.cu::PolyGaussian`` computes it:
    ``u = (x - lo) / diff`` as the port's ``Surrogate`` scales its input,
    the bound in u-space, a matvec by H sums over k in order
    (``_matvec_seq``), m_j sums over the features in order, (P r)_j over k
    in order, each lane sum (over outputs for the likelihood and the
    bound's scalars, over dimensions for the quadratic forms, over outputs
    for each feature's gradient) in the warp's order (``warp_sum``), a
    dimension's gradient over its sparse row in order, then divided by
    ``diff``, and the decay penalty in x. Not ``ordered``: the matvecs and
    feature sums as matmuls, the lane sums as torch sums."""
    mv, sm = _ops(ordered)
    a, ix = _spec_arrays(spec, x)
    (nrm, gamma, M, F, NNZ, bound_on, decay_on, alpha, alpha_2,
     full) = spec['scalars']
    C, D = x.shape

    def sc(v):
        return (torch.as_tensor(v, dtype=x.dtype, device=x.device) if ordered
                else float(v))

    alpha, gamma, alpha_2 = sc(alpha), sc(gamma), sc(alpha_2)
    outside = torch.zeros(C, dtype=torch.bool, device=x.device)
    u = (x - a['slo']) / a['sdiff']
    x0 = u
    if bound_on:
        delta = u - a['mup']
        hdel = mv(a['Hp'], delta)
        b2 = torch.clamp(sm(delta * hdel), min=1e-30)
        beta = torch.sqrt(b2)
        outside = beta > alpha
        bc = beta[:, None]
        x0 = torch.where(outside[:, None],
                         (alpha * u + (bc - alpha) * a['mup']) / bc, u)
    xa = torch.cat([x0, torch.ones_like(x0[:, :1])], dim=-1)
    i1, i2, i3 = ix['trip']
    phi = (xa[:, i1] * xa[:, i2]) * xa[:, i3]
    m0 = _feature_sums(a['WT'], phi) if ordered else phi @ a['WT']
    m = m0
    if bound_on:
        m = torch.where(outside[:, None],
                        (bc * m0 - (bc - alpha) * a['fmu']) / alpha, m0)
    r = m - a['dat']
    if full:
        if ordered:
            pr = torch.zeros_like(r)
            for k in range(M):
                pr = pr + a['P'][k] * r[:, k:k + 1]
        else:
            pr = r @ a['P']
        gm = -pr
        logp = -0.5 * sm(r * pr) + sc(nrm)
    else:
        rv = r * a['vinv']
        gm = -rv
        logp = -0.5 * sm(rv * r) + sc(nrm)
    gm0 = gm
    if bound_on:
        gm0 = torch.where(outside[:, None], gm * bc / alpha, gm)
    gphi = (_feature_grads(a['WT'], gm0) if ordered
            else gm0 @ a['WT'].T)
    gphi = torch.cat([gphi, torch.zeros_like(gphi[:, :1])], dim=-1)
    g = torch.zeros_like(x)
    fidx, p1, p2 = ix['rows']
    for t in range(fidx.shape[1]):
        g = g + gphi[:, fidx[:, t]] * (xa[:, p1[:, t]] * xa[:, p2[:, t]])
    if bound_on:
        s_beta = sm(gm * (m0 - a['fmu'])) / alpha
        dldb = s_beta + sm(g * (a['mup'] - x0)) / beta
        g = torch.where(outside[:, None],
                        g * alpha / bc + dldb[:, None] * hdel / bc, g)
    g = g / a['sdiff']
    dec = torch.zeros_like(logp)
    if decay_on:
        dd = x - a['mud']
        hdd = mv(a['Hd'], dd)
        ex = sm(dd * hdd) - alpha_2
        pos = ex > 0
        dec = torch.where(pos, gamma * ex, dec)
        g = torch.where(pos[:, None], g - gamma * (2.0 * hdd), g)
    return logp - dec, g


def spec_logp_and_grad(spec, x_t, ordered=True):
    """Analytic transformed-space (logp, grad) of a ``DensityLite`` kernel
    spec at ``x_t`` (C, D): ``grad_t = grad_x * g + h`` with the fused
    transform's rational tangent map; with ``ordered`` the plain twin of
    the kernels' in-kernel density, else in dense torch calls (see
    ``_density_lpg``)."""
    sm = _ops(ordered)[1]
    from .constraint import _fused_core
    # the transform's rows cast once per dtype and device (a copy to the
    # card at every evaluation otherwise)
    cache = spec.setdefault('_tf_cast', {})
    key = (x_t.dtype, x_t.device)
    if key not in cache:
        cache[key] = {k: (v.to(x_t) if torch.is_tensor(v) else v)
                      for k, v in spec['transform'].items()}
    tf = cache[key]
    ep, s, s1s, x_o, m_none = _fused_core(
        x_t, tf['lo'], tf['width'], tf['m_lohi'], tf['m_lo'], tf['m_hi'])
    arg = tf['m_lohi'] * s1s + (1.0 - tf['m_lohi'])
    logdet = sm(torch.log(arg) + (tf['m_lo'] + tf['m_hi']) * x_t) \
        + tf['logw']
    g = (tf['m_lohi'] * s1s + (tf['m_lo'] - tf['m_hi']) * ep + m_none) \
        * tf['width']
    h = tf['m_lohi'] * (1.0 - 2.0 * s) + tf['m_lo'] + tf['m_hi']
    logp, grad_x = _density_lpg(spec, x_o, ordered)
    return logp + logdet, grad_x * g + h
