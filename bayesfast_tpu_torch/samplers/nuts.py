"""NUTS statistics, the Hamiltonian integrator, and the batched tree loop,
in torch.

Counterpart of ``bayesfast_tpu/samplers/nuts.py``: ``NutsStats``, the metric
payload, the integrator state, the Kahan-compensated leapfrog, and the
iterative tree-doubling loop ``nuts_core_batched`` /
``nuts_transition_batched``. The JAX package computes that loop in XLA,
outside any Pallas kernel, so here it stays plain torch on any device; the
per-transition path (``ChainDriver.run``) takes it for a full metric and
for a density without ``kernel_spec()``, which the CUDA kernels
(``nuts_cuda.py``) cannot take.

The JAX package keeps everything lane-minor (``(D, C)``, for the TPU's
128-lane tiling); the port keeps chains on the leading axis (``(C, D)``,
PyTorch's habit) under the same names: vectors ``(C, D)``, scalars
``(C,)``, subtree frames ``(C, total)`` and the checkpoint stack
``(levels, C, total)``.

The loop's schedule (leaf index ``k`` in the current doubling, its depth)
is shared by every chain still in flight, exactly as in the JAX loop: a
chain leaves it only by diverging, turning or reaching the maximum depth,
and each of those ends the chain's tree. So the schedule is host ints, and
only the end of the loop (every chain done) is read from the device, once
per leaf. Randomness comes from one ``torch.Generator`` per transition
(``ChainDriver.run`` seeds it from the trace's seed and the global
iteration); it cannot
reproduce the JAX loop's jax-key draws, so the two are held together
statistically.
"""

from typing import Any, NamedTuple

import torch

from .metrics import DiagMetricState, sample_momentum_b

__all__ = ['NutsStats', 'TIntegratorState', 'compute_state_t', 'leapfrog_t',
           'nuts_core_batched', 'nuts_transition_batched']


class NutsStats(NamedTuple):
    logp: Any
    energy: Any
    tree_depth: Any
    tree_size: Any
    mean_tree_accept: Any
    energy_change: Any
    max_energy_change: Any
    diverging: Any


class TIntegratorState(NamedTuple):
    """Hamiltonian state: vectors (C, D), scalars (C,). ``cq``/``cp`` are
    the Kahan residuals of the position and momentum accumulators."""
    q: Any
    p: Any
    v: Any
    grad: Any
    energy: Any
    logp: Any
    cq: Any
    cp: Any


def _metric_t(metric):
    """The metric's payload: ``('diag', var)`` with var (C, D) or (D,), or
    ``('full', cov)`` with cov (C, D, D) or (D, D)."""
    if isinstance(metric, DiagMetricState):
        return ('diag', metric.var)
    return ('full', metric.cov)


def _make_vel_fn(metric_t):
    """``M^-1 p`` for momenta ``p`` of shape (..., C, D): the loop stores
    only momenta and recomputes endpoint velocities through this."""
    kind, payload = metric_t
    if kind == 'diag':
        return lambda p: payload * p
    if payload.dim() == 3:
        return lambda p: torch.einsum('cij,...cj->...ci', payload, p)
    return lambda p: torch.einsum('ij,...cj->...ci', payload, p)


def compute_state_t(metric_t, lpg_t, q, p):
    """Hamiltonian state; ``lpg_t`` maps (C, D) -> ((C,), (C, D))."""
    logp, grad = lpg_t(q)
    v = _make_vel_fn(metric_t)(p)
    energy = 0.5 * torch.sum(p * v, dim=-1) - logp
    zero = torch.zeros_like(q)
    return TIntegratorState(q, p, v, grad, energy, logp, zero, zero)


def _kahan_add(x, c, delta):
    """One compensated accumulation ``x += delta`` with residual ``c``."""
    y = delta - c
    t = x + y
    c_new = (t - x) - y
    return t, c_new


def leapfrog_t(metric_t, lpg_t, eps, s):
    """Leapfrog step; ``eps`` is (C,) signed per-chain steps."""
    vel = _make_vel_fn(metric_t)
    eps = eps[:, None]
    dt = 0.5 * eps
    p_half, cp = _kahan_add(s.p, s.cp, dt * s.grad)
    v_half = vel(p_half)
    q_new, cq = _kahan_add(s.q, s.cq, eps * v_half)
    logp, grad = lpg_t(q_new)
    p_new, cp = _kahan_add(p_half, cp, dt * grad)
    v_new = vel(p_new)
    energy = 0.5 * torch.sum(p_new * v_new, dim=-1) - logp
    return TIntegratorState(q_new, p_new, v_new, grad, energy, logp, cq, cp)


def _bwhere(mask, new, old):
    """Select per chain over two states (or tuples) of (C, ...) tensors."""
    return type(old)(*[torch.where(mask.view((-1,) + (1,) * (o.dim() - 1)),
                                   n, o) for n, o in zip(new, old)])


def _cwhere(mask, a, b):
    """``torch.where`` with a (C,) mask against (C, ...) tensors."""
    return torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), a, b)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


class _TreeLayout:
    """Column layout of a subtree summary, one row per chain:
    ``[left_p (D) | right_p (D) | p_sum (D) | log_size (1) | prop]``, the
    proposal a tuple of (C, ...) tensors flattened in order. Endpoint
    velocities are not stored: merges recompute them from the metric."""

    def __init__(self, dim, prop_example):
        self.prop_shapes = [tuple(t.shape[1:]) for t in prop_example]
        self.prop_sizes = [max(1, int(torch.Size(s).numel()))
                           for s in self.prop_shapes]
        self.total = 3 * dim + 1 + sum(self.prop_sizes)
        d = dim
        self.sl_left_p = slice(0, d)
        self.sl_right_p = slice(d, 2 * d)
        self.sl_p_sum = slice(2 * d, 3 * d)
        self.i_log_size = 3 * d
        self.sl_prop = slice(3 * d + 1, self.total)

    def flat_prop(self, prop):
        return torch.cat([t.reshape(t.shape[0], -1) for t in prop], dim=-1)

    def unflat_prop(self, flat):
        parts = torch.split(flat, self.prop_sizes, dim=-1)
        return tuple(p.reshape((p.shape[0],) + s)
                     for p, s in zip(parts, self.prop_shapes))

    def leaf(self, state, d_energy, prop_of):
        return torch.cat([state.p, state.p, state.p, -d_energy[:, None],
                          self.flat_prop(prop_of(state))], dim=-1)


def _merge_b(u, L, vel_fn, t1, t2, merged_depth):
    """Join adjacent subtrees ``t1`` (older, left of) and ``t2`` (newer),
    both (C, total); multinomial take by log size, and the generalized
    U-turn check with the extra inner-subtree checks above merged depth 1
    (``nuts.py:237-271``)."""
    ps1, ps2 = t1[:, L.sl_p_sum], t2[:, L.sl_p_sum]
    p_sum = ps1 + ps2
    p_sum1 = ps1 + t2[:, L.sl_left_p]
    p_sum2 = t1[:, L.sl_right_p] + ps2
    v1l, v1r, v2l, v2r = vel_fn(torch.stack(
        [t1[:, L.sl_left_p], t1[:, L.sl_right_p], t2[:, L.sl_left_p],
         t2[:, L.sl_right_p]]))
    turning = (_dot(p_sum, v1l) <= 0) | (_dot(p_sum, v2r) <= 0)
    if merged_depth > 1:
        turning = (turning | (_dot(p_sum1, v1l) <= 0)
                   | (_dot(p_sum1, v2l) <= 0) | (_dot(p_sum2, v1r) <= 0)
                   | (_dot(p_sum2, v2r) <= 0))
    ls1, ls2 = t1[:, L.i_log_size], t2[:, L.i_log_size]
    log_size = torch.logaddexp(ls1, ls2)
    take2 = torch.log(u) < ls2 - log_size
    tail = _cwhere(take2, t2[:, L.sl_prop], t1[:, L.sl_prop])
    merged = torch.cat([t1[:, L.sl_left_p], t2[:, L.sl_right_p], p_sum,
                        log_size[:, None], tail], dim=-1)
    return merged, turning


def _merge_leaf(u, L, vel_fn, t1, state, d_energy, prop_of):
    """The first binary-counter merge, of the one-leaf subtree ``t1``
    (stack level 0) with the just-integrated leaf ``state``: at merged
    depth 1 only the two outer U-turn dots apply, and the new leaf's
    velocity is already in ``state.v`` (``nuts.py:274-297``)."""
    p_sum = t1[:, L.sl_p_sum] + state.p
    v1l = vel_fn(t1[:, L.sl_left_p])
    turning = (_dot(p_sum, v1l) <= 0) | (_dot(p_sum, state.v) <= 0)
    ls1, ls2 = t1[:, L.i_log_size], -d_energy
    log_size = torch.logaddexp(ls1, ls2)
    take2 = torch.log(u) < ls2 - log_size
    tail = _cwhere(take2, L.flat_prop(prop_of(state)), t1[:, L.sl_prop])
    merged = torch.cat([t1[:, L.sl_left_p], state.p, p_sum,
                        log_size[:, None], tail], dim=-1)
    return merged, turning


def _trailing_ones(k):
    """Number of trailing 1-bits of ``k``: the binary-counter merges after
    integrating leaf ``k``."""
    n = 0
    while k & 1:
        n += 1
        k >>= 1
    return n


def nuts_core_batched(generator, start, step_fn, prop_of, step_size,
                      max_treedepth, max_change, vel_fn):
    """The iterative tree-doubling loop over any integrator state with
    ``.q/.p/.v/.energy/.logp`` fields, vectors (C, D) and scalars (C,)
    (``nuts.py:307-532``).

    ``step_fn(eps, state)`` integrates one leapfrog with per-chain signed
    steps ``eps`` (C,); ``step_size`` is (C,) positive; ``vel_fn`` maps
    stored momenta (..., C, D) to velocities; ``prop_of(state)`` is the
    proposal, a tuple of (C, ...) tensors. Uniforms come from
    ``generator``, on its device. Returns a dict of per-chain results
    (``prop``, ``depth``, ``n_prop``, ``accept_sum``, ``max_de``,
    ``diverging``).

    Every iteration integrates one leaf and runs all of that leaf's
    binary-counter merges; finished chains ride along masked, and their
    stack frames go stale but are never read.
    """
    C, D = start.q.shape
    dtype, dev = start.q.dtype, start.q.device
    L = _TreeLayout(D, prop_of(start))
    # a depth-d subtree reads levels 0..d-2 and writes 0..d-1, d <=
    # max_treedepth - 1; one more level is the sink for finished subtrees
    n_lvl = max(int(max_treedepth) - 1, 1)
    start_energy = start.energy

    def uniform(*shape):
        return torch.rand(shape, generator=generator, dtype=dtype,
                          device=generator.device).to(dev)

    go_right = uniform(C) < 0.5
    eps = torch.where(go_right, step_size, -step_size)
    cur, left, right = start, start, start
    prop = L.flat_prop(prop_of(start))
    p_sum = start.p
    log_size = torch.zeros(C, dtype=dtype, device=dev)
    stack = torch.zeros((n_lvl + 1, C, L.total), dtype=dtype, device=dev)
    depth = torch.zeros(C, dtype=torch.int32, device=dev)
    accept_sum = torch.zeros(C, dtype=dtype, device=dev)
    n_prop = torch.zeros(C, dtype=torch.int32, device=dev)
    max_de = torch.zeros(C, dtype=dtype, device=dev)
    diverging = torch.zeros(C, dtype=torch.bool, device=dev)
    done = torch.zeros(C, dtype=torch.bool, device=dev)
    k, depth_s = 0, 0

    while not bool(done.all()):
        u = uniform(3, C)
        active = ~done

        # ---- leaf: one leapfrog, every iteration ----
        new_state = step_fn(eps, cur)
        d_energy = new_state.energy - start_energy
        d_energy = torch.where(torch.isnan(d_energy),
                               torch.full_like(d_energy, float('inf')),
                               d_energy)
        div = active & ~(torch.abs(d_energy) < max_change)
        upd = active & (torch.abs(d_energy) > torch.abs(max_de))
        max_de = torch.where(upd, d_energy, max_de)
        accept = torch.clamp(torch.exp(-d_energy), max=1.0)
        ok_merge = active & ~div
        accept_sum = accept_sum + torch.where(ok_merge, accept,
                                              torch.zeros_like(accept))
        n_prop = n_prop + active.to(torch.int32)
        cur = _bwhere(ok_merge, new_state, cur)
        diverging = diverging | div

        # ---- binary-counter merges: the first fused against the leaf,
        # deeper ones (two or more trailing 1-bits) against older frames
        pending = _trailing_ones(k)
        if pending > 0:
            t1 = stack[0]
            merged, mturn = _merge_leaf(u[0], L, vel_fn, t1, new_state,
                                        d_energy, prop_of)
            inc = _cwhere(ok_merge, merged, t1)
            turned = ok_merge & mturn
            for m in range(1, pending):
                merged, mturn = _merge_b(uniform(C), L, vel_fn, stack[m],
                                         inc, m + 1)
                ok = ok_merge & ~turned
                inc = _cwhere(ok, merged, inc)
                turned = turned | (ok & mturn)
        else:
            inc = L.leaf(new_state, d_energy, prop_of)
            turned = torch.zeros_like(done)

        abort = div | turned
        k += 1
        sub_done = k == 1 << depth_s
        # push the frame at its level (the merges performed); a finished
        # subtree's frame goes to the sink level
        stack[n_lvl if sub_done else pending] = inc

        # ---- subtree completion: main-tree doubling bookkeeping ----
        depth = depth + (active & (abort | sub_done)).to(torch.int32)
        if sub_done:
            ok = active & ~abort
            sub_ls = inc[:, L.i_log_size]
            take = ok & (torch.log(u[1]) < sub_ls - log_size)
            prop = _cwhere(take, inc[:, L.sl_prop], prop)
            log_size = torch.where(ok, torch.logaddexp(log_size, sub_ls),
                                   log_size)
            sub_p_sum = inc[:, L.sl_p_sum]
            p_sum_new = p_sum + sub_p_sum
            # spatial ends: the subtree's integration-order end is cur
            new_left = _bwhere(go_right, left, cur)
            new_right = _bwhere(go_right, cur, right)
            # main-tree U-turn checks, halves in spatial order
            g = go_right[:, None]
            inc_left_p = inc[:, L.sl_left_p]
            inc_left_v = vel_fn(inc_left_p)
            lm_psum = torch.where(g, p_sum, sub_p_sum)
            rm_psum = torch.where(g, sub_p_sum, p_sum)
            lm_begin_v = torch.where(g, left.v, cur.v)
            lm_end_p = torch.where(g, right.p, inc_left_p)
            lm_end_v = torch.where(g, right.v, inc_left_v)
            rm_begin_p = torch.where(g, inc_left_p, left.p)
            rm_begin_v = torch.where(g, inc_left_v, left.v)
            rm_end_v = torch.where(g, cur.v, right.v)
            p_sum1 = lm_psum + rm_begin_p
            p_sum2 = lm_end_p + rm_psum
            turning_full = ((_dot(p_sum_new, new_left.v) <= 0)
                            | (_dot(p_sum_new, new_right.v) <= 0)
                            | (_dot(p_sum1, lm_begin_v) <= 0)
                            | (_dot(p_sum1, rm_begin_v) <= 0)
                            | (_dot(p_sum2, lm_end_v) <= 0)
                            | (_dot(p_sum2, rm_end_v) <= 0))
            left = _bwhere(ok, new_left, left)
            right = _bwhere(ok, new_right, right)
            p_sum = _cwhere(ok, p_sum_new, p_sum)
            finished = (active & abort) | (ok & (turning_full
                                                 | (depth >= max_treedepth)))
            # start the next doubling for chains that go on
            start_next = ok & ~finished
            gr_new = u[2] < 0.5
            go_right = torch.where(start_next, gr_new, go_right)
            eps = torch.where(start_next,
                              torch.where(gr_new, step_size, -step_size), eps)
            cur = _bwhere(start_next, _bwhere(gr_new, right, left), cur)
            k, depth_s = 0, depth_s + 1
        else:
            finished = active & abort
        done = done | finished

    return dict(prop=L.unflat_prop(prop), depth=depth, n_prop=n_prop,
                accept_sum=accept_sum, max_de=max_de, diverging=diverging)


def nuts_transition_batched(generator, q0, metric, step_size, logp_and_grad,
                            max_treedepth, max_change):
    """One NUTS transition for all chains on the tree loop
    (``nuts.py:535-574``). ``q0`` is (C, D); the metric's leaves may carry
    a leading chain axis or be shared (pooled); ``step_size`` is (C,) or a
    scalar; ``logp_and_grad`` maps (C, D) -> ((C,), (C, D)). Momenta and
    every in-tree draw come from ``generator``. Returns ``(q_new (C, D),
    NutsStats)``. Each call adds one to ``transitions``, the count of
    tree-loop transitions (no kernel runs here)."""
    nuts_transition_batched.transitions += 1
    C, D = q0.shape
    dtype = q0.dtype
    p0 = sample_momentum_b(metric, generator, (C, D), dtype)
    metric_t = _metric_t(metric)
    vel_fn = _make_vel_fn(metric_t)
    start = compute_state_t(metric_t, logp_and_grad, q0, p0)
    step_size = torch.as_tensor(step_size, dtype=dtype,
                                device=q0.device).expand(C)
    out = nuts_core_batched(
        generator, start, lambda eps, s: leapfrog_t(metric_t, logp_and_grad,
                                                    eps, s),
        lambda s: (s.q, s.energy, s.logp), step_size, max_treedepth,
        max_change, vel_fn)
    q, energy, logp = out['prop']
    n_prop = torch.clamp(out['n_prop'], min=1).to(dtype)
    stats = NutsStats(
        logp=logp, energy=energy, tree_depth=out['depth'],
        tree_size=out['n_prop'], mean_tree_accept=out['accept_sum'] / n_prop,
        energy_change=energy - start.energy,
        max_energy_change=out['max_de'], diverging=out['diverging'])
    return q, stats


nuts_transition_batched.transitions = 0
