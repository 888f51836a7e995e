"""NUTS transitions: hand-written CUDA kernels and their plain torch
versions.

Counterpart of ``bayesfast_tpu/samplers/nuts_pallas.py``. Three entry
points, each one kernel launch for every chain:

* ``nuts_transition_batched``: one transition under the bare seed, the
  per-transition path (``ChainDriver.run``); replaces
  ``_nuts_block_kernel`` (``nuts_pallas.py:431``);
* ``nuts_chunk_batched``: ``n_steps`` (K) transitions with frozen step size
  and metric (post-warmup); replaces ``_nuts_multi_kernel``
  (``nuts_pallas.py:462``);
* ``nuts_warmup_chunk_batched``: K transitions plus per-transition dual
  averaging and windowed diag-Welford adaptation; replaces
  ``_nuts_warmup_kernel`` (``nuts_pallas.py:746``).

A wrapper given CUDA tensors launches its kernel (``csrc/nuts.cu``, built at
first use by ``_build.py``) and counts the launch in its ``launches``
attribute; given CPU tensors it runs the plain torch version beside it
(``nuts_block_plain``, ``nuts_chunk_plain``, ``nuts_warmup_chunk_plain``),
unless asked for ``kernel='cuda'``, which then raises. ``kernel='torch'``
asks for the plain version on any device. There is no fallback:
a density without ``kernel_spec()`` on a CUDA tensor raises
``NotImplementedError``, and a failed build or launch raises. A density
traced from a user's torch logp (``ops/trace.py``, spec ``'traced'``)
launches the same kernels compiled with its generated functor
(``ops/codegen.py``, built per program and dtype by
``_build.load_traced``); its plain versions run the program's
interpreter. The kernels hold a chain in a warp, lane ``l`` holding
dimensions ``l, l + 32, ...``: up to eight a lane, D <= 256. The
compiled-in densities are in ``csrc/nuts.cu``'s library at D <= 64 (NE =
1, 2); at D 65..256 each (density, NE, dtype) is a unit of its own
(``wide_unit_source``; the PolyGaussian surrogate's a (NE, dtype, path),
``poly_unit_source``), built at first use like a traced one.
``kernel_refusal`` says why a density cannot take the kernels at a
dimension; ``ChainDriver.uses_kernels`` routes by it.

Randomness is the JAX package's counter RNG, reproduced bit for bit:
``_fmix32``/``_uniforms`` (murmur3 finalizer over golden-ratio-spread
counters, ``nuts_pallas.py:54-88``) and Box-Muller momenta
(``:418-428``), keyed by (seed, global iteration, salt, row, global chain
index). Uniforms are float32 from the ``(x >> 9) | 0x3F800000`` bit trick
in every run dtype, ``log(u)`` is taken in float32 and compared in the run
dtype, and Box-Muller runs in float32, all as in the JAX kernels. torch on
the CPU has no ``>>`` for uint32, so the plain versions carry the uint32
values in int64 and multiply in 16-bit halves (``_mul32``), which keeps
every product below 2^49.

Layouts follow the JAX package's public functions: ``q`` is (C, D), chunk
outputs are (K, C, D) and (K, C).
"""

import ctypes
import functools
import math
import weakref

import numpy as np
import torch

from ..config import get_dtype
from ..ops.densities import (DENSITY_IDS, RotatedBanana, spec_logp_and_grad,
                             warp_sum)
from .metrics import DiagMetricState
from .nuts import NutsStats, _kahan_add

__all__ = ['nuts_transition_batched', 'nuts_chunk_batched',
           'nuts_warmup_chunk_batched', 'nuts_block_plain', 'nuts_chunk_plain',
           'nuts_warmup_chunk_plain', 'plain_lpg', 'kernel_refusal',
           'wide_unit_source', 'poly_unit_source']

_M32 = 0xFFFFFFFF
# float32(2 pi), the Box-Muller angle constant as the float32 kernels use it
_TWO_PI_F32 = float(np.float32(2.0 * np.pi))


# ---------------------------------------------------------------------------
# The counter RNG (ints or int64 tensors holding uint32 values)

def _mul32(x, c):
    """``(x * c) mod 2^32`` without int64 overflow: ``c`` in 16-bit
    halves."""
    c = int(c) & _M32
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(x):
    """murmur3 finalizer: full-avalanche bijection on uint32."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def _uniforms(seed, it, salt, rows, lane):
    """Counter-based float32 uniforms in [0, 1), shape (C, rows).

    ``lane`` is the (C,) int64 tensor of GLOBAL chain indices (uint32
    values); ``it`` may be negative (it wraps, as the JAX int32->uint32 cast
    does); row ``r`` of the JAX (rows, C) draw is column ``r`` here.
    """
    return _uniforms_mixed(seed, it, salt, _row_mix(rows, lane.device),
                           _mul32(lane, 0x9E3779B9))


@functools.lru_cache(maxsize=None)
def _row_mix(rows, device):
    """The rows' term of the counter, ``row * 0x7FEB352D`` mod 2^32."""
    return _mul32(torch.arange(rows, dtype=torch.int64, device=device),
                  0x7FEB352D)


def _uniforms_mixed(seed, it, salt, row_mix, lane_mix):
    """``_uniforms`` from the rows' and the lanes' terms of the counter
    (``_row_mix``, ``lane * 0x9E3779B9``), which a transition computes
    once for all its draws; ``it`` an int, or an int64 tensor (n,) of
    iterations for all their draws at once, (n, C, rows)."""
    if torch.is_tensor(it):
        it_mix = _mul32(it & _M32, 0x85EBCA77)[:, None, None]
    else:
        it_mix = _mul32(int(it) & _M32, 0x85EBCA77)
    base = ((int(seed) & _M32) ^ it_mix
            ^ _mul32(int(salt) & _M32, 0xC2B2AE3D))
    x = (lane_mix[:, None] ^ row_mix[None, :]) ^ base
    x = _fmix32((_fmix32(x) + 0x165667B1) & _M32)
    bits = ((x >> 9) | 0x3F800000).to(torch.int32)
    return bits.view(torch.float32) - 1.0


def _gauss_from_uniforms(seed, counter, salt, rows, lane):
    """float32 Box-Muller standard normals from the uniform stream, (C,
    rows); ``1 - u`` keeps the log argument in (0, 1]."""
    u1 = _uniforms(seed, counter, salt, rows, lane)
    u2 = _uniforms(seed, counter, salt + 1, rows, lane)
    r = torch.sqrt(-2.0 * torch.log(1.0 - u1))
    return r * torch.cos(_TWO_PI_F32 * u2)


def _transition_seed(seed, i0, t):
    """Per-transition stream key ``seed ^ fmix32(i0 + t + 0x9E3779B9)``:
    keyed by the global iteration, so chunk boundaries never change it."""
    return (int(seed) & _M32) ^ _fmix32((int(i0) + int(t) + 0x9E3779B9)
                                        & _M32)


# ---------------------------------------------------------------------------
# Host-side schedules

def _leaf_schedule(it, max_treedepth):
    """The tree schedule of global leaf ``it``: ``(pending, sub_done,
    w_idx, depth_s)``, the row the JAX kernels read from their
    ``_schedule_table``, computed from the leaf index as ``csrc/nuts.cu``
    computes it in registers. Leaf ``k`` of doubling ``depth_s`` merges
    ``pending`` = (trailing ones of ``k``) stack frames, completes its
    subtree when it is the doubling's last leaf, and otherwise leaves its
    frame at level ``w_idx`` = ``pending``."""
    depth_s = (it + 1).bit_length() - 1
    k = it + 1 - (1 << depth_s)
    pending = (k ^ (k + 1)).bit_length() - 1
    sub_done = k == (1 << depth_s) - 1
    w_idx = max(int(max_treedepth) - 1, 1) if sub_done else pending
    return pending, sub_done, w_idx, depth_s


@functools.lru_cache(maxsize=None)
def _window_schedule(n_samples0, prev_update0, adapt_window0, n_steps,
                     update_window, doubling):
    """Host simulation of the Welford window schedule for a warmup chunk:
    per-step [do_refresh, do_switch] flags (the same for every chain), plus
    the final (n_samples, prev_update, adapt_window) ints."""
    flags = np.zeros((2, n_steps), np.int32)
    ns, pu, aw = int(n_samples0), int(prev_update0), int(adapt_window0)
    for t in range(n_steps):
        delta = ns - pu
        flags[0, t] = int(((delta + 1) % update_window) == 0)
        do_switch = delta >= aw
        flags[1, t] = int(do_switch)
        if do_switch:
            pu = ns
            aw = aw * 2 if doubling else aw
        ns += 1
    return flags, (ns, pu, aw)


# ---------------------------------------------------------------------------
# Plain torch versions: every chain in lockstep with masks, as the JAX
# kernel runs a block of lanes

def _logaddexp(a, b):
    """``jnp.logaddexp``'s formula (NaN delta: same-sign infinities)."""
    amax = torch.maximum(a, b)
    delta = a - b
    return torch.where(torch.isnan(delta), a + b,
                       amax + torch.log1p(torch.exp(-torch.abs(delta))))


def _sel(mask, new, old):
    """Select over a list of (C, ...) tensors with a (C,) mask."""
    return [torch.where(mask.view((-1,) + (1,) * (n.dim() - 1)), n, o)
            for n, o in zip(new, old)]


def _dot(a, b):
    # summed in the kernels' warp order, so that the plain version rounds
    # as the kernels do
    return warp_sum(a * b)


def _turns(pairs):
    """Whether any of the dot products of ``pairs`` ((a, b) tensors of one
    shape) is <= 0: each product as ``_dot`` takes it, their warp sums in
    one call over the stacked products (the same bits, fewer launches)."""
    return (warp_sum(torch.stack([a * b for a, b in pairs])) <= 0).any(0)


def _merge(u, t1, t2, merged_depth, var, D):
    """Join older/left frame ``t1`` with newer/right frame ``t2`` (both
    (C, 4D+3): [left_p | right_p | p_sum | log_size | q | energy | logp]);
    multinomial take by log-size, generalized U-turn check with the extra
    inner-subtree checks above merged depth 1."""
    ps1, ps2 = t1[:, 2 * D:3 * D], t2[:, 2 * D:3 * D]
    p_sum = ps1 + ps2
    v1l, v2r = var * t1[:, :D], var * t2[:, D:2 * D]
    pairs = [(p_sum, v1l), (p_sum, v2r)]
    if merged_depth > 1:
        p_sum1 = ps1 + t2[:, :D]
        p_sum2 = t1[:, D:2 * D] + ps2
        v1r, v2l = var * t1[:, D:2 * D], var * t2[:, :D]
        pairs += [(p_sum1, v1l), (p_sum1, v2l), (p_sum2, v1r),
                  (p_sum2, v2r)]
    turning = _turns(pairs)
    ls1, ls2 = t1[:, 3 * D], t2[:, 3 * D]
    log_size = _logaddexp(ls1, ls2)
    take2 = torch.log(u).to(t1.dtype) < ls2 - log_size
    tail = torch.where(take2[:, None], t2[:, 3 * D + 1:], t1[:, 3 * D + 1:])
    merged = torch.cat([t1[:, :D], t2[:, D:2 * D], p_sum, log_size[:, None],
                        tail], dim=-1)
    return merged, turning


def _transition_core_plain(seed, q0, p0, step, var, lpg, lane,
                           max_treedepth, max_change):
    """One full NUTS transition for every chain (the plain version of the
    kernels' ``transition``; ``nuts_pallas.py:120-415``). Returns
    ``(q_prop, energy, logp, d_energy, depth, tree_size, accept_sum,
    max_de, diverging)``."""
    C, D = q0.shape
    dtype, dev = q0.dtype, q0.device
    n_lvl = max(int(max_treedepth) - 1, 1)
    lane_mix = _mul32(lane, 0x9E3779B9)

    def uniforms(it, salt, rows):
        return _uniforms_mixed(seed, it, salt, _row_mix(rows, dev), lane_mix)

    def energy_of(p, lp):
        return 0.5 * _dot(p, var * p) - lp

    logp0, grad0 = lpg(q0)
    e0 = energy_of(p0, logp0)
    zero_v = torch.zeros_like(q0)
    cur = [q0, p0, grad0, zero_v, zero_v, e0, logp0]
    left, right = list(cur), list(cur)
    prop = torch.cat([q0, e0[:, None], logp0[:, None]], dim=-1)
    p_sum = p0
    log_size = torch.zeros(C, dtype=dtype, device=dev)
    depth = torch.zeros(C, dtype=torch.int32, device=dev)
    go_right = uniforms(-1, 7, 1)[:, 0] < 0.5
    eps = torch.where(go_right, step, -step)
    accept_sum = torch.zeros(C, dtype=dtype, device=dev)
    n_prop = torch.zeros(C, dtype=torch.int32, device=dev)
    max_de = torch.zeros(C, dtype=dtype, device=dev)
    diverging = torch.zeros(C, dtype=torch.bool, device=dev)
    done = torch.zeros(C, dtype=torch.bool, device=dev)
    stack = torch.zeros((n_lvl + 1, C, 4 * D + 3), dtype=dtype, device=dev)

    it = 0
    while not bool(done.all()):
        if it & (it + 1) == 0:
            # a doubling starts (leaf 2^d - 1): the uniforms of its 2^d
            # leaves in one call
            u_start = it
            u_block = uniforms(torch.arange(it, 2 * it + 1, device=dev),
                               0, 3)
        u = u_block[it - u_start]
        u0, u1, u2 = u[:, 0], u[:, 1], u[:, 2]
        active = ~done

        # one Kahan-compensated leapfrog, every iteration
        e_ = eps[:, None]
        dt = 0.5 * e_
        p_half, cp = _kahan_add(cur[1], cur[4], dt * cur[2])
        nq, cq = _kahan_add(cur[0], cur[3], e_ * (var * p_half))
        nlp, ng = lpg(nq)
        npm, cp = _kahan_add(p_half, cp, dt * ng)
        ne = energy_of(npm, nlp)
        d_energy = ne - e0
        d_energy = torch.where(torch.isnan(d_energy),
                               torch.full_like(d_energy, math.inf), d_energy)
        div = active & ~(torch.abs(d_energy) < max_change)
        upd = active & (torch.abs(d_energy) > torch.abs(max_de))
        max_de = torch.where(upd, d_energy, max_de)
        accept = torch.clamp(torch.exp(-d_energy), max=1.0)
        ok_merge = active & ~div
        accept_sum = accept_sum + torch.where(ok_merge, accept,
                                              torch.zeros_like(accept))
        n_prop = n_prop + active.to(torch.int32)
        cur = _sel(ok_merge, [nq, npm, ng, cq, cp, ne, nlp], cur)
        diverging = diverging | div

        pending, sub_done, w_idx, _ = _leaf_schedule(it, max_treedepth)

        # binary-counter merges
        leaf = torch.cat([npm, npm, npm, -d_energy[:, None], nq,
                          ne[:, None], nlp[:, None]], dim=-1)
        if pending > 0:
            t1 = stack[0]
            merged, mturn = _merge(u0, t1, leaf, 1, var, D)
            inc = torch.where(ok_merge[:, None], merged, t1)
            turned = ok_merge & mturn
            for m in range(1, pending):
                um = uniforms(it * (int(max_treedepth) + 1) + m, 3, 1)[:, 0]
                merged, mturn = _merge(um, stack[m], inc, m + 1, var, D)
                ok = ok_merge & ~turned
                inc = torch.where(ok[:, None], merged, inc)
                turned = turned | (ok & mturn)
            turning_sub = turned
        else:
            inc = leaf
            turning_sub = torch.zeros_like(done)

        abort = div | turning_sub
        stack[w_idx] = inc
        # depth counts completed doublings plus the aborted extension
        depth = depth + (active & (abort | sub_done)).to(torch.int32)
        done = done | (active & abort)

        # subtree completion: once per doubling
        if sub_done:
            ok = active & ~abort
            sub_ls = inc[:, 3 * D]
            take = ok & (torch.log(u1).to(dtype) < sub_ls - log_size)
            prop = torch.where(take[:, None], inc[:, 3 * D + 1:], prop)
            log_size = torch.where(ok, _logaddexp(log_size, sub_ls),
                                   log_size)
            sub_p_sum = inc[:, 2 * D:3 * D]
            p_sum_new = p_sum + sub_p_sum
            new_left = _sel(go_right, left, cur)
            new_right = _sel(go_right, cur, right)

            # main-tree U-turn checks (halves in spatial order)
            g = go_right[:, None]
            inc_left_p = inc[:, :D]
            inc_left_v = var * inc_left_p
            left_v, right_v, cur_v = var * left[1], var * right[1], \
                var * cur[1]
            lm_psum = torch.where(g, p_sum, sub_p_sum)
            rm_psum = torch.where(g, sub_p_sum, p_sum)
            lm_begin_v = torch.where(g, left_v, cur_v)
            lm_end_p = torch.where(g, right[1], inc_left_p)
            lm_end_v = torch.where(g, right_v, inc_left_v)
            rm_begin_p = torch.where(g, inc_left_p, left[1])
            rm_begin_v = torch.where(g, inc_left_v, left_v)
            rm_end_v = torch.where(g, cur_v, right_v)
            p_sum1 = lm_psum + rm_begin_p
            p_sum2 = lm_end_p + rm_psum
            turning_full = _turns([
                (p_sum_new, var * new_left[1]),
                (p_sum_new, var * new_right[1]), (p_sum1, lm_begin_v),
                (p_sum1, rm_begin_v), (p_sum2, lm_end_v),
                (p_sum2, rm_end_v)])

            left = _sel(ok, new_left, left)
            right = _sel(ok, new_right, right)
            p_sum = torch.where(ok[:, None], p_sum_new, p_sum)
            finished = ok & (turning_full | (depth >= max_treedepth))
            done = done | finished

            start_next = ok & ~finished
            gr_new = u2 < 0.5
            go_right = torch.where(start_next, gr_new, go_right)
            eps = torch.where(start_next, torch.where(gr_new, step, -step),
                              eps)
            cur = _sel(start_next, _sel(gr_new, right, left), cur)
        it += 1

    q_prop, en, lp = prop[:, :D], prop[:, D], prop[:, D + 1]
    return (q_prop, en, lp, en - e0, depth, n_prop, accept_sum, max_de,
            diverging.to(torch.int32))


_ROW_NAMES = ('q', 'energy', 'logp', 'energy_change', 'tree_depth',
              'tree_size', 'accept_sum', 'max_de', 'diverging')


def _lanes(C, chain_start, device):
    return (torch.arange(C, dtype=torch.int64, device=device)
            + int(chain_start)) & _M32


def nuts_block_plain(seed, q0, var, step, max_treedepth, max_change, lpg,
                     chain_start=0):
    """Plain torch version of the block kernel: one transition with momenta
    ``gauss(seed, it=-9, salt=16)`` and every tree draw under the bare
    ``seed`` (``nuts_pallas.py:438-446``). ``var`` (C, D), ``step`` (C,).
    Returns a dict of (C, D) / (C,) rows."""
    C, D = q0.shape
    lane = _lanes(C, chain_start, q0.device)
    p0 = _gauss_from_uniforms(seed, -9, 16, D, lane).to(q0.dtype) \
        / torch.sqrt(var)
    return dict(zip(_ROW_NAMES, _transition_core_plain(
        seed, q0, p0, step, var, lpg, lane, max_treedepth, max_change)))


def nuts_chunk_plain(seed, q0, var, step, n_steps, max_treedepth,
                     max_change, lpg, i0=0, chain_start=0):
    """Plain torch version of the frozen chunk kernel: ``n_steps`` block
    transitions, transition ``t`` under ``seed ^ fmix32(i0 + t +
    0x9E3779B9)``. ``var`` (C, D), ``step`` (C,). Returns a dict of rows
    (K, C, D) / (K, C) plus ``q_final`` (C, D)."""
    rows = {k: [] for k in _ROW_NAMES}
    q = q0
    for t in range(int(n_steps)):
        out = nuts_block_plain(_transition_seed(seed, i0, t), q, var, step,
                               max_treedepth, max_change, lpg, chain_start)
        for k in _ROW_NAMES:
            rows[k].append(out[k])
        q = out['q']
    res = {k: torch.stack(v) for k, v in rows.items()}
    res['q_final'] = q
    return res


_FINAL_NAMES = ('log_step', 'log_bar', 'hbar', 'count', 'var', 'fg_mean',
                'fg_raw', 'fg_w', 'bg_mean', 'bg_raw', 'bg_w')


def nuts_warmup_chunk_plain(seed, q0, step_leaves, metric_leaves, n_steps,
                            max_treedepth, max_change, target, gamma, k_exp,
                            t_0, adapt_step, adapt_metric, wsched, lpg,
                            i0=0, chain_start=0):
    """Plain torch version of the warmup chunk kernel: the frozen chunk's
    transitions plus per-transition dual averaging (``count^-k`` as
    ``exp(-k log count)``) and windowed diag Welford with the
    ``(raw + 5e-3) / (w + 5)`` refresh, the window flags read from the host
    table ``wsched`` (2, K).

    ``step_leaves`` = (log_step, log_bar, hbar, count, mu), each (C,);
    ``metric_leaves`` = (var, fg_mean, fg_raw, fg_w, bg_mean, bg_raw,
    bg_w), (C, D) or (C,). Returns the rows (plus ``step_size`` and
    ``step_size_bar``), ``q_final`` and the final adaptation state."""
    dtype = q0.dtype
    log_step, log_bar, hbar, count, mu = step_leaves
    var, fgm, fgr, fgw, bgm, bgr, bgw = metric_leaves
    wsched = np.asarray(wsched)
    # a tensor divisor: torch on the card divides by a Python scalar as a
    # multiplication by its reciprocal, the kernel divides
    gamma_t = torch.as_tensor(gamma, dtype=dtype, device=q0.device)
    rows = {k: [] for k in _ROW_NAMES + ('step_size', 'step_size_bar')}
    q = q0
    for t in range(int(n_steps)):
        out = nuts_block_plain(_transition_seed(seed, i0, t), q, var,
                               torch.exp(log_step), max_treedepth,
                               max_change, lpg, chain_start)
        q_prop, size, asum = out['q'], out['tree_size'], out['accept_sum']
        accept = asum / torch.clamp(size.to(dtype), min=1.0)
        if adapt_step:
            w = 1.0 / (count + t_0)
            hbar = (1.0 - w) * hbar + w * (target - accept)
            log_step = mu - hbar * torch.sqrt(count) / gamma_t
            mk = torch.exp(-k_exp * torch.log(count))
            log_bar = mk * log_step + (1.0 - mk) * log_bar
            count = count + 1.0
        if adapt_metric:
            n_f = fgw + 1.0
            od = q_prop - fgm
            fgm = fgm + od / n_f[:, None]
            fgr = fgr + od * (q_prop - fgm)
            fgw = n_f
            n_b = bgw + 1.0
            od_b = q_prop - bgm
            bgm = bgm + od_b / n_b[:, None]
            bgr = bgr + od_b * (q_prop - bgm)
            bgw = n_b
            if wsched[0, t] == 1:
                var = (fgr + 5e-3) / (fgw[:, None] + 5.0)
            if wsched[1, t] == 1:
                fgm, fgr, fgw = bgm, bgr, bgw
                bgm, bgr = torch.zeros_like(bgm), torch.zeros_like(bgr)
                bgw = torch.zeros_like(bgw)
        for k in _ROW_NAMES:
            rows[k].append(out[k])
        # recorded AFTER the update, as in the JAX scan path
        rows['step_size'].append(torch.exp(log_step))
        rows['step_size_bar'].append(torch.exp(log_bar))
        q = q_prop
    res = {k: torch.stack(v) for k, v in rows.items()}
    res['q_final'] = q
    res.update(zip(_FINAL_NAMES, (log_step, log_bar, hbar, count, var, fgm,
                                  fgr, fgw, bgm, bgr, bgw)))
    return res


# ---------------------------------------------------------------------------
# The CUDA kernels

# eight dimensions a lane (csrc/nuts_kernels.cuh kMaxD), for every density
# (a Density plan too: core/pipeline.py); csrc/nuts.cu's own library holds
# NE = 1 and 2, D <= 64, and a unit each wider (density, NE, dtype)
_MAX_D, _LIB_D = 256, 64
# the kinds of nuts_traced_launch (ops/codegen.py)
_KINDS = {'frozen': 0, 'warmup': 1, 'block': 2}
_N_EXTRA = 14  # density scalars past the first two, then the staging plan
# a block's shared memory on sm_90 (csrc/nuts.cu kMaxSmem), and its warps
# (chains)
_MAX_SMEM, _WARPS = 232448, 8
# features a streamed tile of WT, by itemsize (measured, PERF.md)
_TILE = {4: 32, 8: 16}


def _up(n, k):
    return -(-int(n) // k) * k


def _coef_stride(rows, itemsize):
    """Row stride, in elements, of ``rows`` staged coefficients a row
    (``csrc/nuts.cu::coef_stride``): whole 16-byte vectors, one more when
    their count is even; 0 for no rows."""
    n = 16 // itemsize
    v = -(-int(rows) // n)
    return 0 if rows <= 0 else (v + 1 - v % 2) * n


def _poly_layout(D, M, F, NNZ, full, max_treedepth, itemsize, rows,
                 tile=0):
    """A block of a launch with the PolyGaussian density that stages the
    first ``rows`` features of the coefficients WT, as
    ``csrc/nuts_poly.cuh`` lays it out: at D <= 64 (NE <= 2,
    ``PolyGaussian``) the two staged D x D Hessians, the input scales,
    each warp's exchange buffers and the integer tables (three indices a
    feature, the row pointers, three a sparse-row entry); past D = 64
    (``PolyBlock``, ``block``: the block evaluates its chains together;
    the Hessians stay in device memory: ``hess_smem`` False) the scales,
    64 bytes of control words (the chains' work flags, the tile buffers'
    mbarriers), each chain's buffers, whose red buffer holds the
    Hessians' products (2 P) and its warp's back-pass scratch, and the
    integer tables; then those features, transposed (output j's features
    as row j, ``row_stride`` elements); with ``tile`` > 0 (the streamed
    path) two buffers of a tile, ``tile`` of the other features for every
    output, and phi long enough for the last tile's padding; then every
    warp's checkpoint stack if it still fits in a block, else the stacks
    stay in global scratch. Returns a dict (rows, row_stride, stacks_smem,
    bytes), on the streamed path also stream (True), tile and tile_bytes
    (one buffer's), and past D = 64 hess_smem (False) and block (True)."""
    n = 16 // itemsize
    P = 32 * max(1, -(-int(D) // 32))
    # PolyGaussian stages the Hessians; PolyBlock past 64
    hess = P <= _LIB_D
    n_phi = rows + -(-(F - rows) // tile) * tile if tile else F
    # xbuf, xa, phi, gphi, the back pass's scratch (32 lanes x 8 features;
    # PolyBlock: and the Hessians' products), the outputs' gradients, with
    # a full precision r and m0 - f_mu
    red = 32 * 8 if hess else 2 * P
    warp = (P + _up(P + 1, 4) + _up(n_phi, 4) + _up(F, 4) + red
            + (3 if full else 1) * _up(M, 4))
    ints = _up(-(-(3 * F + D + 1 + 3 * NNZ) * 4 // itemsize), 4)
    stride = _coef_stride(rows, itemsize)
    ctl = 0 if hess else 64 // itemsize
    own = (2 * P * (P + n) * hess + 2 * P + ctl + _WARPS * warp + ints
           + M * stride + 2 * M * tile) * itemsize
    stacks = _WARPS * max(int(max_treedepth) - 1, 1) * (4 * D + 3) * itemsize
    stk = own + stacks <= _MAX_SMEM
    plan = dict(rows=int(rows), row_stride=stride, stacks_smem=stk,
                bytes=own + stk * stacks)
    if not hess:
        plan.update(hess_smem=False, block=True)
    if tile:
        plan.update(stream=True, tile=int(tile),
                    tile_bytes=int(M) * int(tile) * itemsize)
    return plan


def poly_smem_plan(D, M, F, NNZ, full, max_treedepth, itemsize, tile=None):
    """The shared-memory plan of a launch with the PolyGaussian density
    (``_poly_layout``): all of WT and the stacks when they fit. Else the
    streamed path when two tiles of ``tile`` features (default
    ``_TILE[itemsize]``; 0: never) fit beside the density's own buffers:
    the tiles read each feature that is not staged once per block and
    leapfrog for the block's eight chains; and as many features staged as
    fit beside them, a whole number of 16-byte vectors. Else each chain
    reads those features from device memory itself, with as many staged.
    The coefficients get the room before the stacks (faster, PERF.md).
    Returns a dict (``_poly_layout``); ``ValueError`` when the density's
    own buffers do not fit."""
    def layout(rows, tile=0):
        return _poly_layout(D, M, F, NNZ, full, max_treedepth, itemsize,
                            rows, tile)

    if layout(0)['bytes'] > _MAX_SMEM:
        raise ValueError(f'the PolyGaussian density takes '
                         f'{layout(0)["bytes"]} bytes of shared memory a '
                         f'block (M = {M}, full precision {bool(full)}), '
                         f'over {_MAX_SMEM}.')
    if layout(F)['bytes'] <= _MAX_SMEM:
        return layout(F)
    n = 16 // itemsize
    top = (F - 1) // n * n
    tile = _TILE[itemsize] if tile is None else int(tile)
    if tile:
        for rows in range(top, -1, -n):
            if layout(rows, tile)['bytes'] <= _MAX_SMEM:
                return layout(rows, tile)
    rows = top
    while rows > 0 and layout(rows)['bytes'] > _MAX_SMEM:
        rows -= n
    return layout(rows)


def _stream_tiles(WT, rows, tile):
    """The streamed path's tiles of the features ``rows``.. of WT (F, M),
    flat, in ``csrc/nuts.cu``'s layout: tile t is features rows + t tile ..
    (zeros past F) transposed, output j's as row j; row j's 16-byte vector
    v (its features 16 / itemsize v ..) at vector v ^ swz(j), where swz(j)
    is j mod 8 for 8 or more vectors a row and (j // (8 / nv)) mod nv for
    nv = 2 or 4 (``PolyGaussian::swl``)."""
    F, M = WT.shape
    n = 16 // WT.element_size()
    nt, nv = -(-(F - rows) // tile), tile // n
    w = WT.new_zeros(nt * tile, M)
    w[:F - rows] = WT[rows:]
    w = w.view(nt, tile, M).transpose(1, 2).reshape(nt, M, nv, n)
    j = torch.arange(M, device=WT.device)
    swz = j % 8 if nv >= 8 else (j // (8 // nv)) % nv
    logical = torch.arange(nv, device=WT.device)[None, :] ^ swz[:, None]
    idx = logical[None, :, :, None].expand(nt, M, nv, n)
    return torch.gather(w, 2, idx).reshape(-1)


def _spec_plan(dens_id, dscal, D, max_treedepth, itemsize):
    """``poly_smem_plan`` of a PolyGaussian launch spec (scalars norm,
    gamma, M, F, NNZ, bound on, decay on, alpha, alpha^2, full), else
    None."""
    if dens_id != DENSITY_IDS['poly_gaussian']:
        return None
    M, F, NNZ = (int(v) for v in dscal[2:5])
    return poly_smem_plan(D, M, F, NNZ, bool(dscal[9]), max_treedepth,
                          itemsize)


def _fargs(max_change, logw, dscal, adapt, plan):
    """The launch's double arguments (``csrc/nuts_kernels.cuh::make_args``
    and ``csrc/nuts_poly.cuh::launch_poly``): max_change, logw, the
    density's first two scalars, target, gamma, k, t_0, the density's other
    scalars from index 8, and after them the plan's features staged, bytes,
    stacks in shared memory, path (1: the streamed tiles), features a tile
    and a tile's bytes (0 and 0 on the other path) (PolyGaussian only; the
    launch fails if the kernel lays the block out otherwise: where the
    Hessians live is in the bytes)."""
    target, gamma, k_exp, t_0 = adapt[:4]
    extra = [float(v) for v in dscal[2:]]
    if plan is not None:
        extra += [float(plan['rows']), float(plan['bytes']),
                  float(plan['stacks_smem']),
                  float(plan.get('stream', False)),
                  float(plan.get('tile', 0)),
                  float(plan.get('tile_bytes', 0))]
    if len(extra) > _N_EXTRA:
        raise ValueError(f'at most {_N_EXTRA + 2} density scalars.')
    return [float(max_change), float(logw), float(dscal[0]), float(dscal[1]),
            float(target), float(gamma), float(k_exp), float(t_0),
            *extra, *[0.0] * (_N_EXTRA - len(extra))]


# launch specs, by density (held weakly), then by (dtype, device):
# (key of the inputs, the inputs, spec, launch spec)
_SPECS = weakref.WeakKeyDictionary()


def _spec_inputs(density):
    """What ``density.kernel_spec()`` is built from. A density with
    ``kernel_spec_key()`` (a ``Density``, whose surrogate is refit in
    place; a ``DensityLite`` over a traced logp) names it by content;
    otherwise: the transform's scales and
    bounds, the compiled-in density's buffers with their in-place versions,
    and its scalar attributes."""
    key_fn = getattr(density, 'kernel_spec_key', None)
    key = key_fn() if key_fn is not None else None
    if key is not None:
        return [], [key]
    inner = density._logp
    bufs = list(inner.buffers()) if isinstance(inner, torch.nn.Module) else []
    scalars = [(k, v) for k, v in sorted(vars(inner).items())
               if isinstance(v, (bool, int, float))]
    return [density.input_scales, density.hard_bounds] + bufs, \
        [t._version for t in bufs] + scalars


def _spec_entry(density, like):
    """The cache entry of ``density`` on ``like``'s dtype and device,
    rebuilt when an input of ``kernel_spec()`` changes (see ``_spec_for``).
    ``NotImplementedError`` for a density without a kernel spec."""
    objs, state = _spec_inputs(density)
    key = (tuple(map(id, objs)), tuple(state))
    entries = _SPECS.setdefault(density, {})
    entry = entries.get((like.dtype, like.device))
    if entry is not None and entry[0] == key:
        return entry
    if not getattr(density, 'has_kernel_spec', False):
        raise NotImplementedError(
            'the CUDA NUTS kernels need a density with kernel_spec() '
            '(ops/densities.py, a logp or a Density plan that traces into '
            'the op set of ops/trace.py, or a Density whose plan is a '
            'PolyModel and a Gaussian, compiled in); sample it on the tree '
            "loop (nuts_kernel='auto' or 'torch').")
    spec = density.kernel_spec()
    # the last slot keeps the streamed path's parameters
    # (``_stream_params``)
    entry = (key, objs, spec, _launch_spec(spec, like), {})
    entries[like.dtype, like.device] = entry
    return entry


def _spec_for(density, like):
    """The density's kernel spec on ``like``'s dtype and device, as the
    launch takes it: ``(density id, transform rows (5, D), parameters,
    logw, scalars)``. It is built once and kept (``_SPECS``) until the
    dtype or device, or what ``kernel_spec()`` is built from, changes: for
    a ``Density`` its content (``kernel_spec_key``), so every refit of its
    surrogate is seen; otherwise the identity of an input or its in-place
    version, or a scalar attribute of the density. A launch then copies
    nothing from the host. The entry holds those inputs, so their
    identities are not reused while it lives. An array of a ``DensityLite``
    mutated in place (the scales or bounds) is not seen: set
    ``input_scales`` or ``hard_bounds`` anew. ``NotImplementedError`` for a
    density without a kernel spec."""
    spec = _spec_entry(density, like)[3]
    if spec[1].shape[1] != like.shape[1]:
        raise ValueError(f'the density has dimension {spec[1].shape[1]}, '
                         f'the chains {like.shape[1]}.')
    return spec


def _banana_smem(dim, itemsize):
    """Shared memory of a block of the compiled-in banana at D = ``dim``
    (``csrc/nuts_densities.cuh::Banana``): A and A^T zero-padded to P =
    32 NE rows of ``row_stride`` = P + 16 / itemsize, and each warp's P x
    values."""
    P = 32 * max(1, -(-int(dim) // 32))
    return (2 * P * (P + 16 // itemsize) + _WARPS * P) * itemsize


def kernel_refusal(density, dim, dtype=None):
    """Why the CUDA NUTS kernels cannot sample ``density`` at dimension
    ``dim`` in ``dtype`` (default: the configured one) (a string), or
    None when they can: a kernel spec (a compiled-in density, the
    compiled-in PolyModel -> Gaussian plan, or a logp or a ``Density``
    plan that traces into the kernels' op set) and ``dim`` <= ``_MAX_D``
    for every kind of density, as a lane holds at most eight dimensions
    (a ``Density`` past it says so in its own words, as its plan has no
    spec there). A ``DensityLite`` with the user's gradient has a spec
    when the pair traces, whatever its logp: the kernels then run the
    user's gradient. For the compiled-in banana, its A and
    A^T within a block's shared memory (D <= 160 in float32, 96 in
    float64). The plain versions could run either way; the routing
    (``ChainDriver.uses_kernels``) asks this first."""
    if not getattr(density, 'has_kernel_spec', False):
        why = getattr(density, 'kernel_trace_error', lambda: None)()
        return ('the density has no kernel_spec()' +
                (f': {why}' if why else
                 ' (ops/densities.py, a logp or a Density plan that traces '
                 'into the op set of ops/trace.py, or a Density whose plan '
                 'is a PolyModel and a Gaussian)'))
    dim = int(dim)
    if dim > _MAX_D:
        return (f'the CUDA NUTS kernels take D <= {_MAX_D} (eight '
                f'dimensions a lane), got {dim}')
    if (isinstance(getattr(density, '_logp', None), RotatedBanana)
            and not density.has_traced_spec):
        itemsize = torch.finfo(dtype or get_dtype()).bits // 8
        need = _banana_smem(dim, itemsize)
        if need > _MAX_SMEM:
            return (f'the compiled-in banana stages A and A^T in shared '
                    f'memory: {need} bytes a block at D = {dim} in '
                    f'float{8 * itemsize}, past the {_MAX_SMEM} it has')
    return None


# the compiled-in densities of csrc/nuts_densities.cuh, by id
_UNIT_DENSITIES = {DENSITY_IDS[k]: k for k in ('banana', 'gaussian', 'funnel',
                                              'ring', 'cauchy')}


@functools.lru_cache(maxsize=None)
def wide_unit_source(dens_id, dim, dtype):
    """The translation unit of the compiled-in density ``dens_id`` at D =
    ``dim`` (65..256) in ``dtype``: the three kernels at lane width NE =
    ceil(D / 32) (``csrc/nuts_densities.cuh::launch_unit``), behind the
    entry point of a traced unit (``nuts_traced_launch``), so that
    ``_build.load_traced`` builds it at first use and ``_launch`` calls it
    as it calls a traced one. ``ValueError`` for another density or
    D."""
    if dens_id not in _UNIT_DENSITIES or not _LIB_D < int(dim) <= _MAX_D:
        raise ValueError(f'no unit of density {dens_id} at D = {dim}: the '
                         f'compiled-in banana, gaussian, funnel, ring and '
                         f'cauchy at D {_LIB_D + 1}..{_MAX_D}.')
    return _unit_source(f'The compiled-in {_UNIT_DENSITIES[dens_id]} '
                        f'density', 'nuts_densities.cuh', 'launch_unit',
                        'wide_unit_source', dim, dtype, str(dens_id))


@functools.lru_cache(maxsize=None)
def poly_unit_source(dim, dtype, stream):
    """The translation unit of the PolyGaussian surrogate at D = ``dim``
    (65..256) in ``dtype`` on the streamed path or not (``stream``, the
    plan's): the three kernels at lane width NE = ceil(D / 32) with the
    block-wide functor ``PolyBlock`` (``csrc/nuts_poly.cuh::
    launch_poly_unit``), built and called as ``wide_unit_source``'s are.
    ``ValueError`` for another D."""
    if not _LIB_D < int(dim) <= _MAX_D:
        raise ValueError(f'no PolyGaussian unit at D = {dim}: D '
                         f'{_LIB_D + 1}..{_MAX_D} (csrc/nuts.cu holds D <= '
                         f'{_LIB_D}).')
    return _unit_source('The PolyGaussian surrogate, evaluated by the whole '
                        'block for its\n// chains (PolyBlock),',
                        'nuts_poly.cuh', 'launch_poly_unit',
                        'poly_unit_source', dim, dtype,
                        'true' if stream else 'false')


def _unit_source(what, header, launch, writer, dim, dtype, arg):
    """A unit exporting ``nuts_traced_launch`` (the entry point of a traced
    unit, ``ops/codegen.py``) as ``launch<real, NE, arg>`` of ``header``."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f'unsupported dtype {dtype}.')
    ne = -(-int(dim) // 32)
    real = 'double' if dtype == torch.float64 else 'float'
    return f'''// {what} of the CUDA NUTS kernels at NE = {ne}
// (D {32 * ne - 31}..{32 * ne}), {real}: {launch} of
// csrc/{header}.
// Written by bayesfast_tpu_torch/samplers/nuts_cuda.py::{writer};
// built and loaded by bayesfast_tpu_torch/_build.py.

#include "{header}"

extern "C" int nuts_traced_launch(int kind, int f64, int C, int D, int K,
                                  int maxdepth, unsigned seed, unsigned i0,
                                  unsigned chain_start, int adapt_step,
                                  int adapt_metric, const double* fargs,
                                  void* const* ptrs, int n_ptrs,
                                  void* stream) {{
  return (int){launch}<{real}, {ne}, {arg}>(
      kind, f64, C, D, K, maxdepth, seed, i0, chain_start, adapt_step,
      adapt_metric, fargs, ptrs, n_ptrs, stream);
}}

extern "C" const char* nuts_traced_error_string(int err) {{
  return cudaGetErrorString((cudaError_t)err);
}}
'''


def _stream_params(density, like, plan):
    """The packed parameters of a launch on the streamed path: the launch
    spec's, then zeros to a multiple of 32 elements, then the tiles
    (``_stream_tiles``), where ``PolyGaussian::locate`` finds them. Kept
    with the spec for the last plan asked for."""
    entry = _spec_entry(density, like)
    key = (plan['rows'], plan['tile'])
    if key not in entry[4]:
        dpar, dscal = entry[3][2], entry[3][4]
        M, F = int(dscal[2]), int(dscal[3])
        tiles = _stream_tiles(dpar[:F * M].view(F, M), plan['rows'],
                              plan['tile'])
        entry[4].clear()
        entry[4][key] = torch.cat([dpar, dpar.new_zeros(
            _up(dpar.numel(), 32) - dpar.numel()), tiles])
    return entry[4][key]


def _launch_spec(spec, like):
    """(density id, transform rows, packed parameters on ``like``'s dtype
    and device, logw, scalars); a traced spec's parameters are its
    program's packed constants (``ops.codegen.launch_params``)."""
    tf = spec['transform']
    tf_mat = torch.stack([tf[k].to(like) for k in
                          ('lo', 'width', 'm_lohi', 'm_lo', 'm_hi')])
    dpar = spec['params'][0].to(like).contiguous()
    if spec['density'] == 'traced':
        # with its matrices that are read from device memory
        from ..ops.codegen import launch_params
        dpar = launch_params(spec['program'], dpar)
    return (DENSITY_IDS[spec['density']], tf_mat.contiguous(), dpar,
            float(tf['logw']), spec['scalars'])


def _check(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f'{name}: expected {dtype} {shape} on {device}, got '
                         f'{t.dtype} {tuple(t.shape)} on {t.device}.')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous.')


def _launch(kind, seed, i0, chain_start, q0, n_steps, max_treedepth,
            max_change, density, inputs, adapt=None, wsched=None):
    """Allocate outputs and scratch, launch ``nuts_chunk_launch`` (``kind``
    'frozen' or 'warmup') or ``nuts_block_launch`` ('block': one transition,
    K = 1 rows, no ``q_final``) and raise on a non-zero return. ``inputs``
    is the ordered list of input tensors after ``q0`` (the pointer table of
    ``csrc/nuts.cu``); ``adapt`` is (target, gamma, k, t_0, adapt_step,
    adapt_metric) for a warmup chunk."""
    from .._build import load_library, load_traced
    C, D = q0.shape
    K = int(n_steps)
    dev, dt = q0.device, q0.dtype
    if D > _MAX_D:
        raise ValueError(f'the CUDA NUTS kernels take D <= {_MAX_D}, got '
                         f'{D}.')
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f'unsupported dtype {dt}.')
    dens_id, tf_mat, dpar, logw, dscal = _spec_for(density, q0)
    _check('q0', q0, (C, D), dt, dev)
    n_lvl = max(int(max_treedepth) - 1, 1)

    def emp(*shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device=dev)

    i32 = torch.int32
    rows = dict(q=emp(K, C, D), logp=emp(K, C), energy=emp(K, C),
                energy_change=emp(K, C), tree_depth=emp(K, C, dtype=i32),
                tree_size=emp(K, C, dtype=i32), accept_sum=emp(K, C),
                max_de=emp(K, C), diverging=emp(K, C, dtype=i32),
                q_final=None if kind == 'block' else emp(C, D))
    # the checkpoint stacks, for launches whose stacks do not fit in shared
    # memory (csrc/nuts.cu::launch_kernel)
    stack = emp(C, n_lvl, 4 * D + 3)
    ptrs = [q0, *inputs[:2], tf_mat, dpar,
            *(rows[k] for k in ('q', 'logp', 'energy', 'energy_change',
                                'tree_depth', 'tree_size', 'accept_sum',
                                'max_de', 'diverging', 'q_final')), stack]
    if kind == 'warmup':
        fin = dict(step_size=emp(K, C), step_size_bar=emp(K, C),
                   log_step=emp(C), log_bar=emp(C), hbar=emp(C),
                   count=emp(C), var=emp(C, D), fg_mean=emp(C, D),
                   fg_raw=emp(C, D), fg_w=emp(C), bg_mean=emp(C, D),
                   bg_raw=emp(C, D), bg_w=emp(C))
        ws = torch.as_tensor(np.ascontiguousarray(wsched, np.int32),
                             device=dev)
        if tuple(ws.shape) != (2, K):
            raise ValueError(f'wsched: expected (2, {K}).')
        ptrs += [ws, *inputs[2:], *(fin[k] for k in (
            'step_size', 'step_size_bar', 'log_step', 'log_bar', 'hbar',
            'count', 'var', 'fg_mean', 'fg_raw', 'fg_w', 'bg_mean',
            'bg_raw', 'bg_w'))]
        rows.update(fin)
    plan = _spec_plan(dens_id, dscal, D, max_treedepth, q0.element_size())
    # a traced density's unit, or a compiled-in one's past nuts.cu's D
    traced = dens_id == DENSITY_IDS['traced']
    unit = traced or D > _LIB_D
    if traced:
        lib = load_traced(_spec_entry(density, q0)[2]['program'].source(dt))
    elif unit and plan is not None:
        lib = load_traced(poly_unit_source(D, dt, plan.get('stream', False)))
    elif unit:
        lib = load_traced(wide_unit_source(dens_id, D, dt))
    else:
        lib = load_library('nuts')
    adapt = adapt or (0., 0., 0., 0., False, False)
    adapt_step, adapt_metric = adapt[4:]
    if plan is not None and plan.get('stream'):
        ptrs[4] = _stream_params(density, q0, plan)
    fargs = (ctypes.c_double * (8 + _N_EXTRA))(
        *_fargs(max_change, logw, dscal, adapt, plan))
    parr = (ctypes.c_void_p * len(ptrs))(
        *[0 if p is None else p.data_ptr() for p in ptrs])
    stream = torch.cuda.current_stream(dev).cuda_stream
    f64 = 1 if dt == torch.float64 else 0
    if unit:
        fn = 'nuts_traced_launch'
        err = lib.nuts_traced_launch(
            _KINDS[kind], f64, C, D, K, int(max_treedepth), int(seed) & _M32,
            int(i0) & _M32, int(chain_start) & _M32, int(bool(adapt_step)),
            int(bool(adapt_metric)), fargs, parr, len(ptrs), stream)
        if err != 0:
            raise RuntimeError(
                f'{fn} failed: CUDA error {err} '
                f'({lib.nuts_traced_error_string(err).decode()}).')
        return rows
    if kind == 'block':
        fn = 'nuts_block_launch'
        err = lib.nuts_block_launch(
            f64, dens_id, C, D, int(max_treedepth), int(seed) & _M32,
            int(chain_start) & _M32, fargs, parr, len(ptrs), stream)
    else:
        fn = 'nuts_chunk_launch'
        err = lib.nuts_chunk_launch(
            int(kind == 'warmup'), f64, dens_id, C, D, K, int(max_treedepth),
            int(seed) & _M32, int(i0) & _M32, int(chain_start) & _M32,
            int(bool(adapt_step)), int(bool(adapt_metric)), fargs, parr,
            len(ptrs), stream)
    if err != 0:
        raise RuntimeError(
            f'{fn} failed: CUDA error {err} '
            f'({lib.nuts_error_string(err).decode()}).')
    return rows


def _row(a, C, like):
    """(C,) or scalar -> contiguous (C,) of ``like``'s dtype/device."""
    return torch.as_tensor(a).to(like).expand(C).contiguous()


def _mat(a, C, D, like):
    """(C, D) or (D,) -> contiguous (C, D) of ``like``'s dtype/device."""
    return torch.as_tensor(a).to(like).expand(C, D).contiguous()


def plain_lpg(density, ordered=True):
    """The plain versions' ``(C, D) -> (logp, grad)`` in transformed space:
    for a density with a kernel spec, its analytic form in the kernels'
    order of operations (``ops.densities.spec_logp_and_grad``, for a traced
    logp or plan its program's interpreter; not ``ordered``: in dense
    torch calls, for the samplers that have no kernel to match);
    otherwise, and for a traced logp or plan not ``ordered``, autograd
    through the density's torch logp, the function the user wrote."""
    traced = getattr(density, 'has_traced_spec', False)
    if getattr(density, 'has_kernel_spec', False) and (ordered or
                                                       not traced):
        # the spec of the density as it stands at each call (cached like
        # the launches' own), so a refit between calls is seen
        return lambda x: spec_logp_and_grad(_spec_entry(density, x)[2], x,
                                            ordered)
    f = density.device_logp_and_grad(original_space=False)
    return lambda x: f((), x)


def _chunk_stats(o, dtype):
    """``NutsStats`` from a kernel's output rows, (K, C) or (C,)."""
    n_prop = torch.clamp(o['tree_size'], min=1).to(dtype)
    return NutsStats(
        logp=o['logp'], energy=o['energy'], tree_depth=o['tree_depth'],
        tree_size=o['tree_size'], mean_tree_accept=o['accept_sum'] / n_prop,
        energy_change=o['energy_change'], max_energy_change=o['max_de'],
        diverging=o['diverging'].to(torch.bool))


def _warmup_leaves(q0, step_state, metric):
    """The warmup chunk's per-chain input leaves, as contiguous (C,) and
    (C, D) tensors of ``q0``'s dtype and device."""
    C, D = q0.shape
    steps = [_row(x, C, q0) for x in (step_state.log_step,
                                      step_state.log_bar, step_state.hbar,
                                      step_state.count, step_state.mu)]
    mets = [_mat(metric.var, C, D, q0), _mat(metric.fg.mean, C, D, q0),
            _mat(metric.fg.raw, C, D, q0), _row(metric.fg.weight, C, q0),
            _mat(metric.bg.mean, C, D, q0), _mat(metric.bg.raw, C, D, q0),
            _row(metric.bg.weight, C, q0)]
    return steps, mets


def nuts_transition_batched(seed, q0, metric, step_size, max_treedepth,
                            max_change, density=None, lpg=None,
                            chain_start=0, kernel='auto'):
    """One NUTS transition for every chain in one launch of the block
    kernel: the JAX ``nuts_transition_batched_pallas`` contract with an
    explicit int32 ``seed`` in place of the jax key. ``metric`` is a diag
    state with per-chain (C, D) or shared (D,) ``var``; ``step_size`` (C,)
    or a scalar. Returns ``(q_new (C, D), NutsStats with (C,) leaves)``."""
    if not isinstance(metric, DiagMetricState):
        raise ValueError('the NUTS block kernel supports the diagonal '
                         'metric only.')
    C, D = q0.shape
    var = _mat(metric.var, C, D, q0)
    step = _row(step_size, C, q0)
    if q0.is_cuda and kernel != 'torch':
        o = _launch('block', seed, 0, chain_start, q0.contiguous(), 1,
                    max_treedepth, max_change, density, [var, step])
        o = {k: o[k][0] for k in _ROW_NAMES}
        nuts_transition_batched.launches += 1
    elif kernel == 'cuda':
        raise RuntimeError("nuts_kernel='cuda' needs CUDA tensors.")
    else:
        o = nuts_block_plain(seed, q0, var, step, max_treedepth, max_change,
                             lpg or plain_lpg(density), chain_start)
    return o['q'], _chunk_stats(o, q0.dtype)


nuts_transition_batched.launches = 0


def nuts_chunk_batched(seed, q0, metric, step_size, n_steps, max_treedepth,
                       max_change, density=None, lpg=None, i0=0,
                       chain_start=0, kernel='auto'):
    """Run ``n_steps`` frozen-configuration NUTS transitions in one launch.

    The JAX ``nuts_chunk_batched_pallas`` contract with an explicit int32
    ``seed`` in place of the jax key, and the density object in place of
    ``lpg_pb``/``params`` (its ``kernel_spec()`` on CUDA; ``lpg`` or
    ``plain_lpg(density)`` on the CPU). Returns ``(q_chunk (K, C, D),
    q_last (C, D), NutsStats with (K, C) leaves)``.
    """
    if not isinstance(metric, DiagMetricState):
        raise ValueError('the NUTS chunk kernels support the diagonal '
                         'metric only.')
    C, D = q0.shape
    var = _mat(metric.var, C, D, q0)
    step = _row(step_size, C, q0)
    if q0.is_cuda and kernel != 'torch':
        o = _launch('frozen', seed, i0, chain_start, q0.contiguous(), n_steps,
                    max_treedepth, max_change, density, [var, step])
        nuts_chunk_batched.launches += 1
    elif kernel == 'cuda':
        raise RuntimeError("nuts_kernel='cuda' needs CUDA tensors.")
    else:
        o = nuts_chunk_plain(seed, q0, var, step, n_steps, max_treedepth,
                             max_change, lpg or plain_lpg(density), i0,
                             chain_start)
    return o['q'], o['q_final'], _chunk_stats(o, q0.dtype)


nuts_chunk_batched.launches = 0


def nuts_warmup_chunk_batched(seed, q0, step_state, metric, n_steps,
                              max_treedepth, max_change, target, gamma,
                              k_exp, t_0, adapt_step, adapt_metric, wsched,
                              density=None, lpg=None, i0=0, chain_start=0,
                              kernel='auto'):
    """Run ``n_steps`` WARMUP transitions (live dual averaging + windowed
    diag Welford) in one launch; the JAX
    ``nuts_warmup_chunk_batched_pallas`` contract with an explicit int32
    ``seed``. ``wsched`` is the (2, n_steps) table from
    ``_window_schedule``. Returns the dict of rows and final states."""
    if not isinstance(metric, DiagMetricState):
        raise ValueError('the NUTS warmup kernel supports the diagonal '
                         'metric only.')
    steps, mets = _warmup_leaves(q0, step_state, metric)
    adapt = (target, gamma, k_exp, t_0, adapt_step, adapt_metric)
    if q0.is_cuda and kernel != 'torch':
        # input order of csrc/nuts.cu's pointer table: var, eps (unused),
        # then the step leaves and the remaining metric leaves
        o = _launch('warmup', seed, i0, chain_start, q0.contiguous(), n_steps,
                    max_treedepth, max_change, density,
                    [mets[0], None, *steps, *mets[1:]], adapt, wsched)
        nuts_warmup_chunk_batched.launches += 1
        return o
    if kernel == 'cuda':
        raise RuntimeError("nuts_kernel='cuda' needs CUDA tensors.")
    return nuts_warmup_chunk_plain(
        seed, q0, steps, mets, n_steps, max_treedepth, max_change, target,
        gamma, k_exp, t_0, adapt_step, adapt_metric, wsched,
        lpg or plain_lpg(density), i0, chain_start)


nuts_warmup_chunk_batched.launches = 0
