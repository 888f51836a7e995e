// NUTS kernels for Hopper (sm_90a), one warp per chain.
//
// Replaces the three Pallas TPU kernels of the NUTS transitions:
//   nuts_multi   <- bayesfast_tpu/samplers/nuts_pallas.py:462
//                   (_nuts_multi_kernel: K frozen NUTS transitions)
//   nuts_warmup  <- bayesfast_tpu/samplers/nuts_pallas.py:746
//                   (_nuts_warmup_kernel: K transitions plus dual averaging
//                   and windowed diag-Welford adaptation)
//   nuts_block   <- bayesfast_tpu/samplers/nuts_pallas.py:431
//                   (_nuts_block_kernel: one transition under the bare seed;
//                   the per-transition path, ChainDriver.run, adapts
//                   between launches)
// All share `transition`, the port of _transition_core
// (nuts_pallas.py:120-415), and the counter RNG of nuts_pallas.py:54-88 and
// :418-428, reproduced bit for bit. The kernels are templates over the
// density functor: nuts.cu instantiates them with the densities compiled
// in, and a translation unit that ops/codegen.py generates from a traced
// torch logp with its `Traced` functor (the counterpart of the Pallas
// kernels evaluating a traced jaxpr, nuts_pallas.py:576-646).
//
// What bounds it on the card: the latency of one chain's serial chain of
// leapfrogs. A NUTS transition is a data-dependent chain of up to
// 2^maxdepth - 1 leapfrogs, each needing the previous one, with
// scalar-branched merges over a checkpoint stack. At the bench shape (1024
// chains, D = 32, f32) every chain is resident at once (8 warps on each of
// 132 SMs), so a launch lasts as long as its slowest chain's leapfrogs, one
// after the other; the work of a leapfrog (two 32x32 matvecs, a few 32-wide
// dot products, one exp and one log per dimension) is tiny beside its
// dependent latency. Neither device-memory bytes nor FLOPs bound it, and
// putting several chains in one warp would lengthen the slowest chain's
// path, not shorten it: the lever is fewer cycles per leapfrog.
//
// What the design does about it: one chain per warp, lanes over
// dimensions, and a short dependent path for each leapfrog:
// - the density's parameters (the banana's A and A^T, zero-padded, one
//   row per lane) are staged in shared memory once per block, and the
//   matvecs are unrolled with no predicate: each lane reads its row and
//   the vector (through a per-warp buffer) 16 bytes at a time, all loads
//   and products can be in flight at once, and only the adds, in order
//   over k as ops/densities.py::_matvec_seq takes them, wait on each
//   other;
// - the checkpoint stacks live in shared memory beside them where a
//   block's 227 KB hold them all (at depth 10: every dtype and D; deeper
//   trees in f64 keep global scratch, chosen per launch in
//   `launch_kernel`), and they are not zeroed: a merge reads only frames
//   stored earlier in the same doubling (see `transition`);
// - the tree schedule (merges pending, subtree done, stack slot) is a
//   trailing-ones count of the leaf index, in registers;
// - each lane's neighbour indices and parities are set once per launch,
//   not taken modulo D at every evaluation;
// - the logp sums (log-Jacobian, density) wait until the gradient is done
//   and go through one butterfly with the kinetic energy's sum, and the
//   first merge's frame and uniform are read before the leapfrog, so their
//   latencies hide behind the leapfrog's instead of adding to it;
// - the other tree uniforms are drawn only on the branches that use them.
// Every value takes the operations, in the order, of the plain version
// (samplers/nuts_cuda.py); only independent work is reordered.
// Dot products are xor-butterfly shuffles (every lane ends with the same
// bits, so every branch stays warp-uniform), and each chain retires on its
// own when its tree ends. Tensor-core matvecs are later work.
//
// Not taken, each bitwise right and slower on the f64 anchors (PERF.md):
// - the next leaf's leapfrog issued ahead of this leaf's tail. Its start
//   is known before the tail (this leaf's state while the doubling goes
//   on, at a doubling's end the edge that a uniform keyed by (seed, leaf,
//   chain) picks), but ptxas schedules within basic blocks, and an f64
//   leaf is some 80 of them (a BSSY / BSYNC pair around every IEEE
//   divide's slow path and the math library's range checks): the two
//   leaves ran one after the other whatever the source order, and the
//   extra leapfrog and the copies of the start and of the functor made
//   the f64 chunks 5-15 % slower;
// - the energy's three sums and the level-0 merge's two dots in one
//   butterfly, a deeper merge's six in one.
//
// Registers and occupancy: the kernels are declared for one block of 8
// warps an SM (`__launch_bounds__(256, 1)`), so ptxas may give a thread up
// to 255 registers and has no reason to spill to reach a second block. At
// C chains a collective density's launch has C / 8 blocks, one wave on 132
// SMs up to C = 1056 (a block of the surrogate takes most of an SM's
// shared memory anyway). A density that its warp evaluates alone takes the
// fewest warps a block that keep the blocks within one wave (1, 2 or 4,
// else 8; csrc/nuts_launch.cuh::launch_shape): at 64 chains a block a
// chain, so that the few chains of a launch spread over 64 SMs instead of
// sharing the issue slots and the FP64 pipes of 8. Above 1056 chains a
// second wave of blocks starts only as blocks of the first finish.
//
// Lane width: a lane holds NE = ceil(D / 32) dimensions, NE = 1..8 (D <=
// 256, `check_launch`). Past NE = 2 a lane's state (three `State`s of 5
// NE + 2 values, the frames, the merge temporaries) outgrows the 255
// registers and ptxas keeps the rest in local memory (L1, then L2): the
// compiled-in Gaussian fits at NE = 4 in f32 and spills ~1 KB a thread in
// f64; the traced MVN-250 at NE = 8 spills 0.7-1.1 KB (f32) and 3.7-4.4
// KB (f64) of stores a thread since its products stream with their row
// groups in a loop (chip_smoke.py [2b]; csrc/nuts_device.cuh::tiled_matvec:
// unrolled, 4.1-4.6 and 14.8-15.3 KB, PERF.md). The arithmetic
// and its order, and so the bits, stay the plain versions'. The tree's
// edge states in a per-warp slab of shared memory made MVN-250 slower
// (PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC --fmad=false   (see ../_build.py)
// --fmad=false and no fast math keep each elementwise operation rounded as
// the plain torch version rounds it; the plain versions also take every sum
// in the kernels' order, so the two agree bit for bit.

#pragma once

#include "nuts_device.cuh"

namespace {

// ---- the fused bound transform (ops/constraint.py) plus a density ---------
template <typename T, int NE, class Dens>
struct TDensity {
  Dens dens;
  T lo[NE], width[NE], m_lohi[NE], m_lo[NE], m_hi[NE];
  T logw;
  bool valid[NE];

  // transformed-space gradient, grad_t = grad_x * g + h, and this lane's
  // parts of the log-Jacobian and density sums (see `logp`)
  __device__ void operator()(const T (&x)[NE], T (&gt)[NE], T& ld_part,
                             T& d_part) const {
    T xo[NE], gg[NE], hh[NE], arg[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const T m_none = T(1) - m_lohi[e] - m_lo[e] - m_hi[e];
      const T lim = T(85);
      const T xc = x[e] < -lim ? -lim : (x[e] > lim ? lim : x[e]);
      const T em = m_exp(-xc);
      const T ep = T(1) / em;
      const T s = T(1) / (T(1) + em);
      const T t = m_lohi[e] * s + m_lo[e] * ep + m_hi[e] * (T(1) - ep) +
                  m_none * x[e];
      xo[e] = lo[e] + t * width[e];
      const T s1s = s * (T(1) - s);
      arg[e] = m_lohi[e] * s1s + (T(1) - m_lohi[e]);
      gg[e] = (m_lohi[e] * s1s + (m_lo[e] - m_hi[e]) * ep + m_none) *
              width[e];
      hh[e] = m_lohi[e] * (T(1) - T(2) * s) + m_lo[e] + m_hi[e];
    }
    T gx[NE];
    d_part = dens(xo, gx);
#pragma unroll
    for (int e = 0; e < NE; ++e) gt[e] = valid[e] ? gx[e] * gg[e] + hh[e] : T(0);
    // the log-Jacobian last: the gradient's path does not wait on its log
    ld_part = T(0);
#pragma unroll
    for (int e = 0; e < NE; ++e)
      if (valid[e]) ld_part += m_log(arg[e]) + (m_lo[e] + m_hi[e]) * x[e];
  }

  // the transformed-space logp from the warp sums of the two parts
  __device__ T logp(T ld_sum, T d_sum) const {
    return dens.finish(d_sum) + (ld_sum + logw);
  }
};

// logp from the density's two lane parts (`lp`), and the energy
// 0.5 p.(var p) - logp: the log-Jacobian, density and kinetic sums go
// through one butterfly together, after the gradient's path
template <typename T, int NE, class TD>
__device__ __forceinline__ T energy(const TD& lpg, T ld, T dn,
                                   const T (&p)[NE], const T (&var)[NE],
                                   T& lp) {
  T kin = T(0);
#pragma unroll
  for (int e = 0; e < NE; ++e) kin += p[e] * (var[e] * p[e]);
  warp_sum3(ld, dn, kin);
  lp = lpg.logp(ld, dn);
  return T(0.5) * kin - lp;
}

// ---- kernel arguments ------------------------------------------------------
// Pointer table order (the wrapper in samplers/nuts_cuda.py builds it; the
// block kernel takes the frozen table, with K = 1 rows and q_final unused):
//  0 q0 (C,D)  1 var (C,D)  2 eps (C,)  3 tf (5,D)  4 density params
//  5 q (K,C,D)  6 logp  7 energy  8 energy_change  9 depth i32  10 size i32
//  11 accept_sum  12 max_de  13 diverging i32  14 q_final (C,D)
//  15 stack (C, n_lvl, 4D+3), global scratch for launches whose stacks do
//     not fit in shared memory
// warmup only:
//  16 wsched (2,K) i32  17..21 log_step log_bar hbar count mu (C,)
//  22 fg_mean 23 fg_raw (C,D) 24 fg_w (C,) 25 bg_mean 26 bg_raw 27 bg_w
//  28 step_size (K,C) 29 step_size_bar (K,C)  30..33 final log_step
//  log_bar hbar count  34 var 35 fg_mean 36 fg_raw 37 fg_w 38 bg_mean
//  39 bg_raw 40 bg_w
constexpr int kPtrsFrozen = 16;
constexpr int kPtrsWarmup = 41;

template <typename T>
struct Args {
  const T *q0, *var, *eps;
  const T *tf, *dpar;
  T *q, *logp, *energy, *de;
  int *depth, *size;
  T *asum, *mde;
  int* div;
  T *q_final, *stack;
  const int* wsched;
  const T *ls, *lb, *hb, *ct, *mu, *fgm, *fgr, *fgw, *bgm, *bgr, *bgw;
  T *ss, *ssb, *ls_f, *lb_f, *hb_f, *ct_f, *var_f, *fgm_f, *fgr_f, *fgw_f,
      *bgm_f, *bgr_f, *bgw_f;
  int C, D, K, maxdepth, L;
  int warps;     // chains (warps) a block
  int stk_smem;  // 1: the checkpoint stacks are in shared memory
  uint32_t seed, i0, chain_start;
  T max_change, logw, d0, d1, target, gamma, kexp, t0;
  int adapt_step, adapt_metric;
};

// lane-distributed checkpoint frame:
// [left_p | right_p | p_sum | log_size | q | energy | logp]
template <typename T, int NE>
struct Frame {
  T lp[NE], rp[NE], ps[NE], q[NE];
  T ls, e, lpv;
};

template <typename T, int NE>
struct State {  // integrator state: position, momentum, grad, Kahan residuals
  T q[NE], p[NE], g[NE], cq[NE], cp[NE];
  T e, lp;
};

template <typename T, int NE>
__device__ __forceinline__ void store_frame(T* f, const Frame<T, NE>& fr,
                                            int D) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const int d = lane + 32 * e;
    if (d < D) {
      f[d] = fr.lp[e];
      f[D + d] = fr.rp[e];
      f[2 * D + d] = fr.ps[e];
      f[3 * D + 1 + d] = fr.q[e];
    }
  }
  if (lane == 0) {
    f[3 * D] = fr.ls;
    f[4 * D + 1] = fr.e;
    f[4 * D + 2] = fr.lpv;
  }
  __syncwarp();
}

template <typename T, int NE>
__device__ __forceinline__ Frame<T, NE> load_frame(const T* f, int D) {
  const int lane = threadIdx.x & 31;
  Frame<T, NE> fr;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const int d = lane + 32 * e;
    const bool ok = d < D;
    fr.lp[e] = ok ? f[d] : T(0);
    fr.rp[e] = ok ? f[D + d] : T(0);
    fr.ps[e] = ok ? f[2 * D + d] : T(0);
    fr.q[e] = ok ? f[3 * D + 1 + d] : T(0);
  }
  fr.ls = f[3 * D];
  fr.e = f[4 * D + 1];
  fr.lpv = f[4 * D + 2];
  return fr;
}

template <typename T, int NE>
__device__ __forceinline__ T wdot(const T (&a)[NE], const T (&b)[NE]) {
  T s = T(0);
#pragma unroll
  for (int e = 0; e < NE; ++e) s += a[e] * b[e];
  return warp_sum(s);
}

// dot(a, var * b)
template <typename T, int NE>
__device__ __forceinline__ T vdot(const T (&a)[NE], const T (&var)[NE],
                                  const T (&b)[NE]) {
  T s = T(0);
#pragma unroll
  for (int e = 0; e < NE; ++e) s += a[e] * (var[e] * b[e]);
  return warp_sum(s);
}

// join older/left t1 with newer/right t2 (nuts_pallas.py:180-209); log_u is
// the float32 log of the merge's uniform, in T
template <typename T, int NE>
__device__ __forceinline__ Frame<T, NE> merge(T log_u, const Frame<T, NE>& t1,
                                              const Frame<T, NE>& t2,
                                              int merged_depth,
                                              const T (&var)[NE],
                                              bool& turning) {
  Frame<T, NE> m;
  T ps1[NE], ps2[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    m.ps[e] = t1.ps[e] + t2.ps[e];
    ps1[e] = t1.ps[e] + t2.lp[e];
    ps2[e] = t1.rp[e] + t2.ps[e];
    m.lp[e] = t1.lp[e];
    m.rp[e] = t2.rp[e];
  }
  turning = (vdot(m.ps, var, t1.lp) <= T(0)) |
            (vdot(m.ps, var, t2.rp) <= T(0));
  if (merged_depth > 1) {
    const bool extra = (vdot(ps1, var, t1.lp) <= T(0)) |
                       (vdot(ps1, var, t2.lp) <= T(0)) |
                       (vdot(ps2, var, t1.rp) <= T(0)) |
                       (vdot(ps2, var, t2.rp) <= T(0));
    turning = turning | extra;
  }
  m.ls = logaddexp(t1.ls, t2.ls);
  const bool take2 = log_u < t2.ls - m.ls;
#pragma unroll
  for (int e = 0; e < NE; ++e) m.q[e] = take2 ? t2.q[e] : t1.q[e];
  m.e = take2 ? t2.e : t1.e;
  m.lpv = take2 ? t2.lpv : t1.lpv;
  return m;
}

template <typename T, int NE>
struct Result {
  T q[NE];
  T energy, logp, de, asum, mde;
  int depth, size, div;
};

// One full NUTS transition for this warp's chain (nuts_pallas.py:120-415),
// sequential per chain: a chain stops when its tree ends.
//
// The stack `stk` is not cleared between transitions: no frame is merged
// before it is stored in the same doubling (level 0 is read at every leaf,
// and merged only when pending > 0). Within a doubling, leaf k
// merges with the frames at levels 0 .. pending - 1, where pending is the
// count of trailing ones of k, and a leaf that does not end the doubling
// stores its merged frame at level `pending`. For m < pending, leaf
// k - 2^m (k with bit m cleared) has count m and comes earlier in the same
// doubling, so the frame at level m was stored in this doubling (leaf 0 of
// a doubling has count 0 and merges nothing). A leaf that ends its
// doubling, or aborts the tree, stores nothing.
template <typename T, int NE, class TD>
__device__ void transition(const Args<T>& a, const TD& lpg, uint32_t seed,
                           uint32_t chain, const T (&q0)[NE],
                           const T (&p0)[NE], T step, const T (&var)[NE],
                           T* stk, Result<T, NE>& out) {
  const int D = a.D;
  const int F = 4 * D + 3;
  const T max_change = a.max_change;

  State<T, NE> cur;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    cur.q[e] = q0[e];
    cur.p[e] = p0[e];
    cur.cq[e] = T(0);
    cur.cp[e] = T(0);
  }
  T ld, dn;
  lpg(cur.q, cur.g, ld, dn);
  cur.e = energy(lpg, ld, dn, cur.p, var, cur.lp);
  const T e0 = cur.e;
  State<T, NE> left = cur, right = cur;
  T pq[NE], psum[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    pq[e] = q0[e];
    psum[e] = p0[e];
  }
  T pe = e0, plp = cur.lp;
  T log_size = T(0), accept_sum = T(0), max_de = T(0);
  int depth = 0, n_prop = 0;
  bool diverging = false, done = false;
  bool go_right = uniform(seed, 0xFFFFFFFFu, 7u, 0u, chain) < 0.5f;
  T eps = go_right ? step : -step;
  // the schedule (nuts_cuda.py::_leaf_schedule): leaf k of the current
  // doubling, which has `span` leaves
  int k_leaf = 0, span = 1;

  // a tree of depth maxdepth has a.L leaves: the loop ends by then
  for (int it = 0; !done && it < a.L; ++it) {
    const int pending = __ffs(~k_leaf) - 1;  // trailing ones of k_leaf
    const bool sub_done = k_leaf == span - 1;
    if (++k_leaf == span) {
      k_leaf = 0;
      span <<= 1;
    }
    // the first merge's frame and uniform do not depend on this leaf: read
    // them first, so that their latency hides in the leapfrog's (the frame
    // is read whether or not it is merged, which changes nothing)
    const Frame<T, NE> f0 = load_frame<T, NE>(stk, D);
    const T log_u0 = T(logf(uniform(seed, (uint32_t)it, 0u, 0u, chain)));

    // ---- one Kahan-compensated leapfrog ----
    State<T, NE> nw;
    T ph[NE];
    const T dt = T(0.5) * eps;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      T y = dt * cur.g[e] - cur.cp[e];
      T t = cur.p[e] + y;
      nw.cp[e] = (t - cur.p[e]) - y;
      ph[e] = t;
      y = eps * (var[e] * ph[e]) - cur.cq[e];
      t = cur.q[e] + y;
      nw.cq[e] = (t - cur.q[e]) - y;
      nw.q[e] = t;
    }
    lpg(nw.q, nw.g, ld, dn);
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const T y = dt * nw.g[e] - nw.cp[e];
      const T t = ph[e] + y;
      nw.cp[e] = (t - ph[e]) - y;
      nw.p[e] = t;
    }
    nw.e = energy(lpg, ld, dn, nw.p, var, nw.lp);

    T de = nw.e - e0;
    if (isnan(de)) de = T(INFINITY);
    const bool div = !(m_abs(de) < max_change);
    if (m_abs(de) > m_abs(max_de)) max_de = de;
    T acc = m_exp(-de);
    acc = acc > T(1) ? T(1) : acc;
    if (!div) accept_sum += acc;
    n_prop += 1;
    if (!div) cur = nw;
    diverging = diverging | div;

    // ---- binary-counter merges ----
    Frame<T, NE> inc;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      inc.lp[e] = nw.p[e];
      inc.rp[e] = nw.p[e];
      inc.ps[e] = nw.p[e];
      inc.q[e] = nw.q[e];
    }
    inc.ls = -de;
    inc.e = nw.e;
    inc.lpv = nw.lp;
    bool turned = false;
    if (pending > 0 && !div) {
      inc = merge(log_u0, f0, inc, 1, var, turned);
      for (int m = 1; m < pending && !turned; ++m) {
        const float um = uniform(
            seed, (uint32_t)(it * (a.maxdepth + 1) + m), 3u, 0u, chain);
        inc = merge(T(logf(um)), load_frame<T, NE>(stk + m * F, D), inc,
                    m + 1, var, turned);
      }
    }
    const bool abort = div || turned;
    // a finished subtree's frame would go to a never-read sink level, and
    // an aborted tree reads nothing more: only live frames are stored
    if (!abort && !sub_done) store_frame(stk + pending * F, inc, D);
    if (abort || sub_done) depth += 1;
    if (abort) done = true;

    // ---- subtree completion ----
    if (sub_done && !abort) {
      const float u1 = uniform(seed, (uint32_t)it, 0u, 1u, chain);
      const T sub_ls = inc.ls;
      if (T(logf(u1)) < sub_ls - log_size) {
#pragma unroll
        for (int e = 0; e < NE; ++e) pq[e] = inc.q[e];
        pe = inc.e;
        plp = inc.lpv;
      }
      log_size = logaddexp(log_size, sub_ls);
      T psn[NE], ps1[NE], ps2[NE], nl_p[NE], nr_p[NE];
      // halves in spatial order
      T lm_begin_v[NE], lm_end_p[NE], lm_end_v[NE], rm_begin_p[NE],
          rm_begin_v[NE], rm_end_v[NE];
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        psn[e] = psum[e] + inc.ps[e];
        nl_p[e] = go_right ? left.p[e] : cur.p[e];
        nr_p[e] = go_right ? cur.p[e] : right.p[e];
        const T incl_v = var[e] * inc.lp[e];
        const T left_v = var[e] * left.p[e];
        const T right_v = var[e] * right.p[e];
        const T cur_v = var[e] * cur.p[e];
        const T lm_psum = go_right ? psum[e] : inc.ps[e];
        const T rm_psum = go_right ? inc.ps[e] : psum[e];
        lm_begin_v[e] = go_right ? left_v : cur_v;
        lm_end_p[e] = go_right ? right.p[e] : inc.lp[e];
        lm_end_v[e] = go_right ? right_v : incl_v;
        rm_begin_p[e] = go_right ? inc.lp[e] : left.p[e];
        rm_begin_v[e] = go_right ? incl_v : left_v;
        rm_end_v[e] = go_right ? cur_v : right_v;
        ps1[e] = lm_psum + rm_begin_p[e];
        ps2[e] = lm_end_p[e] + rm_psum;
      }
      const bool turning_full =
          (vdot(psn, var, nl_p) <= T(0)) | (vdot(psn, var, nr_p) <= T(0)) |
          (wdot(ps1, lm_begin_v) <= T(0)) | (wdot(ps1, rm_begin_v) <= T(0)) |
          (wdot(ps2, lm_end_v) <= T(0)) | (wdot(ps2, rm_end_v) <= T(0));
      if (go_right)
        right = cur;
      else
        left = cur;
#pragma unroll
      for (int e = 0; e < NE; ++e) psum[e] = psn[e];
      if (turning_full || depth >= a.maxdepth) {
        done = true;
      } else {
        const float u2 = uniform(seed, (uint32_t)it, 0u, 2u, chain);
        go_right = u2 < 0.5f;
        eps = go_right ? step : -step;
        if (go_right)
          cur = right;
        else
          cur = left;
      }
    }
  }

#pragma unroll
  for (int e = 0; e < NE; ++e) out.q[e] = pq[e];
  out.energy = pe;
  out.logp = plp;
  out.de = pe - e0;
  out.depth = depth;
  out.size = n_prop;
  out.asum = accept_sum;
  out.mde = max_de;
  out.div = diverging ? 1 : 0;
}

// the density behind the fused transform, with this lane's dimensions of
// the transform parameters
template <typename T, int NE, class Dens>
__device__ __forceinline__ TDensity<T, NE, Dens> make_lpg(const Args<T>& a,
                                                          const Dens& dens) {
  const int lane = threadIdx.x & 31;
  const int D = a.D;
  TDensity<T, NE, Dens> lpg;
  lpg.dens = dens;
  lpg.logw = a.logw;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const int d = lane + 32 * e;
    const bool ok = d < D;
    lpg.valid[e] = ok;
    lpg.lo[e] = ok ? a.tf[d] : T(0);
    lpg.width[e] = ok ? a.tf[D + d] : T(0);
    lpg.m_lohi[e] = ok ? a.tf[2 * D + d] : T(0);
    lpg.m_lo[e] = ok ? a.tf[3 * D + d] : T(0);
    lpg.m_hi[e] = ok ? a.tf[4 * D + d] : T(0);
  }
  return lpg;
}

// Every thread of the block stages the density's parameters in shared
// memory and binds its functor to them (before any warp leaves); returns
// this warp's checkpoint stack of n_levels frames: in shared memory after
// the parameters when the launch made room for it, else global scratch.
template <typename T, class Dens>
__device__ __forceinline__ T* stage_block(const Args<T>& a, Dens& dens,
                                          int c) {
  extern __shared__ __align__(16) unsigned char g_smem[];
  T* smem = reinterpret_cast<T*>(g_smem);
  dens.stage(smem);
  __syncthreads();
  dens.bind(smem);
  const size_t frames = (size_t)n_levels(a.maxdepth) * (4 * a.D + 3);
  if (a.stk_smem)
    return smem + dens.smem_elems() + (threadIdx.x >> 5) * frames;
  return a.stack + (size_t)c * frames;
}

// A density whose evaluations meet the block's other warps at barriers
// (PolyGaussian's streamed path, PolyBlock past D = 64, a generated density
// whose matrices stream through shared tiles) keeps a warp in idle ticks
// after its last evaluation until every warp of the block is done
// (`drain`); for the others this is nothing.
template <class Dens>
__device__ __forceinline__ auto drain(const Dens& d, int)
    -> decltype(d.drain()) {
  d.drain();
}
template <class Dens>
__device__ __forceinline__ void drain(const Dens&, long) {}

// Whether a density's evaluation is its warp's alone (no `drain`: the
// banana, the Gaussian, the anchors, a generated density that streams
// nothing): such a density takes any warps a block (`launch_shape`), a
// collective one kWarps.
template <class Dens>
constexpr auto collective(int) -> decltype(((const Dens*)0)->drain(), true) {
  return true;
}
template <class Dens>
constexpr bool collective(long) {
  return false;
}
template <class Dens>
constexpr bool kPerWarp = !collective<Dens>(0);

// this warp's chain: with the launch's warps a block for a density that its
// warp evaluates alone, as the block's first thread plus this thread over
// 32 (of the forms tried, the one with which ptxas keeps the traced bench
// banana's f64 warmup chunk in 254 registers, unspilled, as at 8 warps),
// kWarps for a collective one
template <class Dens, typename T>
__device__ __forceinline__ int chain_index(const Args<T>& a) {
  if constexpr (kPerWarp<Dens>)
    return (int)((blockIdx.x * (unsigned)a.warps * 32u + threadIdx.x) >> 5);
  return blockIdx.x * kWarps + (threadIdx.x >> 5);
}

template <typename T, int NE, class Dens, bool WARM>
__global__ void __launch_bounds__(kWarps * 32, 1)
    nuts_chunk_kernel(Args<T> a, Dens dens) {
  const int lane = threadIdx.x & 31;
  const int c = chain_index<Dens>(a);
  T* stk = stage_block(a, dens, c);
  if (c >= a.C) {  // the whole warp leaves together
    drain(dens, 0);
    return;
  }
  const int D = a.D, C = a.C;
  const uint32_t chain = a.chain_start + (uint32_t)c;

  const TDensity<T, NE, Dens> lpg = make_lpg<T, NE>(a, dens);
  T q[NE], var[NE], fgm[NE], fgr[NE], bgm[NE], bgr[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const int d = lane + 32 * e;
    const bool ok = d < D;
    const size_t i = (size_t)c * D + d;
    q[e] = ok ? a.q0[i] : T(0);
    var[e] = ok ? a.var[i] : T(0);
    if (WARM) {
      fgm[e] = ok ? a.fgm[i] : T(0);
      fgr[e] = ok ? a.fgr[i] : T(0);
      bgm[e] = ok ? a.bgm[i] : T(0);
      bgr[e] = ok ? a.bgr[i] : T(0);
    }
  }
  T log_step = T(0), log_bar = T(0), hbar = T(0), count = T(0), mu = T(0);
  T fgw = T(0), bgw = T(0), step = T(0);
  if (WARM) {
    log_step = a.ls[c];
    log_bar = a.lb[c];
    hbar = a.hb[c];
    count = a.ct[c];
    mu = a.mu[c];
    fgw = a.fgw[c];
    bgw = a.bgw[c];
  } else {
    step = a.eps[c];
  }

  for (int t = 0; t < a.K; ++t) {
    const uint32_t seed_t = a.seed ^ fmix32(a.i0 + (uint32_t)t + 0x9E3779B9u);
    if (WARM) step = m_exp(log_step);
    T p0[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int d = lane + 32 * e;
      // p ~ N(0, var^-1): p = z / sqrt(var)
      p0[e] = d < D ? T(gauss(seed_t, (uint32_t)d, chain)) / m_sqrt(var[e])
                    : T(0);
    }
    Result<T, NE> r;
    transition<T, NE>(a, lpg, seed_t, chain, q, p0, step, var, stk, r);

    const size_t row = (size_t)t * C + c;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int d = lane + 32 * e;
      if (d < D) a.q[row * D + d] = r.q[e];
      q[e] = r.q[e];
    }
    if (WARM) {
      T size = T(r.size);
      const T accept = r.asum / (size > T(1) ? size : T(1));
      if (a.adapt_step) {  // dual averaging (step_size.py)
        const T w = T(1) / (count + a.t0);
        hbar = (T(1) - w) * hbar + w * (a.target - accept);
        log_step = mu - hbar * m_sqrt(count) / a.gamma;
        const T mk = m_exp(-a.kexp * m_log(count));
        log_bar = mk * log_step + (T(1) - mk) * log_bar;
        count = count + T(1);
      }
      if (a.adapt_metric) {  // diag Welford (metrics.py) + window table
        const T n_f = fgw + T(1), n_b = bgw + T(1);
        const bool refresh = a.wsched[t] == 1;
        const bool sw = a.wsched[a.K + t] == 1;
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          const T od = r.q[e] - fgm[e];
          fgm[e] = fgm[e] + od / n_f;
          fgr[e] = fgr[e] + od * (r.q[e] - fgm[e]);
          const T od_b = r.q[e] - bgm[e];
          bgm[e] = bgm[e] + od_b / n_b;
          bgr[e] = bgr[e] + od_b * (r.q[e] - bgm[e]);
          if (refresh && lane + 32 * e < D)
            var[e] = (fgr[e] + T(5e-3)) / (n_f + T(5));
          if (sw) {
            fgm[e] = bgm[e];
            fgr[e] = bgr[e];
            bgm[e] = T(0);
            bgr[e] = T(0);
          }
        }
        fgw = sw ? n_b : n_f;
        bgw = sw ? T(0) : n_b;
      }
    }
    if (lane == 0) {
      a.logp[row] = r.logp;
      a.energy[row] = r.energy;
      a.de[row] = r.de;
      a.depth[row] = r.depth;
      a.size[row] = r.size;
      a.asum[row] = r.asum;
      a.mde[row] = r.mde;
      a.div[row] = r.div;
      if (WARM) {
        // recorded AFTER the update (base_hmc.py:80-84)
        a.ss[row] = m_exp(log_step);
        a.ssb[row] = m_exp(log_bar);
      }
    }
  }

#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const int d = lane + 32 * e;
    if (d < D) {
      const size_t i = (size_t)c * D + d;
      a.q_final[i] = q[e];
      if (WARM) {
        a.var_f[i] = var[e];
        a.fgm_f[i] = fgm[e];
        a.fgr_f[i] = fgr[e];
        a.bgm_f[i] = bgm[e];
        a.bgr_f[i] = bgr[e];
      }
    }
  }
  if (WARM && lane == 0) {
    a.ls_f[c] = log_step;
    a.lb_f[c] = log_bar;
    a.hb_f[c] = hbar;
    a.ct_f[c] = count;
    a.fgw_f[c] = fgw;
    a.bgw_f[c] = bgw;
  }
  drain(dens, 0);
}

// One NUTS transition for this warp's chain under the bare seed (the port of
// _nuts_block_kernel, nuts_pallas.py:431-459): momenta gauss(seed, d, chain)
// and the tree's draws all under `seed`, no iteration fold. A launch with
// seed ^ fmix32(i0 + t + 0x9E3779B9) is therefore transition t of a chunk
// launch from the same start, bit for bit. The design is the chunk kernels'
// (one warp per chain, `transition` shared); the per-transition path adapts
// between launches. A launch lasts as long as its slowest chain's tree, up
// to 2^maxdepth - 1 dependent leapfrogs, where a K-transition chunk lets a
// chain's short trees make up for its long ones; so per transition it
// takes longer than a chunk.
template <typename T, int NE, class Dens>
__global__ void __launch_bounds__(kWarps * 32, 1)
    nuts_block_kernel(Args<T> a, Dens dens) {
  const int lane = threadIdx.x & 31;
  const int c = chain_index<Dens>(a);
  T* stk = stage_block(a, dens, c);
  if (c >= a.C) {  // the whole warp leaves together
    drain(dens, 0);
    return;
  }
  const int D = a.D;
  const uint32_t chain = a.chain_start + (uint32_t)c;

  const TDensity<T, NE, Dens> lpg = make_lpg<T, NE>(a, dens);
  T q[NE], var[NE], p0[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const int d = lane + 32 * e;
    const bool ok = d < D;
    const size_t i = (size_t)c * D + d;
    q[e] = ok ? a.q0[i] : T(0);
    var[e] = ok ? a.var[i] : T(0);
    // p ~ N(0, var^-1): p = z / sqrt(var)
    p0[e] = ok ? T(gauss(a.seed, (uint32_t)d, chain)) / m_sqrt(var[e]) : T(0);
  }
  Result<T, NE> r;
  transition<T, NE>(a, lpg, a.seed, chain, q, p0, a.eps[c], var, stk, r);
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const int d = lane + 32 * e;
    if (d < D) a.q[(size_t)c * D + d] = r.q[e];
  }
  if (lane == 0) {
    a.logp[c] = r.logp;
    a.energy[c] = r.energy;
    a.de[c] = r.de;
    a.depth[c] = r.depth;
    a.size[c] = r.size;
    a.asum[c] = r.asum;
    a.mde[c] = r.mde;
    a.div[c] = r.div;
  }
  drain(dens, 0);
}

enum Kind { kFrozen = 0, kWarmup = 1, kBlock = 2 };

template <typename T>
Args<T> make_args(int C, int D, int K, int maxdepth, uint32_t seed,
                  uint32_t i0, uint32_t chain_start, int adapt_step,
                  int adapt_metric, const double* f, void* const* p,
                  bool warm) {
  Args<T> a = {};
  a.q0 = (const T*)p[0];
  a.var = (const T*)p[1];
  a.eps = (const T*)p[2];
  a.tf = (const T*)p[3];
  a.dpar = (const T*)p[4];
  a.q = (T*)p[5];
  a.logp = (T*)p[6];
  a.energy = (T*)p[7];
  a.de = (T*)p[8];
  a.depth = (int*)p[9];
  a.size = (int*)p[10];
  a.asum = (T*)p[11];
  a.mde = (T*)p[12];
  a.div = (int*)p[13];
  a.q_final = (T*)p[14];
  a.stack = (T*)p[15];
  if (warm) {
    a.wsched = (const int*)p[16];
    a.ls = (const T*)p[17];
    a.lb = (const T*)p[18];
    a.hb = (const T*)p[19];
    a.ct = (const T*)p[20];
    a.mu = (const T*)p[21];
    a.fgm = (const T*)p[22];
    a.fgr = (const T*)p[23];
    a.fgw = (const T*)p[24];
    a.bgm = (const T*)p[25];
    a.bgr = (const T*)p[26];
    a.bgw = (const T*)p[27];
    a.ss = (T*)p[28];
    a.ssb = (T*)p[29];
    a.ls_f = (T*)p[30];
    a.lb_f = (T*)p[31];
    a.hb_f = (T*)p[32];
    a.ct_f = (T*)p[33];
    a.var_f = (T*)p[34];
    a.fgm_f = (T*)p[35];
    a.fgr_f = (T*)p[36];
    a.fgw_f = (T*)p[37];
    a.bgm_f = (T*)p[38];
    a.bgr_f = (T*)p[39];
    a.bgw_f = (T*)p[40];
  }
  a.C = C;
  a.D = D;
  a.K = K;
  a.maxdepth = maxdepth;
  a.L = (1 << maxdepth) - 1;
  a.seed = seed;
  a.i0 = i0;
  a.chain_start = chain_start;
  a.max_change = T(f[0]);
  a.logw = T(f[1]);
  a.d0 = T(f[2]);
  a.d1 = T(f[3]);
  a.target = T(f[4]);
  a.gamma = T(f[5]);
  a.kexp = T(f[6]);
  a.t0 = T(f[7]);
  a.adapt_step = adapt_step;
  a.adapt_metric = adapt_metric;
  return a;
}

// A launch in the shape `launch_shape` gives it (csrc/nuts_launch.cuh):
// warps a block by the density's kind (`kPerWarp`) and the SMs of the
// current device, which is the stream's (a launch on another device's
// stream fails), and shared memory for the density's parameters and, where
// they fit, every warp's checkpoint stack (at depth 10 they do for the
// banana and the Gaussian at every dtype and D <= 64). Above 48 KB the
// kernel must opt in first. `plan` is the layout that the caller computed
// (bytes, stacks in shared memory; samplers/nuts_cuda.py::poly_smem_plan
// for PolyGaussian), or bytes < 0 for none: a launch whose layout differs
// from its plan, or that is over a block's shared memory, is
// cudaErrorInvalidValue.
template <typename T, int NE, int KIND, class Dens>
cudaError_t launch_kernel(Args<T> a, const Dens& d, cudaStream_t s,
                          long long plan_bytes = -1, int plan_stk = 0) {
  int dev, n_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const LaunchShape sh = launch_shape(a.C, a.D, a.maxdepth, d.smem_elems(),
                                      sizeof(T), kPerWarp<Dens>, n_sm);
  a.warps = sh.warps;
  a.stk_smem = sh.stk_smem;
  if (sh.bytes > kMaxSmem ||
      (plan_bytes >= 0 &&
       ((long long)sh.bytes != plan_bytes || a.stk_smem != plan_stk)))
    return cudaErrorInvalidValue;
  const void* fn;
  if constexpr (KIND == kBlock)
    fn = (const void*)nuts_block_kernel<T, NE, Dens>;
  else
    fn = (const void*)nuts_chunk_kernel<T, NE, Dens, KIND == kWarmup>;
  if (sh.bytes > kDefaultSmem) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(sh.blocks), block(sh.warps * 32);
  if constexpr (KIND == kBlock)
    nuts_block_kernel<T, NE, Dens><<<grid, block, sh.bytes, s>>>(a, d);
  else
    nuts_chunk_kernel<T, NE, Dens, KIND == kWarmup>
        <<<grid, block, sh.bytes, s>>>(a, d);
  return cudaGetLastError();
}

// the arguments that no kernel takes: cudaErrorInvalidValue for C, D, K or
// the depth out of range (D in 1..256: a lane holds at most eight
// dimensions), or a pointer table of the wrong length for the kind
constexpr int kMaxD = 256;
inline cudaError_t check_launch(int kind, int C, int D, int K, int maxdepth,
                                int n_ptrs) {
  if (C < 1 || D < 1 || D > kMaxD || K < 1 || maxdepth < 1 ||
      maxdepth > 24)
    return cudaErrorInvalidValue;
  if (n_ptrs != (kind == kWarmup ? kPtrsWarmup : kPtrsFrozen))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace
