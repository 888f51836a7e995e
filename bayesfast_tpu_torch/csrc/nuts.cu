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
// :418-428, reproduced bit for bit.
//
// What bounds it on the card: a NUTS transition is a data-dependent chain of
// up to 2^maxdepth - 1 leapfrogs, each needing the previous one, with
// scalar-branched merges over a dynamically indexed checkpoint stack. At the
// bench shape (1024 chains, D = 32, f32) the work per leapfrog is tiny
// (two 32x32 matvecs, a handful of 32-wide dot products and one exp/log per
// dimension), so the kernel is bound by the latency of that dependent chain
// and by how many chains can hide it (1024 warps is under 8 warps per SM
// on 132 SMs), not by device-memory bytes or FLOPs.
//
// What the design does about it: one chain per warp, lanes over dimensions.
// Dot products are xor-butterfly shuffles (every lane ends with the same
// bits, so every branch stays warp-uniform), the matvecs are shuffle
// broadcasts against rows read from L1, and each chain retires on its own
// when its tree ends, instead of waiting for the slowest chain of a
// block-synchronous lane block as on the TPU. The checkpoint stack,
// maxdepth x (4D+3) values per chain (5.2 KB at D = 32, depth 10, f32), is
// global scratch that stays in L1/L2; it is zeroed at the start of every
// transition, as the TPU kernel does. Raising the chains in flight
// (several chains per warp), a shared-memory stack and tensor-core matvecs
// are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC --fmad=false   (see ../_build.py)
// --fmad=false and no fast math keep each elementwise operation rounded as
// the plain torch version rounds it; only sums are taken in another order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // chains (warps) per block
constexpr unsigned kFull = 0xffffffffu;

// ---- math overloads ------------------------------------------------------
__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_log(float x) { return logf(x); }
__device__ __forceinline__ double m_log(double x) { return log(x); }
__device__ __forceinline__ float m_log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double m_log1p(double x) { return log1p(x); }
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }

// ---- counter RNG (nuts_pallas.py:54-88, :418-428) -----------------------
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// f32 uniform in [0, 1) keyed by (seed, iteration, salt, row, global chain)
__device__ __forceinline__ float uniform(uint32_t seed, uint32_t it,
                                         uint32_t salt, uint32_t row,
                                         uint32_t chain) {
  uint32_t x = seed ^ (chain * 0x9E3779B9u) ^ (row * 0x7FEB352Du) ^
               (it * 0x85EBCA77u) ^ (salt * 0xC2B2AE3Du);
  x = fmix32(fmix32(x) + 0x165667B1u);
  return __uint_as_float((x >> 9) | 0x3F800000u) - 1.0f;
}

// f32 Box-Muller normal for momentum row `row` (counter -9, salts 16/17)
__device__ __forceinline__ float gauss(uint32_t seed, uint32_t row,
                                       uint32_t chain) {
  const uint32_t counter = 0xFFFFFFF7u;  // (uint32) -9
  float u1 = uniform(seed, counter, 16u, row, chain);
  float u2 = uniform(seed, counter, 17u, row, chain);
  float r = sqrtf(-2.0f * logf(1.0f - u1));
  return r * cosf(6.2831853071795862f * u2);
}

// ---- warp helpers --------------------------------------------------------
// xor butterfly: every lane adds the same pairs in the same order, so all
// lanes end with bitwise-equal sums (keeps branches warp-uniform)
template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// value of global dimension `idx` (per lane) of a lane-distributed vector
template <typename T, int NE>
__device__ __forceinline__ T fetch(const T (&v)[NE], int idx) {
  T out = T(0);
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    T a = __shfl_sync(kFull, v[e], idx & 31);
    if ((idx >> 5) == e) out = a;
  }
  return out;
}

template <typename T>
__device__ __forceinline__ T logaddexp(T a, T b) {  // jnp.logaddexp
  T amax = a > b ? a : b;
  T delta = a - b;
  if (isnan(delta)) return a + b;
  return amax + m_log1p(m_exp(-m_abs(delta)));
}

// ---- compiled-in densities (ops/densities.py) ----------------------------
// Each evaluates logp and its gradient at ORIGINAL-space x; lane `l` holds
// dimensions l, l+32, ...; invalid dimensions (>= D) hold and return 0.

template <typename T, int NE>
struct Banana {  // bench.py:139-145: z = A x, even-i banana terms
  const T* A;    // (D, D) row-major
  const T* AT;   // its transpose
  int D;
  T Q, cst;

  __device__ T operator()(const T (&x)[NE], T (&g)[NE]) const {
    const int lane = threadIdx.x & 31;
    T z[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) z[e] = T(0);
    // z_j = sum_k A[j, k] x_k, lanes over j: AT[k, j] is coalesced
#pragma unroll
    for (int e2 = 0; e2 < NE; ++e2)
      for (int kk = 0; kk < 32; ++kk) {
        const int k = e2 * 32 + kk;
        if (k >= D) break;  // uniform
        const T xk = __shfl_sync(kFull, x[e2], kk);
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          const int j = lane + 32 * e;
          if (j < D) z[e] += AT[k * D + j] * xk;
        }
      }
    T r[NE], part = T(0);
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int j = lane + 32 * e;
      const int n = j < D ? (j + 1) % D : 0;
      const T zn = fetch<T, NE>(z, n);
      r[e] = z[e] * z[e] - zn;
      if (j < D && (j % 2) == 0) {
        const T zm = z[e] - T(1);
        part += r[e] * r[e] / Q + zm * zm;
      }
    }
    const T logp = -warp_sum(part) - cst;
    // d t_i/d z_i = 4 z_i r_i / Q + 2 (z_i - 1) and d t_i/d z_{i+1} =
    // -2 r_i / Q, for even i
    T gz[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int j = lane + 32 * e;
      const int pv = j < D ? (j + D - 1) % D : 0;
      const T rp = fetch<T, NE>(r, pv);
      T own = T(0), nb = T(0);
      if (j < D && (j % 2) == 0)
        own = T(4) * z[e] * r[e] / Q + T(2) * (z[e] - T(1));
      if (j < D && (pv % 2) == 0) nb = T(-2) * rp / Q;
      gz[e] = j < D ? -(own + nb) : T(0);
    }
    // grad_k = sum_j A[j, k] gz_j, lanes over k: A[j, k] is coalesced
#pragma unroll
    for (int e = 0; e < NE; ++e) g[e] = T(0);
#pragma unroll
    for (int e2 = 0; e2 < NE; ++e2)
      for (int jj = 0; jj < 32; ++jj) {
        const int j = e2 * 32 + jj;
        if (j >= D) break;
        const T gzj = __shfl_sync(kFull, gz[e2], jj);
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          const int k = lane + 32 * e;
          if (k < D) g[e] += A[j * D + k] * gzj;
        }
      }
    return logp;
  }
};

template <typename T, int NE>
struct Gaussian {  // logp = -0.5 sum (x - mean)^2 / var
  const T* mean;
  const T* var;
  int D;

  __device__ T operator()(const T (&x)[NE], T (&g)[NE]) const {
    const int lane = threadIdx.x & 31;
    T part = T(0);
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int d = lane + 32 * e;
      g[e] = T(0);
      if (d < D) {
        const T dx = x[e] - mean[d];
        part += dx * dx / var[d];
        g[e] = -dx / var[d];
      }
    }
    return T(-0.5) * warp_sum(part);
  }
};

// ---- the fused bound transform (ops/constraint.py) plus a density ---------
template <typename T, int NE, class Dens>
struct TDensity {
  Dens dens;
  T lo[NE], width[NE], m_lohi[NE], m_lo[NE], m_hi[NE];
  T logw;
  bool valid[NE];

  // transformed-space logp and gradient: grad_t = grad_x * g + h
  __device__ T operator()(const T (&x)[NE], T (&gt)[NE]) const {
    T xo[NE], gg[NE], hh[NE], part = T(0);
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
      const T arg = m_lohi[e] * s1s + (T(1) - m_lohi[e]);
      if (valid[e]) part += m_log(arg) + (m_lo[e] + m_hi[e]) * x[e];
      gg[e] = (m_lohi[e] * s1s + (m_lo[e] - m_hi[e]) * ep + m_none) *
              width[e];
      hh[e] = m_lohi[e] * (T(1) - T(2) * s) + m_lo[e] + m_hi[e];
    }
    const T logdet = warp_sum(part) + logw;
    T gx[NE];
    const T logp = dens(xo, gx);
#pragma unroll
    for (int e = 0; e < NE; ++e) gt[e] = valid[e] ? gx[e] * gg[e] + hh[e] : T(0);
    return logp + logdet;
  }
};

// ---- kernel arguments ------------------------------------------------------
// Pointer table order (the wrapper in samplers/nuts_cuda.py builds it; the
// block kernel takes the frozen table, with K = 1 rows and q_final unused):
//  0 q0 (C,D)  1 var (C,D)  2 eps (C,)  3 sched (4,L) i32  4 tf (5,D)
//  5 density params  6 q (K,C,D)  7 logp  8 energy  9 energy_change
//  10 depth i32  11 size i32  12 accept_sum  13 max_de  14 diverging i32
//  15 q_final (C,D)  16 stack (C, n_lvl+1, 4D+3)
// warmup only:
//  17 wsched (2,K) i32  18..22 log_step log_bar hbar count mu (C,)
//  23 fg_mean 24 fg_raw (C,D) 25 fg_w (C,) 26 bg_mean 27 bg_raw 28 bg_w
//  29 step_size (K,C) 30 step_size_bar (K,C)  31..34 final log_step
//  log_bar hbar count  35 var 36 fg_mean 37 fg_raw 38 fg_w 39 bg_mean
//  40 bg_raw 41 bg_w
constexpr int kPtrsFrozen = 17;
constexpr int kPtrsWarmup = 42;

template <typename T>
struct Args {
  const T *q0, *var, *eps;
  const int* sched;
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

// join older/left t1 with newer/right t2 (nuts_pallas.py:180-209)
template <typename T, int NE>
__device__ __forceinline__ Frame<T, NE> merge(float u, const Frame<T, NE>& t1,
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
  const bool take2 = T(logf(u)) < t2.ls - m.ls;
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
template <typename T, int NE, class TD>
__device__ void transition(const Args<T>& a, const TD& lpg, uint32_t seed,
                           uint32_t chain, const T (&q0)[NE],
                           const T (&p0)[NE], T step, const T (&var)[NE],
                           T* stk, Result<T, NE>& out) {
  const int D = a.D;
  const int lane = threadIdx.x & 31;
  const int F = 4 * D + 3;
  const int n_lvl = a.maxdepth - 1 > 1 ? a.maxdepth - 1 : 1;
  const T max_change = a.max_change;

  // stale frames from the previous transition never leak: zero the stack
  for (int i = lane; i < (n_lvl + 1) * F; i += 32) stk[i] = T(0);
  __syncwarp();

  State<T, NE> cur;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    cur.q[e] = q0[e];
    cur.p[e] = p0[e];
    cur.cq[e] = T(0);
    cur.cp[e] = T(0);
  }
  cur.lp = lpg(cur.q, cur.g);
  const T e0 = T(0.5) * vdot(cur.p, var, cur.p) - cur.lp;
  cur.e = e0;
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
  const int* sched = a.sched;

  // a tree of depth maxdepth has a.L leaves: the loop ends by then even if
  // the schedule were wrong
  for (int it = 0; !done && it < a.L; ++it) {
    const float u0 = uniform(seed, (uint32_t)it, 0u, 0u, chain);
    const float u1 = uniform(seed, (uint32_t)it, 0u, 1u, chain);
    const float u2 = uniform(seed, (uint32_t)it, 0u, 2u, chain);

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
    nw.lp = lpg(nw.q, nw.g);
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const T y = dt * nw.g[e] - nw.cp[e];
      const T t = ph[e] + y;
      nw.cp[e] = (t - ph[e]) - y;
      nw.p[e] = t;
    }
    nw.e = T(0.5) * vdot(nw.p, var, nw.p) - nw.lp;

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

    const int pending = sched[it];
    const bool sub_done = sched[a.L + it] == 1;
    const int w_idx = sched[2 * a.L + it];

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
      inc = merge(u0, load_frame<T, NE>(stk, D), inc, 1, var, turned);
      for (int m = 1; m < pending && !turned; ++m) {
        const float um = uniform(
            seed, (uint32_t)(it * (a.maxdepth + 1) + m), 3u, 0u, chain);
        inc = merge(um, load_frame<T, NE>(stk + m * F, D), inc, m + 1, var,
                    turned);
      }
    }
    const bool abort = div || turned;
    // the frame of a finished subtree goes to the never-read sink level, and
    // an aborted tree reads nothing more: only live frames are stored
    if (!abort && !sub_done) store_frame(stk + w_idx * F, inc, D);
    if (abort || sub_done) depth += 1;
    if (abort) done = true;

    // ---- subtree completion ----
    if (sub_done && !abort) {
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

// chain c's checkpoint stack: max(maxdepth - 1, 1) + 1 frames
template <typename T>
__device__ __forceinline__ T* stack_of(const Args<T>& a, int c) {
  return a.stack + (size_t)c * (size_t)(a.maxdepth > 2 ? a.maxdepth : 2) *
                       (4 * a.D + 3);
}

template <typename T, int NE, class Dens, bool WARM>
__global__ void __launch_bounds__(kWarps * 32)
    nuts_chunk_kernel(Args<T> a, Dens dens) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= a.C) return;  // the whole warp leaves together
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
  T* stk = stack_of(a, c);

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
}

// One NUTS transition for this warp's chain under the bare seed (the port of
// _nuts_block_kernel, nuts_pallas.py:431-459): momenta gauss(seed, d, chain)
// and the tree's draws all under `seed`, no iteration fold. A launch with
// seed ^ fmix32(i0 + t + 0x9E3779B9) is therefore transition t of a chunk
// launch from the same start, bit for bit. The design is the chunk kernels'
// (one warp per chain, `transition` unchanged); the per-transition path
// adapts between launches. What bounds it: a launch lasts as long as its
// slowest chain's tree, up to 2^maxdepth - 1 dependent leapfrogs, where a
// K-transition chunk lets a chain's short trees make up for its long ones;
// so per transition it takes longer than a chunk.
template <typename T, int NE, class Dens>
__global__ void __launch_bounds__(kWarps * 32)
    nuts_block_kernel(Args<T> a, Dens dens) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= a.C) return;  // the whole warp leaves together
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
  transition<T, NE>(a, lpg, a.seed, chain, q, p0, a.eps[c], var,
                    stack_of(a, c), r);
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
  a.sched = (const int*)p[3];
  a.tf = (const T*)p[4];
  a.dpar = (const T*)p[5];
  a.q = (T*)p[6];
  a.logp = (T*)p[7];
  a.energy = (T*)p[8];
  a.de = (T*)p[9];
  a.depth = (int*)p[10];
  a.size = (int*)p[11];
  a.asum = (T*)p[12];
  a.mde = (T*)p[13];
  a.div = (int*)p[14];
  a.q_final = (T*)p[15];
  a.stack = (T*)p[16];
  if (warm) {
    a.wsched = (const int*)p[17];
    a.ls = (const T*)p[18];
    a.lb = (const T*)p[19];
    a.hb = (const T*)p[20];
    a.ct = (const T*)p[21];
    a.mu = (const T*)p[22];
    a.fgm = (const T*)p[23];
    a.fgr = (const T*)p[24];
    a.fgw = (const T*)p[25];
    a.bgm = (const T*)p[26];
    a.bgr = (const T*)p[27];
    a.bgw = (const T*)p[28];
    a.ss = (T*)p[29];
    a.ssb = (T*)p[30];
    a.ls_f = (T*)p[31];
    a.lb_f = (T*)p[32];
    a.hb_f = (T*)p[33];
    a.ct_f = (T*)p[34];
    a.var_f = (T*)p[35];
    a.fgm_f = (T*)p[36];
    a.fgr_f = (T*)p[37];
    a.fgw_f = (T*)p[38];
    a.bgm_f = (T*)p[39];
    a.bgr_f = (T*)p[40];
    a.bgw_f = (T*)p[41];
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

template <typename T, int NE, int KIND, class Dens>
void launch_kernel(const Args<T>& a, const Dens& d, cudaStream_t s) {
  const dim3 grid((a.C + kWarps - 1) / kWarps), block(kWarps * 32);
  if constexpr (KIND == kBlock)
    nuts_block_kernel<T, NE, Dens><<<grid, block, 0, s>>>(a, d);
  else
    nuts_chunk_kernel<T, NE, Dens, KIND == kWarmup>
        <<<grid, block, 0, s>>>(a, d);
}

template <typename T, int NE, int KIND>
cudaError_t launch_t(const Args<T>& a, int dens, cudaStream_t s) {
  if (dens == 0) {
    launch_kernel<T, NE, KIND>(
        a, Banana<T, NE>{a.dpar, a.dpar + (size_t)a.D * a.D, a.D, a.d0, a.d1},
        s);
  } else if (dens == 1) {
    launch_kernel<T, NE, KIND>(a, Gaussian<T, NE>{a.dpar, a.dpar + a.D, a.D},
                               s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, int NE>
cudaError_t launch_ne(int kind, const Args<T>& a, int dens, cudaStream_t s) {
  if (kind == kBlock) return launch_t<T, NE, kBlock>(a, dens, s);
  if (kind == kWarmup) return launch_t<T, NE, kWarmup>(a, dens, s);
  return launch_t<T, NE, kFrozen>(a, dens, s);
}

template <typename T>
cudaError_t launch_dtype(int kind, int dens, int C, int D, int K,
                         int maxdepth, uint32_t seed, uint32_t i0,
                         uint32_t cs, int as, int am, const double* f,
                         void* const* p, cudaStream_t s) {
  const Args<T> a = make_args<T>(C, D, K, maxdepth, seed, i0, cs, as, am, f,
                                 p, kind == kWarmup);
  return D <= 32 ? launch_ne<T, 1>(kind, a, dens, s)
                 : launch_ne<T, 2>(kind, a, dens, s);
}

// the checks both entry points share; cudaErrorInvalidValue for arguments
// the kernels do not take
cudaError_t launch(int kind, int f64, int dens, int C, int D, int K,
                   int maxdepth, uint32_t seed, uint32_t i0, uint32_t cs,
                   int as, int am, const double* f, void* const* p,
                   int n_ptrs, void* stream) {
  if (C < 1 || D < 1 || D > 64 || K < 1 || maxdepth < 1 || maxdepth > 24)
    return cudaErrorInvalidValue;
  if (n_ptrs != (kind == kWarmup ? kPtrsWarmup : kPtrsFrozen))
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    return launch_dtype<double>(kind, dens, C, D, K, maxdepth, seed, i0, cs,
                                as, am, f, p, s);
  return launch_dtype<float>(kind, dens, C, D, K, maxdepth, seed, i0, cs, as,
                             am, f, p, s);
}

}  // namespace

// K NUTS transitions (frozen, or warmup with adaptation) for C chains.
// Returns a cudaError_t; cudaErrorInvalidValue for arguments the kernels do
// not take (D outside 1..64, a malformed pointer table).
extern "C" int nuts_chunk_launch(int warmup, int f64, int dens, int C, int D,
                                 int K, int maxdepth, unsigned seed,
                                 unsigned i0, unsigned chain_start,
                                 int adapt_step, int adapt_metric,
                                 const double* fargs, void* const* ptrs,
                                 int n_ptrs, void* stream) {
  return (int)launch(warmup ? kWarmup : kFrozen, f64, dens, C, D, K, maxdepth,
                     seed, i0, chain_start, adapt_step, adapt_metric, fargs,
                     ptrs, n_ptrs, stream);
}

// One NUTS transition for C chains under the bare seed (the frozen pointer
// table, K = 1 rows). Returns a cudaError_t, as nuts_chunk_launch.
extern "C" int nuts_block_launch(int f64, int dens, int C, int D,
                                 int maxdepth, unsigned seed,
                                 unsigned chain_start, const double* fargs,
                                 void* const* ptrs, int n_ptrs,
                                 void* stream) {
  return (int)launch(kBlock, f64, dens, C, D, 1, maxdepth, seed, 0u,
                     chain_start, 0, 0, fargs, ptrs, n_ptrs, stream);
}

extern "C" const char* nuts_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
