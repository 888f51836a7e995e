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
// Registers and occupancy: the kernels are declared for one block of 8
// warps an SM (`__launch_bounds__(256, 1)`), so ptxas may give a thread up
// to 255 registers and has no reason to spill to reach a second block. A
// second block would not help: at C chains a launch has C / 8 blocks, one
// wave on 132 SMs up to C = 1056, and a block of the surrogate density
// (PolyGaussian) takes most of the SM's shared memory anyway. Above 1056
// chains a second wave of blocks starts only as blocks of the first
// finish.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC --fmad=false   (see ../_build.py)
// --fmad=false and no fast math keep each elementwise operation rounded as
// the plain torch version rounds it; the plain versions also take every sum
// in the kernels' order, so the two agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // chains (warps) per block
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // shared memory a block may use, sm_90
constexpr size_t kDefaultSmem = 48 * 1024;  // without an opt-in attribute

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

// three warp_sums at once: the same bits as three calls, with the three
// butterflies' shuffles in flight together
template <typename T>
__device__ __forceinline__ void warp_sum3(T& a, T& b, T& c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T sa = __shfl_xor_sync(kFull, a, o);
    const T sb = __shfl_xor_sync(kFull, b, o);
    const T sc = __shfl_xor_sync(kFull, c, o);
    a += sa;
    b += sb;
    c += sc;
  }
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

// 16-byte vectors of T, for shared-memory loads of 4 floats or 2 doubles
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static float at(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
  __device__ static double at(const double2& v, int i) {
    return i == 0 ? v.x : v.y;
  }
};

// ---- block-wide steps of the streamed PolyGaussian path ----------------
// 16-byte copy from device memory to shared memory that does not wait for
// its data (cp.async, through L2 only); a thread's copies are done, and
// visible to it, after cp_async_wait_all, and to the block after a barrier
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Barriers of all the block's threads that need not be the same
// instruction in every warp (no .aligned): a warp meets its block's
// others at them from a leapfrog, from the transition's first evaluation
// or from an idle pass. bar_count returns how many threads passed `pred`.
constexpr int kBarTile = 1, kBarTick = 2;
template <int ID>
__device__ __forceinline__ void bar_sync() {
  asm volatile("barrier.sync %0;\n" ::"n"(ID) : "memory");
}
template <int ID>
__device__ __forceinline__ int bar_count(bool pred) {
  int n;
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.u32 p, %1, 0;\n"
      " barrier.red.popc.u32 %0, %2, p;\n}\n"
      : "=r"(n)
      : "r"((unsigned)pred), "n"(ID)
      : "memory");
  return n;
}

// Row stride of a staged P x P matrix: 16 bytes of padding put the rows
// that one 16-byte load phase reads (8 lanes) on distinct banks.
template <typename T, int NE>
__host__ __device__ constexpr int row_stride() {
  return 32 * NE + 16 / (int)sizeof(T);
}

// Row stride, in T, of R staged coefficients a row: R padded to whole
// 16-byte vectors, and one vector more when their count is even, so that
// the 8 rows that one 16-byte load phase reads start on distinct 16-byte
// bank groups. 0 for R = 0. (samplers/nuts_cuda.py::_coef_stride)
template <typename T>
__host__ __device__ constexpr int coef_stride(int R) {
  constexpr int n = 16 / (int)sizeof(T);
  const int v = (R + n - 1) / n;
  return R <= 0 ? 0 : (v % 2 == 0 ? v + 1 : v) * n;
}

// y_j = sum_k M[j * S + k] x_k for this lane's j (lanes over j, S the row
// stride), M a matrix in shared memory with zeros past D, x zero past D,
// summed over k in order as ops/densities.py::_matvec_seq sums. x goes
// through the warp's buffer `xbuf`, so every lane reads x and its own row
// 16 bytes at a time; fully unrolled with no predicate, so every load and
// product is independent of the sum. A padded term is a signed zero, and
// adding one to a sum that started at +0 (it never becomes -0) changes no
// bit.
template <typename T, int NE>
__device__ __forceinline__ void matvec(const T* __restrict__ M,
                                       T* __restrict__ xbuf,
                                       const T (&x)[NE], T (&y)[NE]) {
  using V = Vec16<T>;
  constexpr int P = 32 * NE, S = row_stride<T, NE>();
  const int lane = threadIdx.x & 31;
  __syncwarp();  // every lane is done reading the buffer's last vector
#pragma unroll
  for (int e = 0; e < NE; ++e) xbuf[lane + 32 * e] = x[e];
  __syncwarp();
#pragma unroll
  for (int e = 0; e < NE; ++e) y[e] = T(0);
#pragma unroll
  for (int k0 = 0; k0 < P; k0 += V::n) {
    const typename V::type xv =
        *reinterpret_cast<const typename V::type*>(xbuf + k0);
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const typename V::type mv = *reinterpret_cast<const typename V::type*>(
          M + (lane + 32 * e) * S + k0);
#pragma unroll
      for (int i = 0; i < V::n; ++i) y[e] += V::at(mv, i) * V::at(xv, i);
    }
  }
}

// ---- compiled-in densities (ops/densities.py) ----------------------------
// Each evaluates its gradient at ORIGINAL-space x and returns this lane's
// part of the logp sum; `finish` turns the warp's sum of the parts into
// logp. Lane `l` holds dimensions l, l+32, ...; invalid dimensions (>= D)
// hold and return 0.
// `stage` copies the density's parameters into the block's shared memory
// (kSmem elements; every thread of the block takes part), `bind` points
// this thread's functor at them and sets its per-lane constants.

template <typename T, int NE>
struct Banana {  // bench.py:139-145: z = A x, even-i banana terms
  static constexpr int P = 32 * NE, S = row_stride<T, NE>();
  // A and A^T, zero-padded, row stride S; then each warp's x buffer
  static constexpr int kSmem = 2 * P * S + kWarps * P;
  __host__ __device__ size_t smem_elems() const { return kSmem; }
  const T* A;  // (D, D) row-major, device memory
  int D;
  T Q, cst;
  const T* sA;   // staged A: lane j reads row j
  const T* sAT;  // staged A^T: lane k reads row k, column k of A
  T* xbuf;       // this warp's P values
  int nxt[NE], prv[NE];  // this lane's wrapped neighbours j + 1, j - 1
  bool even[NE], prv_even[NE];

  __device__ void stage(T* smem) const {
    for (int i = threadIdx.x; i < P * P; i += blockDim.x) {
      const int r = i / P, c = i % P;
      const T v = (r < D && c < D) ? A[r * D + c] : T(0);
      smem[r * S + c] = v;
      smem[P * S + c * S + r] = v;
    }
  }

  __device__ void bind(T* smem) {
    const int lane = threadIdx.x & 31;
    sA = smem;
    sAT = smem + P * S;
    xbuf = smem + 2 * P * S + (threadIdx.x >> 5) * P;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int j = lane + 32 * e;
      nxt[e] = j < D ? (j + 1) % D : 0;
      prv[e] = j < D ? (j + D - 1) % D : 0;
      even[e] = j < D && (j % 2) == 0;
      prv_even[e] = j < D && (prv[e] % 2) == 0;
    }
  }

  __device__ T operator()(const T (&x)[NE], T (&g)[NE]) const {
    const int lane = threadIdx.x & 31;
    T xm[NE], z[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) xm[e] = lane + 32 * e < D ? x[e] : T(0);
    // z_j = sum_k A[j, k] x_k, lanes over j
    matvec<T, NE>(sA, xbuf, xm, z);
    T r[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) r[e] = z[e] * z[e] - fetch<T, NE>(z, nxt[e]);
    // d t_i/d z_i = 4 z_i r_i / Q + 2 (z_i - 1) and d t_i/d z_{i+1} =
    // -2 r_i / Q, for even i
    T gz[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const T rp = fetch<T, NE>(r, prv[e]);
      T own = T(0), nb = T(0);
      if (even[e]) own = T(4) * z[e] * r[e] / Q + T(2) * (z[e] - T(1));
      if (prv_even[e]) nb = T(-2) * rp / Q;
      gz[e] = lane + 32 * e < D ? -(own + nb) : T(0);
    }
    // grad_k = sum_j A^T[k, j] gz_j, lanes over k
    matvec<T, NE>(sAT, xbuf, gz, g);
    // the logp terms last: the gradient's path does not wait on them
    T part = T(0);
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      if (even[e]) {
        const T zm = z[e] - T(1);
        part += r[e] * r[e] / Q + zm * zm;
      }
    }
    return part;
  }

  __device__ T finish(T sum) const { return -sum - cst; }
};

template <typename T, int NE>
struct Gaussian {  // logp = -0.5 sum (x - mean)^2 / var
  static constexpr int kSmem = 0;
  __host__ __device__ size_t smem_elems() const { return kSmem; }
  const T* mean;
  const T* var;
  int D;
  T m[NE], v[NE];  // this lane's mean and variance

  __device__ void stage(T*) const {}

  __device__ void bind(T*) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int d = lane + 32 * e;
      m[e] = d < D ? mean[d] : T(0);
      v[e] = d < D ? var[d] : T(1);
    }
  }

  __device__ T operator()(const T (&x)[NE], T (&g)[NE]) const {
    const int lane = threadIdx.x & 31;
    T part = T(0);
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      g[e] = T(0);
      if (lane + 32 * e < D) {
        const T dx = x[e] - m[e];
        part += dx * dx / v[e];
        g[e] = -dx / v[e];
      }
    }
    return part;
  }

  __device__ T finish(T sum) const { return T(-0.5) * sum; }
};

// ---- the GBS evidence anchors (benchmarks/suite.py:60-95) ------------------
// Funnel, Ring and Cauchy take the place of the densities that
// _nuts_multi_kernel and _nuts_warmup_kernel (nuts_pallas.py:462, :746) trace
// in from examples/{funnel,ring,cauchy}_gbs.py. None stages anything in shared
// memory: a handful of constants per lane, set in `bind` from the parameter
// vector. Each is a few dozen operations a dimension, so a leapfrog's cost is
// the transition's own (the transform, the integrator, the butterflies):
// like the banana's, a launch is bound by its slowest chain's serial chain of
// leapfrogs. Every operation is that of ops/densities.py::_{funnel,ring,
// cauchy}_lpg, in its order.

// Neal's funnel (dpar: a^2, b, -2b, (D - 1) b; d0 = c0, d1 = const):
// logp = -x0^2 / (2 a^2) - S e^(-2 b x0) / 2 + c0 - (D - 1) b x0 - const,
// S = sum_{i >= 1} x_i^2. The gradient needs x0 on every lane (a broadcast
// from lane 0) and S on lane 0: a butterfly of its own, in the order of the
// one in `energy`, so the lane parts returned (the x_i^2) sum to the same S
// there and `finish` needs only x0 and the exponential of this evaluation.
template <typename T, int NE>
struct Funnel {
  static constexpr int kSmem = 0;
  __host__ __device__ size_t smem_elems() const { return kSmem; }
  const T* par;
  int D;
  T c0, cst;
  T a2, b, mb2, db;
  mutable T x0, ex;  // x0 and e^(-2 b x0) of the last evaluation

  __device__ void stage(T*) const {}

  __device__ void bind(T*) {
    a2 = par[0];
    b = par[1];
    mb2 = par[2];
    db = par[3];
  }

  __device__ T operator()(const T (&x)[NE], T (&g)[NE]) const {
    const int lane = threadIdx.x & 31;
    x0 = __shfl_sync(kFull, x[0], 0);
    ex = m_exp(mb2 * x0);
    T s = T(0);
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int d = lane + 32 * e;
      if (d >= 1 && d < D) s += x[e] * x[e];
    }
    const T S = warp_sum(s);
#pragma unroll
    for (int e = 0; e < NE; ++e)
      g[e] = lane + 32 * e < D ? -(x[e] * ex) : T(0);
    if (lane == 0) g[0] = (b * S * ex - x0 / a2) - db;
    return s;
  }

  __device__ T finish(T sum) const {
    return ((T(-0.5) * (x0 * x0 / a2) - T(0.5) * sum * ex) + (c0 - db * x0)) -
           cst;
  }
};

// The ring (dpar: a, b; d1 = const): r_j = (x_{j-1}^2 + x_j^2) - a, cyclic,
// logp = -sum r_j^2 / b - const, g_k = -(4 x_k (r_k + r_{k+1})) / b. At
// D > 32 a lane holds j and j + 32, so both neighbour terms cross lanes, and
// element 0's left one wraps to D - 1: the banana's wrapped indices and
// `fetch`.
template <typename T, int NE>
struct Ring {
  static constexpr int kSmem = 0;
  __host__ __device__ size_t smem_elems() const { return kSmem; }
  const T* par;
  int D;
  T a, b, cst;
  int nxt[NE], prv[NE];  // this lane's wrapped neighbours j + 1, j - 1

  __device__ void stage(T*) const {}

  __device__ void bind(T*) {
    const int lane = threadIdx.x & 31;
    a = par[0];
    b = par[1];
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int j = lane + 32 * e;
      nxt[e] = j < D ? (j + 1) % D : 0;
      prv[e] = j < D ? (j + D - 1) % D : 0;
    }
  }

  __device__ T operator()(const T (&x)[NE], T (&g)[NE]) const {
    const int lane = threadIdx.x & 31;
    T x2[NE], r[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) x2[e] = lane + 32 * e < D ? x[e] * x[e] : T(0);
#pragma unroll
    for (int e = 0; e < NE; ++e)
      r[e] = (fetch<T, NE>(x2, prv[e]) + x2[e]) - a;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const T rn = fetch<T, NE>(r, nxt[e]);
      g[e] = lane + 32 * e < D ? -(T(4) * x[e] * (r[e] + rn)) / b : T(0);
    }
    T part = T(0);
#pragma unroll
    for (int e = 0; e < NE; ++e)
      if (lane + 32 * e < D) part += r[e] * r[e] / b;
    return part;
  }

  __device__ T finish(T sum) const { return -sum - cst; }
};

// The bimodal Cauchy (dpar: a; d0 = D log(1 / (2 pi)), d1 = const): per
// element t = 1 / ((x + a)^2 + 1) + 1 / ((x - a)^2 + 1), logp = sum log t +
// d0 - const, g = -2 ((x + a) ta^2 + (x - a) tb^2) / t. Lanes past D (16-31
// of element 1 at D = 48) add nothing, as the plain version's zero padding
// adds exact zeros.
template <typename T, int NE>
struct Cauchy {
  static constexpr int kSmem = 0;
  __host__ __device__ size_t smem_elems() const { return kSmem; }
  const T* par;
  int D;
  T c0, cst, a;

  __device__ void stage(T*) const {}

  __device__ void bind(T*) { a = par[0]; }

  __device__ T operator()(const T (&x)[NE], T (&g)[NE]) const {
    const int lane = threadIdx.x & 31;
    T part = T(0);
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      g[e] = T(0);
      if (lane + 32 * e < D) {
        const T u = x[e] + a, v = x[e] - a;
        const T ta = T(1) / (u * u + T(1));
        const T tb = T(1) / (v * v + T(1));
        const T t = ta + tb;
        g[e] = T(-2) * (u * ta * ta + v * tb * tb) / t;
        part += m_log(t);
      }
    }
    return part;
  }

  __device__ T finish(T sum) const { return (sum + c0) - cst; }
};

// The surrogate density of a Recipe (ops/densities.py::poly_gaussian_spec):
// m = PolyModel(u) with any mix of linear, quadratic, cubic-2 and cubic-3
// configs on u = (x - lo) / diff (the PolyModel's input scales,
// bayesfast_tpu/core/module.py:83-101; lo = 0 and diff = 1 without, which
// leave x and the gradient as they are bit for bit), then the Gaussian
// log-likelihood -0.5 sum_j (m_j - d_j)^2 vinv_j + norm (diagonal) or
// -0.5 r' P r + norm, r = m - d (full: a precision matvec), with the
// PolyModel's linear extrapolation beyond its alpha-ellipsoid
// (bayesfast_tpu/modules/poly.py:319-341) and the Density's decay penalty
// -gamma max(dd' Hd dd - alpha_d^2, 0) (core/pipeline.py:470-474), and
// the analytic gradient of all of it. The bound and the features are in
// u-space: phi_f = (xa[i1_f] * xa[i2_f]) * xa[i3_f] over xa = [u0, 1]
// (index D is the 1, so a quadratic feature is times an exact 1);
// m = phi WT, WT (F, M). The gradient in u goes through a sparse row per
// dimension, an entry (f, partner 1, partner 2) for each place of the
// dimension in feature f's triple, then is divided by diff. The third
// index and the scales are read at run time: one library serves every
// order. In the chunk kernels this functor takes the place of the density
// that _nuts_multi_kernel and _nuts_warmup_kernel
// (bayesfast_tpu/samplers/nuts_pallas.py:462, :746) trace in from the JAX
// pipeline's surrogate.
//
// Work per evaluation: F M multiply-adds forward (lanes over outputs, a
// sum over the features in order each) and F M back (for each feature a
// lane partial over the lane's outputs, then the tree across lanes): two
// passes over WT, 2 F M sizeof(T) bytes (267 KB in f32 at the DES shape,
// F = 73, M = 457), where the rest of a leapfrog is a few thousand
// operations. So WT is staged in shared memory once per block: the first
// R features (R from the launch's plan, samplers/nuts_cuda.py::
// poly_smem_plan) transposed, output j's features as row j (stride
// `coef_stride`), so that a lane reads four of its output's features (two
// in f64) in one conflict-free 16-byte load, forward and back. When all
// of WT fits (R = F; the quadratic DES shape in f32) that is all: STREAM
// false. When it does not (the cubic surrogate, F = 238:
// 435 KB in f32, 870 KB in f64), STREAM: the features past R stream
// through two shared-memory tiles of TW features (32 in f32, 16 in f64),
// transposed like the staged rows, copied from L2 once per block and
// leapfrog for the block's eight chains (`load_tile`), where each chain
// used to read them itself; the tiles take their room from the staged
// features, and the block's warps evaluate in lockstep ticks (see "the
// streamed tiles" below). The arithmetic is that of the plain version
// (ops/densities.py::_poly_gaussian_lpg): each output's forward sum over
// the features in order (the staged ones, then the tiles in order; kOut
// outputs a pass, each its own accumulator, kept in the warp's gbuf
// between tiles), each feature's back-pass partial over the lane's
// outputs in order, then the halving tree of `warp_sum` (`reduce8`); so
// the draws are bit for bit those of every earlier version.
// What bounds it on the card: the dependent latency of one warp's loads and
// sums, about 0.25 us a feature and leapfrog on the slowest chain, as long
// alone as beside seven other warps. All staged (H100 80GB HBM3, 700 W;
// chip_smoke.py --ab): 16.5-19.3 us a leapfrog in f32 at F = 73. Two things
// made most of that: loads that wait on no branch (every loop over outputs
// runs a warp-uniform count, an output past M reads row M - 1 and is dropped),
// and the tree across lanes through shared memory in place of 40 shuffles a
// group of eight features. At F = 238 with each chain reading the unstaged
// features from L2 (tile 0 in chip_smoke.py [13b]): 97-103 us in f32, 176-196
// us in f64, the latency of those reads. Streamed (NVIDIA H100 80GB HBM3,
// 700.00 W; chip_smoke.py [13b]): 56.1-56.6 us a leapfrog in f32 (K = 4 chunks
// 14.22 / 17.74 ms, frozen / warmup), 137-139 us in f64 (34.72 / 43.82 ms); L2
// bytes a leapfrog and block 4.27 -> 0.58 MB in f32, 12.2 -> 1.52 MB in f64.
// The sums' latency bounds it again, near the ~60 us that 238 features take at
// the staged rate. The swizzle is the lane's own (`swl`): computed per row,
// its two integer divides made tiles of fewer than 8 vectors a row 2-3x
// slower. Tiles of 8 / 16 / 32 features take 63.5 / 58.6-59.4 / 56.6 us in
// f32, 166-169 / 137-138 us for 8 / 16 in f64: fewer tiles, fewer barriers.
// Beside WT: the two D x D Hessians, staged for `matvec`, the input
// scales, each warp's exchange buffers (x, xa, phi with zeros to whole
// vectors, its gradient, the outputs' gradients; with a full precision
// also r and m0 - f_mu) and the integer tables. P (M x M, 835 KB in f32
// at M = 457) is read from device memory, one row of it for each k, as
// each lane's outputs sum over k in order.
template <typename T, int NE, bool STREAM>
struct PolyGaussian {
  static constexpr int P = 32 * NE, S = row_stride<T, NE>();
  // outputs a forward pass (8 in f32 at D <= 32, 4 at D > 32; 1 in f64,
  // where two or four spill at D <= 32 and one is the fastest that does
  // not, PERF.md), features a back-pass group (`reduce8`) and the back
  // pass's outputs in flight at once (one in f64, whose registers are
  // full)
  static constexpr int kOut = sizeof(T) == 4 ? 8 / NE : 1;
  static constexpr int kBack = 8;
  static constexpr int kBackUnroll = sizeof(T) == 4 ? 4 : 1;
  static constexpr int kVec = Vec16<T>::n;
  const T* par;  // packed parameters, device memory (see `locate`)
  int D, M, F, NNZ;
  int R, RS;  // features staged in shared memory, their row stride
  // STREAM: features a tile (TW, a multiple of kBack), tiles (NT) of the
  // features R.. and 16-byte vectors a tile row (TW / kVec)
  int TW, NT, NVT;
  // The 16-byte vector of tile row j that holds features kVec v .. is v ^
  // swz(j), swz(j) = j mod 8 for NVT >= 8, else (j / (8 / NVT)) mod NVT
  // (NVT a power of two or a multiple of 8): the 8 rows of one 16-byte
  // load phase then read distinct 16-byte bank groups. A pass reads rows
  // lane + 32 t, whose swz is the lane's own: `swl`, set once (a row
  // clamped to M - 1 reads another of its vectors, and is dropped).
  int swl;
  bool bound_on, decay_on, full;
  T nrm, gamma, alpha, alpha2;
  const T *WT, *dat, *vinv, *fmu, *mup, *Hp, *mud, *Hd, *slo, *sdf, *Pm,
      *ints, *tiles;
  T mp[NE], md[NE];  // this lane's bound and decay centres
  mutable T dec;     // the decay penalty of the last evaluation

  __host__ __device__ static int up4(int n) { return (n + 3) & ~3; }
  __host__ __device__ int n_ints() const { return 3 * F + D + 1 + 3 * NNZ; }
  // phi's length: the streamed tiles read features up to R + NT TW
  __host__ __device__ int n_phi() const {
    return up4(STREAM ? R + NT * TW : F);
  }
  __host__ __device__ int warp_elems() const {
    return P + up4(P + 1) + n_phi() + up4(F) + 32 * kBack +
           (full ? 3 : 1) * up4(M);
  }
  __host__ __device__ int int_elems() const {
    return up4((n_ints() * 4 + (int)sizeof(T) - 1) / (int)sizeof(T));
  }
  // layout: Hp, Hd, the scales (lo, then diff; 0 and 1 past D), the
  // warps' buffers, the integer tables, staged WT, and when STREAM the two
  // tile buffers (M rows of TW each)
  __host__ __device__ int coef_offset() const {
    return 2 * P * S + 2 * P + kWarps * warp_elems() + int_elems();
  }
  __host__ __device__ int tile_elems() const { return STREAM ? M * TW : 0; }
  __host__ __device__ size_t smem_elems() const {
    return coef_offset() + (size_t)M * RS + 2 * (size_t)tile_elems();
  }

  // this warp's part of the block's shared memory (the layout above),
  // addressed from the shared-memory symbol itself where it is used, so
  // that every access compiles to a shared-memory one and no store to a
  // buffer can alias the functor's own fields
  struct Bufs {
    const T *Hp, *Hd, *lo, *dv, *W;
    T *x, *xa, *phi, *gphi, *red, *g, *r, *m, *tb;
    const int *i1, *i2, *i3, *rp, *cf, *c1, *c2;
  };
  __device__ __forceinline__ Bufs bufs() const {
    extern __shared__ __align__(16) unsigned char g_smem[];
    T* const sm = reinterpret_cast<T*>(g_smem);
    Bufs b;
    b.Hp = sm;
    b.Hd = sm + P * S;
    b.lo = sm + 2 * P * S;
    b.dv = b.lo + P;
    b.x = sm + 2 * P * S + 2 * P + (threadIdx.x >> 5) * warp_elems();
    b.xa = b.x + P;
    b.phi = b.xa + up4(P + 1);
    b.gphi = b.phi + n_phi();
    b.red = b.gphi + up4(F);
    b.g = b.red + 32 * kBack;
    b.r = b.g + up4(M);
    b.m = b.r + up4(M);
    b.i1 = reinterpret_cast<const int*>(b.dv + P + kWarps * warp_elems());
    b.i2 = b.i1 + F;
    b.i3 = b.i2 + F;
    b.rp = b.i3 + F;
    b.cf = b.rp + D + 1;
    b.c1 = b.cf + NNZ;
    b.c2 = b.c1 + NNZ;
    b.W = sm + coef_offset();
    b.tb = sm + coef_offset() + (size_t)M * RS;
    return b;
  }

  // offsets of the packed vector: WT, dat, vinv, fmu, mup, Hp, mud, Hd,
  // lo, diff, P (full precision only), then the integer tables i1, i2,
  // i3, rowptr, cf, c1, c2 (as T values)
  __host__ void locate() {
    WT = par;
    dat = WT + (size_t)F * M;
    vinv = dat + M;
    fmu = vinv + M;
    mup = fmu + M;
    Hp = mup + D;
    mud = Hp + D * D;
    Hd = mud + D;
    slo = Hd + D * D;
    sdf = slo + D;
    Pm = sdf + D;
    ints = Pm + (full ? (size_t)M * M : 0);
    // the tiles (samplers/nuts_cuda.py::_stream_tiles) start at the next
    // multiple of 32 elements after the integer tables
    tiles = par + (((size_t)(ints - par) + n_ints() + 31) / 32 * 32);
  }

  __device__ void stage(T* smem) const {
    for (int i = threadIdx.x; i < P * P; i += blockDim.x) {
      const int r = i / P, c = i % P;
      const bool in = r < D && c < D;
      smem[r * S + c] = in ? Hp[r * D + c] : T(0);
      smem[P * S + r * S + c] = in ? Hd[r * D + c] : T(0);
    }
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
      smem[2 * P * S + i] = i < D ? slo[i] : T(0);
      smem[2 * P * S + P + i] = i < D ? sdf[i] : T(1);
    }
    int* ip = reinterpret_cast<int*>(smem + 2 * P * S + 2 * P +
                                     kWarps * warp_elems());
    for (int i = threadIdx.x; i < n_ints(); i += blockDim.x)
      ip[i] = (int)ints[i];
    // WT's first R features, transposed, zero-padded to whole vectors
    T* sw = smem + coef_offset();
    const int Rp = (R + Vec16<T>::n - 1) / Vec16<T>::n * Vec16<T>::n;
    for (int i = threadIdx.x; i < Rp * M; i += blockDim.x) {
      const int f = i / M, j = i - f * M;
      sw[j * RS + f] = f < R ? WT[(size_t)f * M + j] : T(0);
    }
    if constexpr (STREAM) {
      // tiles 0 and 1 in buffers 0 and 1, where every evaluation finds them
      T* tb = sw + (size_t)M * RS;
      const int n = (NT > 1 ? 2 : 1) * tile_elems();
      for (int i = threadIdx.x; i < n; i += blockDim.x) tb[i] = tiles[i];
    }
  }

  __device__ void bind(T*) {
    const int lane = threadIdx.x & 31;
    // phi past F: zeros, which meet the staged padding's and the last
    // tile's zeros
    T* const phi = bufs().phi;
    for (int f = F + lane; f < n_phi(); f += 32) phi[f] = T(0);
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int d = lane + 32 * e;
      mp[e] = d < D ? mup[d] : T(0);
      md[e] = d < D ? mud[d] : T(0);
    }
    if (STREAM) swl = NVT >= 8 ? (lane & 7) : (lane / (8 / NVT)) & (NVT - 1);
  }

  // ---- the streamed tiles (STREAM) ----
  // Tile t holds features R + t TW .. of every output, transposed like the
  // staged rows (output j's TW features as row j), and lives in buffer
  // t & 1. An evaluation is one tick of the block: a forward pass over
  // the tiles up (0 .. NT - 1), then a back pass down (NT - 1 .. 0), so
  // that a pass starts on the two tiles that the last one ended on; every
  // step after a pass's first waits for its tile and starts the copy of
  // the next one into the buffer that the step before read. Every warp of
  // the block takes the same barriers in the same order, those with no
  // leapfrog due in an idle tick (`drain`).

  // every thread's part of tile t's copy into buffer t & 1
  __device__ __forceinline__ void load_tile(int t) const {
    T* const dst = bufs().tb + (t & 1) * tile_elems();
    const T* const src = tiles + (size_t)t * tile_elems();
    for (int i = threadIdx.x * kVec; i < tile_elems(); i += kWarps * 32 * kVec)
      cp_async16(dst + i, src + i);
    cp_async_commit();
  }
  // a step of a pass after its first: this thread's copies are done, then
  // the block's (the step's tile has arrived, and every warp is done with
  // the buffer that tile `next` takes); next's copy starts (none out of
  // range)
  __device__ __forceinline__ void tile_step(int next) const {
    cp_async_wait_all();
    bar_sync<kBarTile>();
    if (next >= 0 && next < NT) load_tile(next);
  }
  // the start of a tick; true while a warp of the block has work
  __device__ __forceinline__ bool tick(bool work) const {
    return bar_count<kBarTick>(work) != 0;
  }
  // idle ticks, until no warp of the block has work: every warp calls it
  // once after its last evaluation
  __device__ void drain() const {
    if constexpr (STREAM) {
      while (tick(false)) {
        for (int k = 1; k < NT; ++k) tile_step(k + 1);
        for (int k = 1; k < NT; ++k) tile_step(NT - 2 - k);
      }
    }
  }

  // gphi[f0 + f] (f < 8, f0 + f < lim) from each lane's partials s of
  // eight features: the halving tree that `warp_sum` takes over the 32
  // lanes' partials (x_l + x_{l+16}, then + 8, + 4, + 2, + 1), taken
  // across lanes through the warp's scratch `red`: lane (q, f) = (lane / 8,
  // lane % 8) halves feature f's partials l = q, q + 4, ..., q + 28 to the
  // tree's node over l = q mod 4, and two shuffles join the four quarters.
  // Every node adds the operands of a butterfly's node, so the bits are a
  // butterfly's, with 2 shuffles a group instead of 40.
  __device__ __forceinline__ void reduce8(const T (&s)[kBack], T* red,
                                          T* gphi, int f0, int lim) const {
    static_assert(kBack == 8, "the tree's lanes are 4 quarters x 8 features");
    const int lane = threadIdx.x & 31, fq = lane & 7, q = lane >> 3;
    __syncwarp();  // the last group's tree has read the scratch
#pragma unroll
    for (int b = 0; b < kBack; ++b) red[lane * kBack + b] = s[b];
    __syncwarp();
    T y[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) y[k] = red[(4 * k + q) * kBack + fq];
#pragma unroll
    for (int k = 0; k < 4; ++k) y[k] += y[k + 4];
    y[0] += y[2];
    y[1] += y[3];
    T t = y[0] + y[1];
    t += __shfl_xor_sync(kFull, t, 16);
    t += __shfl_xor_sync(kFull, t, 8);
    if (q == 0 && f0 + fq < lim) gphi[f0 + fq] = t;
  }

  __device__ T operator()(const T (&x)[NE], T (&g)[NE]) const {
    const int lane = threadIdx.x & 31;
    const Bufs b = bufs();
    const T *const sHp = b.Hp, *const sHd = b.Hd, *const sW = b.W;
    T *const xbuf = b.x, *const xa = b.xa, *const phi = b.phi;
    T *const gphi = b.gphi, *const gbuf = b.g, *const rbuf = b.r;
    T *const mbuf = b.m, *const red = b.red;
    const int *const si1 = b.i1, *const si2 = b.i2, *const si3 = b.i3;
    const int *const srp = b.rp, *const scf = b.cf, *const sc1 = b.c1;
    const int *const sc2 = b.c2;
    // x0: u = (x - lo) / diff, then projected onto the bound
    T xm[NE], x0[NE], hdel[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int d = lane + 32 * e;
      xm[e] = d < D ? x[e] : T(0);
      x0[e] = (xm[e] - b.lo[d]) / b.dv[d];
      hdel[e] = T(0);
    }
    // the bound: beta^2 = delta' Hp delta, warp-uniform
    bool outside = false;
    T beta = T(1);
    if (bound_on) {
      T del[NE];
#pragma unroll
      for (int e = 0; e < NE; ++e) del[e] = x0[e] - mp[e];
      matvec<T, NE>(sHp, xbuf, del, hdel);
      T s = T(0);
#pragma unroll
      for (int e = 0; e < NE; ++e) s += del[e] * hdel[e];
      T b2 = warp_sum(s);
      b2 = b2 < T(1e-30) ? T(1e-30) : b2;
      beta = m_sqrt(b2);
      outside = beta > alpha;
      if (outside) {
#pragma unroll
        for (int e = 0; e < NE; ++e)
          x0[e] = (alpha * x0[e] + (beta - alpha) * mp[e]) / beta;
      }
    }
    __syncwarp();  // the buffers' last readers are done
#pragma unroll
    for (int e = 0; e < NE; ++e)
      if (lane + 32 * e < D) xa[lane + 32 * e] = x0[e];
    if (lane == 0) xa[D] = T(1);
    __syncwarp();
    for (int f = lane; f < F; f += 32)
      phi[f] = (xa[si1[f]] * xa[si2[f]]) * xa[si3[f]];
    __syncwarp();
    // m_j = sum_f WT[f, j] phi_f in order of f, kOut of the lane's outputs
    // a pass: the staged features 16 bytes at a time (a padded feature is
    // 0 * 0, and adding +0 to a sum that started at +0 changes no bit),
    // then the rest from device memory; then the likelihood and
    // d logp / d m0. The passes are warp-uniform, and an output past M
    // reads output M - 1's row and is dropped, so that no load waits on a
    // branch.
    using V = Vec16<T>;
    using VT = typename V::type;
    const int Rp = (R + V::n - 1) / V::n * V::n;
    T part = T(0), sb = T(0);
    // the staged features' sums (STREAM: kept in gbuf, then the tiles'
    // added in order)
    auto staged = [&](const int (&jc)[kOut], T (&acc)[kOut]) {
#pragma unroll 2
      for (int f0 = 0; f0 < Rp; f0 += V::n) {
        const VT pv = *reinterpret_cast<const VT*>(phi + f0);
#pragma unroll
        for (int u = 0; u < kOut; ++u) {
          const VT wv = *reinterpret_cast<const VT*>(sW + jc[u] * RS + f0);
#pragma unroll
          for (int i = 0; i < V::n; ++i)
            acc[u] += V::at(wv, i) * V::at(pv, i);
        }
      }
    };
    if constexpr (STREAM) {
      for (int p0 = 0; p0 < M; p0 += 32 * kOut) {
        const int j0 = p0 + lane;
        int jc[kOut];
        T acc[kOut];
#pragma unroll
        for (int u = 0; u < kOut; ++u) {
          jc[u] = min(j0 + 32 * u, M - 1);
          acc[u] = T(0);
        }
        staged(jc, acc);
#pragma unroll
        for (int u = 0; u < kOut; ++u)
          if (j0 + 32 * u < M) gbuf[j0 + 32 * u] = acc[u];
      }
      tick(true);
      for (int k = 0; k < NT; ++k) {
        if (k) tile_step(k + 1);
        const T* const tw = b.tb + (k & 1) * tile_elems();
        const T* const ph = phi + R + k * TW;
        for (int p0 = 0; p0 < M; p0 += 32 * kOut) {
          const int j0 = p0 + lane;
          int jc[kOut];
          T acc[kOut];
#pragma unroll
          for (int u = 0; u < kOut; ++u) {
            jc[u] = min(j0 + 32 * u, M - 1);
            acc[u] = gbuf[jc[u]];
          }
#pragma unroll 2
          for (int v = 0; v < NVT; ++v) {
            const VT pv = *reinterpret_cast<const VT*>(ph + v * V::n);
#pragma unroll
            for (int u = 0; u < kOut; ++u) {
              const VT wv = *reinterpret_cast<const VT*>(
                  tw + jc[u] * TW + (v ^ swl) * V::n);
#pragma unroll
              for (int i = 0; i < V::n; ++i)
                acc[u] += V::at(wv, i) * V::at(pv, i);
            }
          }
#pragma unroll
          for (int u = 0; u < kOut; ++u)
            if (j0 + 32 * u < M) gbuf[j0 + 32 * u] = acc[u];
        }
      }
    }
    for (int p0 = 0; p0 < M; p0 += 32 * kOut) {
      const int j0 = p0 + lane;
      int jc[kOut];
      T acc[kOut];
#pragma unroll
      for (int u = 0; u < kOut; ++u) {
        jc[u] = min(j0 + 32 * u, M - 1);
        acc[u] = STREAM ? gbuf[jc[u]] : T(0);
      }
      if constexpr (!STREAM) {
        staged(jc, acc);
        for (int f = R; f < F; ++f) {
          const T ph = phi[f];
          const T* w = WT + (size_t)f * M;
#pragma unroll
          for (int u = 0; u < kOut; ++u) acc[u] += __ldg(w + jc[u]) * ph;
        }
      }
#pragma unroll
      for (int u = 0; u < kOut; ++u) {
        const int j = j0 + 32 * u;
        // loaded before the branch, so that they need not wait on it
        const T dv = __ldg(dat + jc[u]), vv = __ldg(vinv + jc[u]);
        const T fv = __ldg(fmu + jc[u]);  // zeros without the bound
        if (j < M) {
          const T m0 = acc[u];
          const T fm = outside ? fv : T(0);
          const T m = outside ? (beta * m0 - (beta - alpha) * fm) / alpha : m0;
          const T r = m - dv;
          if (full) {  // the likelihood waits for every r (below)
            rbuf[j] = r;
            if (outside) mbuf[j] = m0 - fm;
          } else {
            const T rv = r * vv;
            part += rv * r;
            const T gm = -rv;
            gbuf[j] = outside ? gm * beta / alpha : gm;
            if (outside) sb += gm * (m0 - fm);
          }
        }
      }
    }
    if (full) {
      // (P r)_j = sum_k P[k, j] r_k in order of k (P symmetric: row k of
      // P is its column k, read coalesced), four of the lane's outputs at
      // a time; then the likelihood and d logp / d m0
      __syncwarp();
      for (int j0 = lane; j0 < M; j0 += 128) {
        T acc[4] = {T(0), T(0), T(0), T(0)};
        for (int k = 0; k < M; ++k) {
          const T rk = rbuf[k];
          const T* p = Pm + (size_t)k * M + j0;
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (j0 + 32 * u < M) acc[u] += __ldg(p + 32 * u) * rk;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + 32 * u;
          if (j < M) {
            part += rbuf[j] * acc[u];
            const T gm = -acc[u];
            gbuf[j] = outside ? gm * beta / alpha : gm;
            if (outside) sb += gm * mbuf[j];
          }
        }
      }
    }
    __syncwarp();
    // d logp / d phi_f = sum_j WT[f, j] gm0_j: the lane's outputs in
    // order, then the tree across lanes (`reduce8`), eight features a
    // group: the staged ones first (each output's row 16 bytes at a time),
    // then the rest from device memory. Warp-uniform trip counts: a lane
    // past M adds WT * 0, a signed zero, which changes no bit of a sum
    // that started at +0; a vector or feature past the end reads the last
    // one again, and its sums are dropped.
    constexpr int NV = kBack / V::n;
    const int nj = (M + 31) / 32;
    if constexpr (STREAM) {
      // the tiles first, down from the last (each feature's sum is its
      // own: their order changes no bit)
      for (int k = 0; k < NT; ++k) {
        const int t = NT - 1 - k;
        if (k) tile_step(t - 1);
        const T* const tw = b.tb + (t & 1) * tile_elems();
        for (int g0 = 0; g0 < TW; g0 += kBack) {
          T s[kBack];
#pragma unroll
          for (int i = 0; i < kBack; ++i) s[i] = T(0);
          const int v0 = g0 / V::n;
#pragma unroll (kBackUnroll)
          for (int tt = 0; tt < nj; ++tt) {
            const int j = lane + 32 * tt, jr = min(j, M - 1);
            const T gj = j < M ? gbuf[jr] : T(0);
            const T* w = tw + jr * TW;
#pragma unroll
            for (int v = 0; v < NV; ++v) {
              const VT wv = *reinterpret_cast<const VT*>(
                  w + ((v0 + v) ^ swl) * V::n);
#pragma unroll
              for (int i = 0; i < V::n; ++i)
                s[v * V::n + i] += V::at(wv, i) * gj;
            }
          }
          reduce8(s, red, gphi, R + t * TW + g0, F);
        }
      }
    }
    for (int f0 = 0; f0 < Rp; f0 += kBack) {
      T s[kBack];
      int col[NV];
#pragma unroll
      for (int i = 0; i < kBack; ++i) s[i] = T(0);
#pragma unroll
      for (int v = 0; v < NV; ++v) col[v] = min(f0 + v * V::n, Rp - V::n);
#pragma unroll (kBackUnroll)
      for (int t = 0; t < nj; ++t) {
        const int j = lane + 32 * t, jr = min(j, M - 1);
        const T gj = j < M ? gbuf[jr] : T(0);
        const T* w = sW + jr * RS;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const VT wv = *reinterpret_cast<const VT*>(w + col[v]);
#pragma unroll
          for (int i = 0; i < V::n; ++i)
            s[v * V::n + i] += V::at(wv, i) * gj;
        }
      }
      reduce8(s, red, gphi, f0, R);
    }
    for (int f0 = R; !STREAM && f0 < F; f0 += kBack) {
      T s[kBack];
#pragma unroll
      for (int i = 0; i < kBack; ++i) s[i] = T(0);
      for (int t = 0; t < nj; ++t) {
        const int j = lane + 32 * t, jr = min(j, M - 1);
        const T gj = j < M ? gbuf[jr] : T(0);
#pragma unroll
        for (int i = 0; i < kBack; ++i)
          s[i] += __ldg(WT + (size_t)min(f0 + i, F - 1) * M + jr) * gj;
      }
      reduce8(s, red, gphi, f0, F);
    }
    __syncwarp();
    // d logp / d x0_d over the dimension's sparse row, in order
    T g0[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int d = lane + 32 * e;
      T s = T(0);
      if (d < D)
        for (int t = srp[d]; t < srp[d + 1]; ++t)
          s += gphi[scf[t]] * (xa[sc1[t]] * xa[sc2[t]]);
      g0[e] = s;
    }
    if (outside) {
      // through x0(x, beta(x)) and the beta of the extrapolated output
      T dt = T(0);
#pragma unroll
      for (int e = 0; e < NE; ++e) dt += g0[e] * (mp[e] - x0[e]);
      for (int o = 16; o > 0; o >>= 1) {
        const T a1 = __shfl_xor_sync(kFull, sb, o);
        const T a2 = __shfl_xor_sync(kFull, dt, o);
        sb += a1;
        dt += a2;
      }
      const T s_beta = sb / alpha;
      const T dldb = s_beta + dt / beta;
#pragma unroll
      for (int e = 0; e < NE; ++e)
        g[e] = g0[e] * alpha / beta + dldb * hdel[e] / beta;
    } else {
#pragma unroll
      for (int e = 0; e < NE; ++e) g[e] = g0[e];
    }
    // from u to x
#pragma unroll
    for (int e = 0; e < NE; ++e) g[e] = g[e] / b.dv[lane + 32 * e];
    dec = T(0);
    if (decay_on) {
      T dd[NE], hdd[NE];
#pragma unroll
      for (int e = 0; e < NE; ++e) dd[e] = xm[e] - md[e];
      matvec<T, NE>(sHd, xbuf, dd, hdd);
      T s = T(0);
#pragma unroll
      for (int e = 0; e < NE; ++e) s += dd[e] * hdd[e];
      const T ex = warp_sum(s) - alpha2;
      if (ex > T(0)) {
        dec = gamma * ex;
#pragma unroll
        for (int e = 0; e < NE; ++e) g[e] = g[e] - gamma * (T(2) * hdd[e]);
      }
    }
    return part;
  }

  __device__ T finish(T sum) const { return (T(-0.5) * sum + nrm) - dec; }
};

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
  int stk_smem;  // 1: the checkpoint stacks are in shared memory
  uint32_t seed, i0, chain_start;
  T max_change, logw, d0, d1, target, gamma, kexp, t0;
  int adapt_step, adapt_metric;
};

// frames per chain: a frame is stored at level `pending` of a leaf that does
// not finish its subtree, at most maxdepth - 2
__host__ __device__ __forceinline__ int n_levels(int maxdepth) {
  return maxdepth - 1 > 1 ? maxdepth - 1 : 1;
}

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
// (PolyGaussian's streamed path) keeps a warp in idle ticks after its last
// evaluation until every warp of the block is done (`drain`); for the
// others this is nothing.
template <class Dens>
__device__ __forceinline__ auto drain(const Dens& d, int)
    -> decltype(d.drain()) {
  d.drain();
}
template <class Dens>
__device__ __forceinline__ void drain(const Dens&, long) {}

template <typename T, int NE, class Dens, bool WARM>
__global__ void __launch_bounds__(kWarps * 32, 1)
    nuts_chunk_kernel(Args<T> a, Dens dens) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
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
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
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

// Shared memory of a launch: the density's parameters, plus every warp's
// checkpoint stack when all of it fits in a block's shared memory (at depth
// 10 it does for the banana and the Gaussian at every dtype and D <= 64);
// else the stacks stay in global scratch. Above 48 KB the kernel must opt
// in first. `plan` is the layout that the caller computed (bytes, stacks in
// shared memory; samplers/nuts_cuda.py::poly_smem_plan for PolyGaussian),
// or bytes < 0 for none: a launch whose layout differs from its plan, or
// that is over a block's shared memory, is cudaErrorInvalidValue.
template <typename T, int NE, int KIND, class Dens>
cudaError_t launch_kernel(Args<T> a, const Dens& d, cudaStream_t s,
                          long long plan_bytes = -1, int plan_stk = 0) {
  const size_t frames = (size_t)n_levels(a.maxdepth) * (4 * a.D + 3);
  size_t bytes = (d.smem_elems() + kWarps * frames) * sizeof(T);
  a.stk_smem = bytes <= kMaxSmem ? 1 : 0;
  if (!a.stk_smem) bytes = d.smem_elems() * sizeof(T);
  if (bytes > kMaxSmem ||
      (plan_bytes >= 0 &&
       ((long long)bytes != plan_bytes || a.stk_smem != plan_stk)))
    return cudaErrorInvalidValue;
  const void* fn;
  if constexpr (KIND == kBlock)
    fn = (const void*)nuts_block_kernel<T, NE, Dens>;
  else
    fn = (const void*)nuts_chunk_kernel<T, NE, Dens, KIND == kWarmup>;
  if (bytes > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.C + kWarps - 1) / kWarps), block(kWarps * 32);
  if constexpr (KIND == kBlock)
    nuts_block_kernel<T, NE, Dens><<<grid, block, bytes, s>>>(a, d);
  else
    nuts_chunk_kernel<T, NE, Dens, KIND == kWarmup>
        <<<grid, block, bytes, s>>>(a, d);
  return cudaGetLastError();
}

// f[8..15]: M, F, NNZ, bound on, decay on, alpha, alpha^2, full
// precision; f[16..21]: the plan's features staged, bytes, stacks in
// shared memory, path (1: streamed tiles), features a tile and a tile's
// bytes (0 and 0 on the other path)
template <typename T, int NE, int KIND, bool STREAM>
cudaError_t launch_poly(const Args<T>& a, const double* f, cudaStream_t s) {
  PolyGaussian<T, NE, STREAM> p = {};
  p.par = a.dpar;
  p.D = a.D;
  p.nrm = a.d0;
  p.gamma = a.d1;
  p.M = (int)f[8];
  p.F = (int)f[9];
  p.NNZ = (int)f[10];
  p.bound_on = f[11] != 0.0;
  p.decay_on = f[12] != 0.0;
  p.alpha = T(f[13]);
  p.alpha2 = T(f[14]);
  p.full = f[15] != 0.0;
  p.R = (int)f[16];
  if (p.M < 1 || p.F < 1 || p.R < 0 || p.R > p.F)
    return cudaErrorInvalidValue;
  p.RS = coef_stride<T>(p.R);
  p.TW = (int)f[20];
  p.NVT = p.TW / Vec16<T>::n;
  if (STREAM) {
    // whole 16-byte vectors of staged features; whole back-pass groups a
    // tile, in a power of two or a multiple of 8 vectors (`swl`)
    const bool swizzled = (p.NVT & (p.NVT - 1)) == 0 || p.NVT % 8 == 0;
    if (p.R >= p.F || p.R % Vec16<T>::n != 0 || p.TW < 8 || p.TW % 8 != 0 ||
        !swizzled || f[21] != (double)p.M * p.TW * sizeof(T))
      return cudaErrorInvalidValue;
    p.NT = (p.F - p.R + p.TW - 1) / p.TW;
  } else if (f[20] != 0.0 || f[21] != 0.0) {
    return cudaErrorInvalidValue;
  }
  p.locate();
  return launch_kernel<T, NE, KIND>(a, p, s, (long long)f[17], f[18] != 0.0);
}

template <typename T, int NE, int KIND>
cudaError_t launch_t(const Args<T>& a, int dens, const double* f,
                     cudaStream_t s) {
  if (dens == 0) {
    Banana<T, NE> b = {};
    b.A = a.dpar;
    b.D = a.D;
    b.Q = a.d0;
    b.cst = a.d1;
    return launch_kernel<T, NE, KIND>(a, b, s);
  }
  if (dens == 1) {
    Gaussian<T, NE> g = {};
    g.mean = a.dpar;
    g.var = a.dpar + a.D;
    g.D = a.D;
    return launch_kernel<T, NE, KIND>(a, g, s);
  }
  if (dens == 2)
    return f[19] != 0.0 ? launch_poly<T, NE, KIND, true>(a, f, s)
                        : launch_poly<T, NE, KIND, false>(a, f, s);
  if (dens == 3) {
    Funnel<T, NE> fn = {};
    fn.par = a.dpar;
    fn.D = a.D;
    fn.c0 = a.d0;
    fn.cst = a.d1;
    return launch_kernel<T, NE, KIND>(a, fn, s);
  }
  if (dens == 4) {
    Ring<T, NE> r = {};
    r.par = a.dpar;
    r.D = a.D;
    r.cst = a.d1;
    return launch_kernel<T, NE, KIND>(a, r, s);
  }
  if (dens == 5) {
    Cauchy<T, NE> c = {};
    c.par = a.dpar;
    c.D = a.D;
    c.c0 = a.d0;
    c.cst = a.d1;
    return launch_kernel<T, NE, KIND>(a, c, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int NE>
cudaError_t launch_ne(int kind, const Args<T>& a, int dens, const double* f,
                      cudaStream_t s) {
  if (kind == kBlock) return launch_t<T, NE, kBlock>(a, dens, f, s);
  if (kind == kWarmup) return launch_t<T, NE, kWarmup>(a, dens, f, s);
  return launch_t<T, NE, kFrozen>(a, dens, f, s);
}

template <typename T>
cudaError_t launch_dtype(int kind, int dens, int C, int D, int K,
                         int maxdepth, uint32_t seed, uint32_t i0,
                         uint32_t cs, int as, int am, const double* f,
                         void* const* p, cudaStream_t s) {
  const Args<T> a = make_args<T>(C, D, K, maxdepth, seed, i0, cs, as, am, f,
                                 p, kind == kWarmup);
  return D <= 32 ? launch_ne<T, 1>(kind, a, dens, f, s)
                 : launch_ne<T, 2>(kind, a, dens, f, s);
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

