// NUTS kernels for Hopper (sm_90a), one warp per chain: the densities
// compiled in, their dispatch and the C entry points.
//
// The kernels themselves (`transition`, `nuts_chunk_kernel`,
// `nuts_block_kernel`, `launch_kernel`), which replace the three Pallas TPU
// kernels of the NUTS transitions (bayesfast_tpu/samplers/nuts_pallas.py:431,
// :462, :746), and their design notes are in nuts_kernels.cuh; a density
// traced from a user's torch logp is a functor that ops/codegen.py writes
// into a translation unit of its own against the same header. Here: the
// compiled-in densities (Banana, Gaussian, Funnel, Ring, Cauchy,
// PolyGaussian) and `launch_t`, which picks one by its id
// (ops/densities.py::DENSITY_IDS).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC --fmad=false   (see ../_build.py)

#include "nuts_kernels.cuh"

namespace {

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
  const cudaError_t bad = check_launch(kind, C, D, K, maxdepth, n_ptrs);
  if (bad != cudaSuccess) return bad;
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
