// The compiled-in densities of the CUDA NUTS kernels that take any D up to
// the kernels' 256 (Banana, Gaussian, Funnel, Ring, Cauchy;
// ops/densities.py) and their launch by density id (`launch_density`).
// csrc/nuts.cu instantiates them at NE = 1 and 2 (D <= 64) beside the
// PolyGaussian surrogate; a launch at NE = 3..8 (D 65..256) goes to a
// translation unit of one density, NE and dtype (`launch_unit`), which
// samplers/nuts_cuda.py::wide_unit_source writes in a few lines and
// _build.py builds at first use, so that nuts.cu's own build does not
// carry six more lane widths of every density.
//
// At NE > 2 a lane's transition state (three `State`s of 5 NE values,
// the frames, the merge temporaries; csrc/nuts_kernels.cuh) is past the
// 255 registers a thread may have: ptxas keeps what does not fit in
// local memory (the L1 cache, then L2), and the arithmetic, the order of
// every sum and so the bits stay those of the plain versions.

#pragma once

#include "nuts_kernels.cuh"

namespace {

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

// The functor of compiled-in density `DENS` (ops/densities.py::DENSITY_IDS:
// 0 banana, 1 gaussian, 3 funnel, 4 ring, 5 cauchy) over the launch's
// parameters, launched as kernel KIND.
template <typename T, int NE, int KIND, int DENS>
cudaError_t launch_density(const Args<T>& a, cudaStream_t s) {
  if constexpr (DENS == 0) {
    Banana<T, NE> b = {};
    b.A = a.dpar;
    b.D = a.D;
    b.Q = a.d0;
    b.cst = a.d1;
    return launch_kernel<T, NE, KIND>(a, b, s);
  } else if constexpr (DENS == 1) {
    Gaussian<T, NE> g = {};
    g.mean = a.dpar;
    g.var = a.dpar + a.D;
    g.D = a.D;
    return launch_kernel<T, NE, KIND>(a, g, s);
  } else if constexpr (DENS == 3) {
    Funnel<T, NE> fn = {};
    fn.par = a.dpar;
    fn.D = a.D;
    fn.c0 = a.d0;
    fn.cst = a.d1;
    return launch_kernel<T, NE, KIND>(a, fn, s);
  } else if constexpr (DENS == 4) {
    Ring<T, NE> r = {};
    r.par = a.dpar;
    r.D = a.D;
    r.cst = a.d1;
    return launch_kernel<T, NE, KIND>(a, r, s);
  } else {
    static_assert(DENS == 5, "no compiled-in density of that id here");
    Cauchy<T, NE> c = {};
    c.par = a.dpar;
    c.D = a.D;
    c.c0 = a.d0;
    c.cst = a.d1;
    return launch_kernel<T, NE, KIND>(a, c, s);
  }
}

// The entry point of a unit of one compiled-in density DENS at one lane
// width NE and dtype T: the arguments of nuts_traced_launch (ops/
// codegen.py; kind 0 frozen, 1 warmup, 2 block). cudaErrorInvalidValue
// for another dtype, a D whose lane width is not NE, or arguments the
// kernels do not take.
template <typename T, int NE, int DENS>
cudaError_t launch_unit(int kind, int f64, int C, int D, int K,
                        int maxdepth, uint32_t seed, uint32_t i0,
                        uint32_t cs, int as, int am, const double* f,
                        void* const* p, int n_ptrs, void* stream) {
  if (f64 != (sizeof(T) == 8 ? 1 : 0) || (D + 31) / 32 != NE ||
      kind < kFrozen || kind > kBlock)
    return cudaErrorInvalidValue;
  const cudaError_t bad = check_launch(kind, C, D, K, maxdepth, n_ptrs);
  if (bad != cudaSuccess) return bad;
  const Args<T> a = make_args<T>(C, D, K, maxdepth, seed, i0, cs, as, am, f,
                                 p, kind == kWarmup);
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == kBlock) return launch_density<T, NE, kBlock, DENS>(a, s);
  if (kind == kWarmup) return launch_density<T, NE, kWarmup, DENS>(a, s);
  return launch_density<T, NE, kFrozen, DENS>(a, s);
}

}  // namespace
