// Weighted Gaussian-KDE cdf for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the SIT flow fit's inner loop:
//   kde_cdf  <- bayesfast_tpu/ops/kde_pallas.py:50 (_pallas_kernel, launched
//               at :97), and the blocked jnp sum beside it
//               (_cdf_batch_impl, kde_pallas.py:126-142).
// Both are special cases of
//   out[d, m] = sum_n w[n] * Phi((x[d, m] - data[d, n]) / h[d])
// for D columns of M queries, each column with its own N points and
// bandwidth, the weights shared. Phi(z) = 0.5 * (1 + erf(z / sqrt 2)), with
// the exact erf (the SIT fit's form) or the Abramowitz & Stegun 7.1.26
// rational erf written as kde_pallas.py:27-39 writes it (the Pallas
// kernel's form).
//
// What bounds it on the card: D*M*N evaluations of Phi, about 25
// floating-point operations each (difference, divide, scale, some 20 for
// the erf, the float64 multiply-add of the sum), against
// sizeof(T) * (D*N + N + D*M) bytes of inputs read once and D*M outputs
// written once. At the SIT fit's shape (D = 32, M = 512, N = 153,600,
// float32) that is 2.5e9 evaluations, 6.3e10 operations (0.94 ms at
// 67 TFLOP/s) against 20 MB (6 us at 3.35 TB/s): it is compute-bound.
//
// Design, simple first (no wgmma, no TMA): one thread per query, held in a
// register; the block's 128 queries share one column, and the column's
// points and the weights stream through shared memory in tiles of 128,
// read by every thread at the same address (a broadcast). The sum runs in
// float64 whatever T is: a float32 running sum over 153,600 terms would
// lose digits in the cdf's upper tail, which the SIT fit's ndtri
// amplifies. At the SIT shape a column has only 4 blocks of queries, so
// the points are cut into S splits (grid z) to put enough blocks on 132
// SMs; each split writes its float64 partial sums to scratch, and a second
// kernel adds the S partials in split order, so the result does not
// depend on scheduling. The plain torch version (ops/kde.py) computes each
// Phi with the same operations in the same order and also sums in float64,
// so the two differ only by the order of the float64 sum.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC --fmad=false   (see ../_build.py)

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // queries per block, and points per tile
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float m_erf(float x) { return erff(x); }
__device__ __forceinline__ double m_erf(double x) { return erf(x); }
__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }

// Abramowitz & Stegun 7.1.26 (|err| < 1.5e-7), operation for operation as
// kde_pallas.py::_erf_approx
template <typename T>
__device__ __forceinline__ T erf_as(T x) {
  const T a1 = T(0.254829592), a2 = T(-0.284496736), a3 = T(1.421413741);
  const T a4 = T(-1.453152027), a5 = T(1.061405429), p = T(0.3275911);
  const T sign = x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
  const T ax = m_abs(x);
  const T t = T(1) / (T(1) + p * ax);
  const T poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t;
  return sign * (T(1) - poly * m_exp(-ax * ax));
}

// grid (ceil(M / kThreads), D, S): block (mb, d, s) sums points
// [s * per_split, (s + 1) * per_split) of column d for its 128 queries
template <typename T, bool kExact>
__global__ void __launch_bounds__(kThreads)
kde_cdf_partial(const T* __restrict__ x, const T* __restrict__ data,
                const T* __restrict__ w, const T* __restrict__ h,
                double* __restrict__ part, int M, int N, int per_split) {
  __shared__ T s_d[kThreads];
  __shared__ T s_w[kThreads];
  const int d = blockIdx.y;
  const int m = blockIdx.x * kThreads + threadIdx.x;
  const T hd = h[d];
  const T xq = m < M ? x[(size_t)d * M + m] : T(0);
  const T* row = data + (size_t)d * N;
  const int n0 = blockIdx.z * per_split;
  const int n1 = min(N, n0 + per_split);
  const T sqrt1_2 = T(0.7071067811865476);
  double acc = 0.0;
  for (int base = n0; base < n1; base += kThreads) {
    const int n = base + threadIdx.x;
    __syncthreads();  // every thread is done with the previous tile
    if (n < n1) {
      s_d[threadIdx.x] = row[n];
      s_w[threadIdx.x] = w[n];
    }
    __syncthreads();
    const int cnt = min(kThreads, n1 - base);
    for (int k = 0; k < cnt; ++k) {
      const T z = (xq - s_d[k]) / hd;
      const T e = kExact ? m_erf(z * sqrt1_2) : erf_as(z * sqrt1_2);
      const T phi = T(0.5) * (T(1) + e);
      acc += (double)s_w[k] * (double)phi;
    }
  }
  if (m < M) part[((size_t)blockIdx.z * gridDim.y + d) * M + m] = acc;
}

// out[i] = sum over splits s, in order, of part[s, i]
template <typename T>
__global__ void kde_cdf_reduce(const double* __restrict__ part,
                               T* __restrict__ out, int S, int DM) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= DM) return;
  double s = 0.0;
  for (int k = 0; k < S; ++k) s += part[(size_t)k * DM + i];
  out[i] = (T)s;
}

template <typename T>
cudaError_t launch(int exact, int D, int M, int N, int S, const void* x,
                   const void* data, const void* w, const void* h,
                   void* part, void* out, cudaStream_t stream) {
  const int per_split = (N + S - 1) / S;
  const dim3 grid((M + kThreads - 1) / kThreads, D, S);
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(data);
  const T* wt = static_cast<const T*>(w);
  const T* ht = static_cast<const T*>(h);
  double* pt = static_cast<double*>(part);
  if (exact)
    kde_cdf_partial<T, true><<<grid, kThreads, 0, stream>>>(
        xt, dt, wt, ht, pt, M, N, per_split);
  else
    kde_cdf_partial<T, false><<<grid, kThreads, 0, stream>>>(
        xt, dt, wt, ht, pt, M, N, per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int DM = D * M;
  kde_cdf_reduce<T><<<(DM + kReduceThreads - 1) / kReduceThreads,
                      kReduceThreads, 0, stream>>>(
      pt, static_cast<T*>(out), S, DM);
  return cudaGetLastError();
}

}  // namespace

// x (D, M), data (D, N), w (N,), h (D,) of one dtype (f64 ? double :
// float), contiguous; part is float64 scratch of (S, D, M); out (D, M).
// Returns the cudaError_t of the launches (0 on success).
extern "C" int kde_cdf_launch(int f64, int exact, int D, int M, int N, int S,
                              const void* x, const void* data, const void* w,
                              const void* h, void* part, void* out,
                              void* stream) {
  if (D < 1 || D > 65535 || M < 1 || N < 1 || S < 1 || S > 65535 ||
      (long long)D * M > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    return (int)launch<double>(exact, D, M, N, S, x, data, w, h, part, out,
                               s);
  return (int)launch<float>(exact, D, M, N, S, x, data, w, h, part, out, s);
}

extern "C" const char* kde_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
