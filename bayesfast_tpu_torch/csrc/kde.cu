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
// What bounds it on the card: instruction issue. There are D*M*N terms
// (2.5e9 at the SIT fit's shape: D = 32, M = 512, N = 153,600, float32),
// each a difference, a scale, the erf and a multiply-add, against
// sizeof(T) * (D*N + N + D*M) bytes of inputs read once (20 MB, 6 us at
// 3.35 TB/s). Each term's instructions go through the SM's issue slots one
// by one, so the time is the instructions per term over the issue rate.
//
// What the design does about it: it cuts the instructions per term. The
// wrapper passes c[d] = sqrt(1/2) / h[d] and hw[n] = w[n] / 2, so a term is
//   z = (x - data) * c,  t = hw * (1 + erf(z)),
// with no divide; each thread holds kQ = 4 queries in registers, so one
// broadcast read of a point and its weight from shared memory serves four
// terms; and the terms are summed in T in groups of kG = 16 consecutive
// points, in order, each group converted once and added into a float64 sum
// (one conversion and one float64 add per kG terms instead of two
// conversions, a multiply and an add per term). The float64 sum across
// groups keeps the digits of the cdf's upper tail, which the SIT fit's
// ndtri amplifies. The points are cut into S splits of P (the grid's z),
// which puts many blocks on 132 SMs; each block stages its split's points
// in shared memory, writes its float64 partial sums to scratch, and a
// second kernel adds the S partials in split order, so the result does not
// depend on scheduling. The plain torch version (ops/kde.py) computes every
// term with the same operations and takes every sum in the same grouping
// and order, so on the card the two agree bit for bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC --fmad=false   (see ../_build.py)

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kQ = 4;          // queries per thread
constexpr int kG = 16;         // terms summed in T before a float64 add
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

// one term: hw * (1 + erf((xq - dn) * c))
template <typename T, bool kExact>
__device__ __forceinline__ T term(T xq, T dn, T hwn, T c) {
  const T z = (xq - dn) * c;
  const T e = kExact ? m_erf(z) : erf_as(z);
  return hwn * (T(1) + e);
}

// grid (ceil(M / (kThreads * kQ)), D, S): block (mb, d, s) sums points
// [s * P, min(N, (s + 1) * P)) of column d for its kThreads * kQ queries;
// thread i holds queries mb * kThreads * kQ + i + q * kThreads, q < kQ.
// Dynamic shared memory: 2 * P values of T.
template <typename T, bool kExact>
__global__ void __launch_bounds__(kThreads)
kde_cdf_partial(const T* __restrict__ x, const T* __restrict__ data,
                const T* __restrict__ hw, const T* __restrict__ c,
                double* __restrict__ part, int M, int N, int P) {
  extern __shared__ __align__(16) unsigned char g_smem[];
  T* s_d = reinterpret_cast<T*>(g_smem);
  T* s_w = s_d + P;
  const int d = blockIdx.y;
  const int n0 = blockIdx.z * P;
  const int cnt = min(P, N - n0);
  const T* row = data + (size_t)d * N + n0;
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    s_d[i] = row[i];
    s_w[i] = hw[n0 + i];
  }
  const T cd = c[d];
  const int m0 = blockIdx.x * kThreads * kQ + threadIdx.x;
  T xq[kQ];
  double acc[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int m = m0 + q * kThreads;
    xq[q] = m < M ? x[(size_t)d * M + m] : T(0);
    acc[q] = 0.0;
  }
  __syncthreads();

  const int full = cnt / kG * kG;
  for (int n = 0; n < full; n += kG) {
    T g[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) g[q] = T(0);
#pragma unroll
    for (int k = 0; k < kG; ++k) {
      const T dn = s_d[n + k], hwn = s_w[n + k];
#pragma unroll
      for (int q = 0; q < kQ; ++q) g[q] += term<T, kExact>(xq[q], dn, hwn, cd);
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) acc[q] += (double)g[q];
  }
  if (full < cnt) {  // the split's last, short group
    T g[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) g[q] = T(0);
    for (int n = full; n < cnt; ++n) {
      const T dn = s_d[n], hwn = s_w[n];
#pragma unroll
      for (int q = 0; q < kQ; ++q) g[q] += term<T, kExact>(xq[q], dn, hwn, cd);
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) acc[q] += (double)g[q];
  }
  double* out = part + ((size_t)blockIdx.z * gridDim.y + d) * M;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int m = m0 + q * kThreads;
    if (m < M) out[m] = acc[q];
  }
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

template <typename T, bool kExact>
cudaError_t launch_partial(int D, int M, int N, int S, int P, const T* x,
                           const T* data, const T* hw, const T* c,
                           double* part, cudaStream_t stream) {
  const size_t bytes = 2 * (size_t)P * sizeof(T);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)kde_cdf_partial<T, kExact>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((M + kThreads * kQ - 1) / (kThreads * kQ), D, S);
  kde_cdf_partial<T, kExact><<<grid, kThreads, bytes, stream>>>(
      x, data, hw, c, part, M, N, P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int exact, int D, int M, int N, int S, int P,
                   const void* x, const void* data, const void* hw,
                   const void* c, void* part, void* out,
                   cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(data);
  const T* wt = static_cast<const T*>(hw);
  const T* ct = static_cast<const T*>(c);
  double* pt = static_cast<double*>(part);
  cudaError_t err =
      exact ? launch_partial<T, true>(D, M, N, S, P, xt, dt, wt, ct, pt,
                                      stream)
            : launch_partial<T, false>(D, M, N, S, P, xt, dt, wt, ct, pt,
                                       stream);
  if (err != cudaSuccess) return err;
  const int DM = D * M;
  kde_cdf_reduce<T><<<(DM + kReduceThreads - 1) / kReduceThreads,
                      kReduceThreads, 0, stream>>>(
      pt, static_cast<T*>(out), S, DM);
  return cudaGetLastError();
}

}  // namespace

// x (D, M), data (D, N), hw (N,) half-weights and c (D,) = sqrt(1/2) / h,
// all of one dtype (f64 ? double : float), contiguous; part is float64
// scratch of (S, D, M); out (D, M). The points go in S splits of P
// (S * P >= N > (S - 1) * P), summed in groups of kG. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int kde_cdf_launch(int f64, int exact, int D, int M, int N, int S,
                              int P, const void* x, const void* data,
                              const void* hw, const void* c, void* part,
                              void* out, void* stream) {
  if (D < 1 || D > 65535 || M < 1 || N < 1 || S < 1 || S > 65535 ||
      P < 1 || (long long)S * P < N || (long long)(S - 1) * P >= N ||
      2LL * P * (f64 ? 8 : 4) > 232448 || (long long)D * M > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    return (int)launch<double>(exact, D, M, N, S, P, x, data, hw, c,
                               part, out, s);
  return (int)launch<float>(exact, D, M, N, S, P, x, data, hw, c,
                            part, out, s);
}

extern "C" const char* kde_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
