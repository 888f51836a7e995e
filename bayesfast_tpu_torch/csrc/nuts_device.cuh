// Device helpers of the CUDA NUTS kernels (sm_90a): the math overloads whose
// rounding the plain torch versions repeat, the JAX package's counter RNG
// (bayesfast_tpu/samplers/nuts_pallas.py:54-88, :418-428) bit for bit, the
// warp's xor-butterfly sums, lane fetches, 16-byte vectors and the matrix-
// vector product of the generated densities (ops/codegen.py). Included by
// nuts_kernels.cuh.

#pragma once

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

// Row stride of a staged P x P matrix: 16 bytes of padding put the rows
// that one 16-byte load phase reads (8 lanes) on distinct banks.
template <typename T, int NE>
__host__ __device__ constexpr int row_stride() {
  return 32 * NE + 16 / (int)sizeof(T);
}

// y_j = sum_k M[j * S + k] x_k for this lane's rows j = lane + 32 o (o <
// NO), x valid below n: the densities that ops/codegen.py generates. x goes
// through the warp's buffer `xbuf`, zero past n; M is staged in shared
// memory with zeros past its rows and columns, so each lane reads its row
// and x 16 bytes at a time, every load and product independent. The sum
// over k is warp_sum's order (ops/densities.py::warp_sum over the k axis,
// which ops/trace.py's interpreter takes): the products of slot e of k (k
// = l + 32 e) added into s_l in turn, then s_l + s_{l + h} for h = 16, 8,
// 4, 2, 1. That is five dependent adds after the slots, where a sum in
// order over k is 32 NI, and the plain version is one product and a
// butterfly over a (C, m, n) tensor, where one in order is 2 n launches.
// Padded products are 0 * 0 = +0, as warp_sum pads with +0. N, the length
// of x known when the functor is generated, lets the padded products past
// it be that constant +0 without a load: a matrix 2 or 3 wide then keeps
// a few partial sums live, not 32 (the adds of the levels stay, since s +
// 0 is not s when s is -0).
template <typename T, int NI, int NO, int S, int N = 32 * NI>
__device__ __forceinline__ void tree_matvec(const T* __restrict__ M,
                                            T* __restrict__ xbuf,
                                            const T (&x)[NI], int n,
                                            T (&y)[NO]) {
  using V = Vec16<T>;
  const int lane = threadIdx.x & 31;
  __syncwarp();  // every lane is done reading the buffer's last vector
#pragma unroll
  for (int e = 0; e < NI; ++e)
    xbuf[lane + 32 * e] = lane + 32 * e < n ? x[e] : T(0);
  __syncwarp();
#pragma unroll
  for (int o = 0; o < NO; ++o) {
    const T* row = M + (lane + 32 * o) * S;
    T s[32];
#pragma unroll
    for (int e = 0; e < NI; ++e) {
#pragma unroll
      for (int k0 = 0; k0 < 32; k0 += V::n) {
        if (32 * e + k0 >= N) {
#pragma unroll
          for (int i = 0; i < V::n; ++i)
            s[k0 + i] = e == 0 ? T(0) : s[k0 + i] + T(0);
          continue;
        }
        const typename V::type xv =
            *reinterpret_cast<const typename V::type*>(xbuf + 32 * e + k0);
        const typename V::type mv =
            *reinterpret_cast<const typename V::type*>(row + 32 * e + k0);
#pragma unroll
        for (int i = 0; i < V::n; ++i) {
          const T p = V::at(mv, i) * V::at(xv, i);
          s[k0 + i] = e == 0 ? p : s[k0 + i] + p;
        }
      }
    }
    // the halving levels spelled out: every index a constant, so s stays
    // in registers (a loop over the level leaves the array in local memory)
#pragma unroll
    for (int l = 0; l < 16; ++l) s[l] = s[l] + s[l + 16];
#pragma unroll
    for (int l = 0; l < 8; ++l) s[l] = s[l] + s[l + 8];
#pragma unroll
    for (int l = 0; l < 4; ++l) s[l] = s[l] + s[l + 4];
    s[0] = s[0] + s[2];
    s[1] = s[1] + s[3];
    y[o] = s[0] + s[1];
  }
}

}  // namespace
