// Device helpers of the CUDA NUTS kernels (sm_90a): the math overloads whose
// rounding the plain torch versions repeat, the JAX package's counter RNG
// (bayesfast_tpu/samplers/nuts_pallas.py:54-88, :418-428) bit for bit, the
// warp's xor-butterfly sums, lane fetches, 16-byte vectors, the block-wide
// steps of a density whose matrices stream through shared-memory tiles
// (PolyGaussian's features, a generated density's matrices) and the
// matrix-vector products of the generated densities (ops/codegen.py).
// Included by nuts_kernels.cuh.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "nuts_launch.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
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

// ---- block-wide steps of the streamed densities -------------------------
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

// ---- TMA bulk copies (sm_90): global -> shared, completing on an mbarrier
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// (one thread) an mbarrier of `count` arrivals, visible to the bulk copies
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile(
      "fence.mbarrier_init.release.cluster;\n"
      "fence.proxy.async.shared::cta;\n" ::
          : "memory");
}
// (the copying thread) its arrival at `bar`, which then waits for `bytes`
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// `bytes` (a multiple of 16, both ends 16-byte aligned) from device memory
// to shared memory, counted on `bar` when they land
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// this thread's stores to shared memory, ordered before the bulk copies
// that a barrier later lets overwrite them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// this thread's arrival at `bar`, then its wait until the phase it arrived
// in completes (every arrival made, every expected byte landed); a wait
// that does not end is a fault of the caller's schedule, which traps
// rather than hang the card
__device__ __forceinline__ void mbar_arrive_wait(uint64_t* bar) {
  const unsigned a = smem_addr(bar);
  uint64_t st;
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];\n"
               : "=l"(st)
               : "r"(a)
               : "memory");
  const long long t0 = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "l"(st)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

// The block's tile stream: a density whose matrix passes a block's shared
// memory (PolyGaussian's unstaged features, a generated density's streamed
// matrices) reads it through two shared-memory buffers that the block's
// eight chains (warps) share, tile t in buffer t & 1, each tile copied
// from L2 once per block. The density `Src` owns its tiles and their
// order:
//   load_tile(t)   tile t's copy, started (cp.async: every thread's part
//                  of it; a bulk copy: one thread's);
//   await_step(s)  this thread's wait for the tile that step s (0: the
//                  tick) reads to have landed (cp.async: for its own
//                  copies, which the barrier after it shows to the block);
//   n_steps()      the steps of an evaluation, numbered 1 .. n_steps();
//   step_tile(s)   the tile whose copy step s starts (< 0: none);
//   tick_tile()    the tile whose copy the tick starts (< 0: none).
// An evaluation is one tick of the block (`tile_tick(src, true)`), then
// its steps in order, each (`tile_step(src, s)`) before the tile it reads:
// the tile has landed, then the block's warps meet at a barrier (every
// warp is done with the buffer that the step's copy takes), and the copy
// starts. So every warp of the block takes the same barriers in the same
// order; a warp with no evaluation left runs idle ticks (`tile_drain`)
// until no warp of the block has one.
template <class Src>
__device__ __forceinline__ void tile_step(const Src& src, int s) {
  src.await_step(s);
  bar_sync<kBarTile>();
  const int t = src.step_tile(s);
  if (t >= 0) src.load_tile(t);
}
// the start of a tick; true while a warp of the block has work
template <class Src>
__device__ __forceinline__ bool tile_tick(const Src& src, bool work) {
  src.await_step(0);
  if (bar_count<kBarTick>(work) == 0) return false;
  const int t = src.tick_tile();
  if (t >= 0) src.load_tile(t);
  return true;
}
// idle ticks, until no warp of the block has work: every warp calls it
// once after its last evaluation
template <class Src>
__device__ void tile_drain(const Src& src) {
  while (tile_tick(src, false))
    for (int s = 1; s <= src.n_steps(); ++s) tile_step(src, s);
}

// The schedule of a density that reads each of its NT tiles once an
// evaluation, in order (a generated density, ops/codegen.py::_Layout):
// step s reads tile s and copies tile s + 1 into the buffer of tile s - 1,
// the last step copies the next evaluation's tile 0, and the tick its tile
// 1, once every warp is done with the last tile's buffer. An odd NT ends
// in a step that reads no tile (and so copies tile 0 into the buffer of
// tile NT - 1), so that tile t's buffer is t & 1 in every evaluation.
template <int NT>
struct TileRing {
  static constexpr int kSteps = NT - 1 + (NT & 1);
  __device__ static int n_steps() { return kSteps; }
  __device__ static int step_tile(int s) {
    return s + 1 < NT ? s + 1 : s == kSteps ? 0 : -1;
  }
  __device__ static int tick_tile() { return 1; }
};

// thread 0's copy of one tile, counted on `bar`: 32 rows of `vecs` 16-byte
// vectors from `src` (a row every `s` values, device memory) to `dst` (a
// row every `ts`, shared memory). Rows as long as their stride in both (a
// row group's whole rows, padding included) are one block, one bulk copy;
// else one a row (column tiles).
template <typename T>
__device__ __forceinline__ void bulk_tile(T* dst, int ts, const T* src,
                                          int s, int vecs, uint64_t* bar) {
  if (threadIdx.x != 0) return;
  if (ts == s) {
    const unsigned bytes = 32u * (unsigned)s * sizeof(T);
    mbar_expect(bar, bytes);
    bulk_copy(dst, src, bytes, bar);
    return;
  }
  mbar_expect(bar, 32u * 16u * (unsigned)vecs);
  for (int r = 0; r < 32; ++r)
    bulk_copy(dst + r * ts, src + (size_t)r * s, 16u * (unsigned)vecs, bar);
}

// Row stride of a staged P x P matrix: 16 bytes of padding put the rows
// that one 16-byte load phase reads (8 lanes) on distinct banks.
template <typename T, int NE>
__host__ __device__ constexpr int row_stride() {
  return 32 * NE + 16 / (int)sizeof(T);
}

// The products of slots e0 .. e0 + NE_ - 1 of x into this lane's partial
// sums s (k = l + 32 e: slot e's products added into s_l in turn, the
// first slot of all, e = 0, giving s its start), reading the lane's row
// `row` (its slot e0 at row[0]) and x (the warp's buffer) 16 bytes at a
// time; a padded product past N is the constant +0, with no load.
template <typename T, int E0, int NE_, int N>
__device__ __forceinline__ void row_products(const T* row, const T* xbuf,
                                             T (&s)[32]) {
  using V = Vec16<T>;
#pragma unroll
  for (int ee = 0; ee < NE_; ++ee) {
    const int e = E0 + ee;
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
          *reinterpret_cast<const typename V::type*>(row + 32 * ee + k0);
#pragma unroll
      for (int i = 0; i < V::n; ++i) {
        const T p = V::at(mv, i) * V::at(xv, i);
        s[k0 + i] = e == 0 ? p : s[k0 + i] + p;
      }
    }
  }
}

// the halving levels of warp_sum over the 32 partial sums, spelled out:
// every index a constant, so s stays in registers (a loop over the level
// leaves the array in local memory)
template <typename T>
__device__ __forceinline__ T halve32(T (&s)[32]) {
#pragma unroll
  for (int l = 0; l < 16; ++l) s[l] = s[l] + s[l + 16];
#pragma unroll
  for (int l = 0; l < 8; ++l) s[l] = s[l] + s[l + 8];
#pragma unroll
  for (int l = 0; l < 4; ++l) s[l] = s[l] + s[l + 4];
  s[0] = s[0] + s[2];
  s[1] = s[1] + s[3];
  return s[0] + s[1];
}

// x (NI slots, valid below n) into the warp's buffer, zero past n
template <typename T, int NI>
__device__ __forceinline__ void fill_xbuf(T* __restrict__ xbuf,
                                          const T (&x)[NI], int n) {
  const int lane = threadIdx.x & 31;
  __syncwarp();  // every lane is done reading the buffer's last vector
#pragma unroll
  for (int e = 0; e < NI; ++e)
    xbuf[lane + 32 * e] = lane + 32 * e < n ? x[e] : T(0);
  __syncwarp();
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
// 0 is not s when s is -0). A matrix past a block's shared memory takes
// `tiled_matvec`, in the same order of products and sums.
template <typename T, int NI, int NO, int S, int N = 32 * NI>
__device__ __forceinline__ void tree_matvec(const T* __restrict__ M,
                                            T* __restrict__ xbuf,
                                            const T (&x)[NI], int n,
                                            T (&y)[NO]) {
  const int lane = threadIdx.x & 31;
  fill_xbuf(xbuf, x, n);
#pragma unroll
  for (int o = 0; o < NO; ++o) {
    T s[32];
    row_products<T, 0, NI, N>(M + (lane + 32 * o) * S, xbuf, s);
    y[o] = halve32(s);
  }
}

// this lane's value of output slot o (o < NO, a loop variable): a select
// over the slots, so that y stays in registers
template <typename T, int NO>
__device__ __forceinline__ void put_slot(T (&y)[NO], int o, T v) {
#pragma unroll
  for (int q = 0; q < NO; ++q)
    if (q == o) y[q] = v;
}

// the column tiles C .. NC - 1 of one row group of `tiled_matvec`, tile k
// of the schedule first: slots C TE .. of M into the partial sums s
template <typename T, int NI, int N, int TE, int TS, int C, int NC,
          class Src>
__device__ __forceinline__ void col_tiles(const Src& src, int k,
                                          const T* xbuf, T (&s)[32]) {
  if constexpr (C < NC) {
    if (k > 0) tile_step(src, k);
    constexpr int E0 = C * TE, W = NI - E0 < TE ? NI - E0 : TE;
    row_products<T, E0, W, N>(src.tile(k) + (threadIdx.x & 31) * TS, xbuf,
                              s);
    col_tiles<T, NI, N, TE, TS, C + 1, NC>(src, k + 1, xbuf, s);
  }
}

// tree_matvec with M past a block's shared memory: streamed, in the same
// padded layout, from device memory through the block's two shared-memory
// tile buffers, which the block's eight chains (warps) share. Tile k = K0 +
// o NC + c of the evaluation's schedule (ops/codegen.py::_Layout) holds
// rows 32 o .. 32 o + 31 (every lane's row of output slot o) and slots c
// TE .. c TE + TE - 1 of M (NC = ceil(NI / TE) tiles a row group; TE = NI
// when a row group fits a buffer, column tiles else), a row every TS
// values; `src` is the generated functor, whose schedule is a `TileRing`
// and whose `tile(k)` is tile k's buffer. Before each tile but the
// evaluation's first, `tile_step(src, k)` meets the block's warps at a
// barrier. The partial sums s of a row group stay in registers across its
// column tiles, so each output's sum takes tree_matvec's order, bit for
// bit. The loop over row groups is not unrolled: unrolled, each of the
// 250-d MVN's two products is thousands of instructions, inlined into the
// transition beside its state, ptxas spills 4.1-4.6 KB of stores a thread
// in f32 (14.8-15.3 KB in f64, against 0.7-1.1 and 3.7-4.4 looped), and a
// leapfrog takes twice as long (PERF.md).
template <typename T, int NI, int NO, int N, int TE, int TS, int K0,
          class Src>
__device__ __forceinline__ void tiled_matvec(const Src& src,
                                             T* __restrict__ xbuf,
                                             const T (&x)[NI], int n,
                                             T (&y)[NO]) {
  constexpr int NC = (NI + TE - 1) / TE;
  fill_xbuf(xbuf, x, n);
#pragma unroll 1
  for (int o = 0; o < NO; ++o) {
    T s[32];
    col_tiles<T, NI, N, TE, TS, 0, NC>(src, K0 + o * NC, xbuf, s);
    put_slot(y, o, halve32(s));
  }
}

}  // namespace
