// The surrogate density of a Recipe, PolyGaussian (a PolyModel then a
// Gaussian likelihood, with the bound and the decay), as a density functor
// of the CUDA NUTS kernels, and its launch (`launch_poly`). csrc/nuts.cu
// instantiates it at NE = 1 and 2 (D <= 64) beside the other compiled-in
// densities; a launch at NE = 3..8 (D 65..256) goes to a translation unit of
// one lane width, dtype and path (`launch_poly_unit`), which
// samplers/nuts_cuda.py::poly_unit_source writes and _build.py builds at
// first use.

#pragma once

#include <type_traits>

#include "nuts_densities.cuh"

namespace {

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

// ---- what both functors share (PolyGaussian at NE <= 2, PolyBlock past) --
// the integer tables' length: three indices a feature, the sparse rows'
// pointers, three a sparse-row entry
template <class Poly>
__host__ __device__ int poly_n_ints(const Poly& p) {
  return 3 * p.F + p.D + 1 + 3 * p.NNZ;
}

// offsets of the packed vector: WT, dat, vinv, fmu, mup, Hp, mud, Hd, lo,
// diff, P (full precision only), then the integer tables i1, i2, i3,
// rowptr, cf, c1, c2 (as T values); the tiles
// (samplers/nuts_cuda.py::_stream_tiles) at the next multiple of 32
// elements after them
template <class Poly>
__host__ void poly_locate(Poly& p) {
  p.WT = p.par;
  p.dat = p.WT + (size_t)p.F * p.M;
  p.vinv = p.dat + p.M;
  p.fmu = p.vinv + p.M;
  p.mup = p.fmu + p.M;
  p.Hp = p.mup + p.D;
  p.mud = p.Hp + p.D * p.D;
  p.Hd = p.mud + p.D;
  p.slo = p.Hd + p.D * p.D;
  p.sdf = p.slo + p.D;
  p.Pm = p.sdf + p.D;
  p.ints = p.Pm + (p.full ? (size_t)p.M * p.M : 0);
  p.tiles = p.par + (((size_t)(p.ints - p.par) + poly_n_ints(p) + 31) / 32 *
                     32);
}

// every thread's part of staging the input scales (lo, then diff; 0 and 1
// past D) at `sc`, the integer tables at `ip`, WT's first R features at
// `sw` (transposed, zero-padded to whole vectors), and on the streamed path
// tiles 0 and 1 in buffers 0 and 1 after them, where every evaluation finds
// them
template <typename T, class Poly>
__device__ void poly_stage(const Poly& p, T* sc, T* ip_, T* sw) {
  constexpr int P = Poly::P;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    sc[i] = i < p.D ? p.slo[i] : T(0);
    sc[P + i] = i < p.D ? p.sdf[i] : T(1);
  }
  int* const ip = reinterpret_cast<int*>(ip_);
  for (int i = threadIdx.x; i < poly_n_ints(p); i += blockDim.x)
    ip[i] = (int)p.ints[i];
  const int Rp = (p.R + Vec16<T>::n - 1) / Vec16<T>::n * Vec16<T>::n;
  for (int i = threadIdx.x; i < Rp * p.M; i += blockDim.x) {
    const int f = i / p.M, j = i - f * p.M;
    sw[j * p.RS + f] = f < p.R ? p.WT[(size_t)f * p.M + j] : T(0);
  }
  if (p.tile_elems() > 0) {
    T* tb = sw + (size_t)p.M * p.RS;
    const int n = (p.NT > 1 ? 2 : 1) * p.tile_elems();
    for (int i = threadIdx.x; i < n; i += blockDim.x) tb[i] = p.tiles[i];
  }
}

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
// Beside WT: the two D x D Hessians, staged for
// `matvec`, the input scales, each warp's exchange buffers (x, xa, phi
// with zeros to whole vectors, its gradient, the outputs' gradients; with
// a full precision also r and m0 - f_mu) and the integer tables. P (M x M,
// 835 KB in f32 at M = 457) is read from device memory, one row of it for
// each k, as each lane's outputs sum over k in order.
// This functor is csrc/nuts.cu's, at NE = 1 and 2 (D <= 64); past that the
// block evaluates its chains together (`PolyBlock`, below).
template <typename T, int NE, bool STREAM>
struct PolyGaussian {
  static_assert(NE <= 2, "PolyBlock evaluates the density past D = 64");
  static constexpr int P = 32 * NE, S = row_stride<T, NE>();
  static constexpr int kHess = 2 * P * S;  // the Hessians, staged
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
  __host__ __device__ int n_ints() const { return poly_n_ints(*this); }
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
  // layout: Hp and Hd, the scales (lo, then diff; 0 and 1
  // past D), the warps' buffers, the integer tables, staged WT, and when
  // STREAM the two tile buffers (M rows of TW each)
  __host__ __device__ int coef_offset() const {
    return kHess + 2 * P + kWarps * warp_elems() + int_elems();
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
    b.lo = sm + kHess;
    b.dv = b.lo + P;
    b.x = sm + kHess + 2 * P + (threadIdx.x >> 5) * warp_elems();
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

  __host__ void locate() { poly_locate(*this); }

  __device__ void stage(T* smem) const {
    for (int i = threadIdx.x; i < P * P; i += blockDim.x) {
      const int r = i / P, c = i % P;
      const bool in = r < D && c < D;
      smem[r * S + c] = in ? Hp[r * D + c] : T(0);
      smem[P * S + r * S + c] = in ? Hd[r * D + c] : T(0);
    }
    poly_stage(*this, smem + kHess, smem + kHess + 2 * P +
                                        kWarps * warp_elems(),
               smem + coef_offset());
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
  // t & 1; the block streams them as nuts_device.cuh's tile stream sets
  // out. An evaluation is one tick of the block (which copies nothing): a
  // forward pass over the tiles up (0 .. NT - 1, steps 1 .. NT - 1), then
  // a back pass down (NT - 1 .. 0, steps NT .. 2 NT - 2), so that a pass
  // starts on the two tiles that the last one ended on; each step copies
  // the next tile of its pass into the buffer that the step before read.

  // every thread's part of tile t's copy into buffer t & 1
  __device__ __forceinline__ void load_tile(int t) const {
    T* const dst = bufs().tb + (t & 1) * tile_elems();
    const T* const src = tiles + (size_t)t * tile_elems();
    for (int i = threadIdx.x * kVec; i < tile_elems(); i += kWarps * 32 * kVec)
      cp_async16(dst + i, src + i);
    cp_async_commit();
  }
  // this thread's copies landed (the step's barrier then shows them to all)
  __device__ __forceinline__ void await_step(int) const {
    cp_async_wait_all();
  }
  __device__ __forceinline__ int n_steps() const { return 2 * NT - 2; }
  __device__ __forceinline__ int step_tile(int s) const {
    return s < NT ? (s + 1 < NT ? s + 1 : -1) : 2 * NT - 3 - s;
  }
  __device__ __forceinline__ int tick_tile() const { return -1; }
  // idle ticks, until no warp of the block has work (nuts_kernels.cuh)
  __device__ void drain() const {
    if constexpr (STREAM) tile_drain(*this);
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
      tile_tick(*this, true);
      for (int k = 0; k < NT; ++k) {
        if (k) tile_step(*this, k);
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
        if (k) tile_step(*this, NT - 1 + k);
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

// ---- past D = 64: the block evaluates its eight chains together ----------
// The sums over a warp's 32 lanes of the NV values a lane holds (NV a power
// of two, <= 32), each in warp_sum's halving tree (x_l + x_{l+16}, then
// + 8, + 4, + 2, + 1: every node adds the butterfly's two operands, and a
// sum of two floats does not depend on their order), scattered over the
// lanes: while a lane holds more than one value, the level of offset O
// keeps half of them (the upper half where lane bit O is set) and adds the
// partner's copy of that half; then it adds the partner's one value. Lane
// l ends with the sum of value l / (32 / NV): 31 shuffles for 32 values,
// where PolyGaussian's tree through shared memory (`reduce8`) takes two
// barriers of the warp and 16 shared-memory accesses for 8.
template <typename T, int O, int NV, int M = NV>
__device__ __forceinline__ T reduce_scatter(T (&x)[NV]) {
  if constexpr (M > 1) {
    constexpr int H = M / 2;
    const bool up = (threadIdx.x & O) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const T send = up ? x[i] : x[i + H];
      const T keep = up ? x[i + H] : x[i];
      x[i] = keep + __shfl_xor_sync(kFull, send, O);
    }
  } else {
    x[0] += __shfl_xor_sync(kFull, x[0], O);
  }
  if constexpr (O > 1)
    return reduce_scatter<T, O / 2, NV, (M > 1 ? M / 2 : 1)>(x);
  else
    return x[0];
}

// PolyGaussian at NE = 3..8 (D 65..256; a unit a NE, dtype and path,
// `launch_poly_unit`). The arithmetic is PolyGaussian's and the plain
// version's, operation for operation; what changes is who does it. Per
// chain, an evaluation reads both Hessians (2 D^2 values, 80 KB in f32 at D
// = 100) and WT twice (2 F M: 534 KB at F = 146, M = 457), and does a few
// thousand other operations. PolyGaussian gives each chain's warp all of
// it: eight warps of a block read each Hessian row from L2 eight times and
// each WT vector from shared memory sixteen times, and the slowest chain's
// warp waits on every one of its loads and sums (82-86 us a leapfrog in f32
// at D = 100, PERF.md). Here every evaluation is one tick of the block, and
// every product over the Hessians and WT is split over the block's 256
// threads for all the chains that have work in that tick:
// - the Hessians (`hess`): thread j, output j of the tick's chains (of
//   half of them at NE <= 4, where two threads a j fit the block): each
//   Hessian value read from L2 once a block and evaluation (twice at NE <=
//   4), each (chain, j) sum over k in order, as `matvec` sums (bitwise: a
//   padded product is +-0, which changes no bit of a sum that started at
//   +0);
// - WT forward (`fwd`): thread t, outputs t + 256 o of every chain: one
//   16-byte vector of a WT row feeds kVec features of every chain, each
//   (chain, j) sum over the features in order (the staged ones, then the
//   tiles or device memory), kept in the chain's g buffer between tiles;
// - WT back (`back`): items of 8 features x kCB chains, round robin over
//   the warps: lane l sums its outputs l + 32 t in order for each, then
//   warp_sum's tree across lanes for all 8 kCB sums at once, scattered
//   over the lanes by shuffles (`reduce_scatter`: PolyGaussian's
//   `reduce8` takes each group of 8 through shared memory);
// and a tick with fewer chains runs an instantiation for fewer (1, 2, 4 or
// 8, the same in every thread: `group`), so that a chain left alone in a
// launch's tail has the whole block. Each chain's own sums stay with its
// own warp, its lanes over the same j and d in the same order as before
// (the bound's and decay's quadratic forms, the likelihood's part and the
// bound's sb over the outputs, the sparse-row gradient), so the bits are
// PolyGaussian's and the plain version's. An evaluation meets the block's
// warps at six barriers (A..F below) and the tiles' steps; a warp whose
// chain is done, or that has none, runs idle evaluations (`drain`) that do
// their share of the work until no warp of the block has any. The streamed
// tiles are one TMA bulk copy of thread 0 each, on its buffer's mbarrier,
// where PolyGaussian's go by every thread's cp.async.
// Shared memory: the scales (2 P), the control words (`kCtl`: the chains'
// work flags, the tile buffers' mbarriers), each chain's buffers (its
// warp's: x, xa, phi, gphi, red (the Hessians' products), g; r and m with
// a full precision), the integer tables, staged WT and the two tile
// buffers (samplers/nuts_cuda.py::_poly_layout, which the launch checks).
template <typename T, int NE, bool STREAM>
struct PolyBlock {
  static_assert(NE > 2, "PolyGaussian evaluates the density at D <= 64");
  static constexpr int P = 32 * NE;
  static constexpr int kVec = Vec16<T>::n;
  static constexpr int kBack = 8;  // features a back-pass group
  static constexpr int kJo = 2;    // outputs of a thread a forward pass
  // chains of a back-pass item: 8 x kCB partial sums a lane
  static constexpr int kCB = sizeof(T) == 4 ? 4 : 2;
  static constexpr int kBackUnroll = sizeof(T) == 4 ? 4 : 1;
  static constexpr int kCtl = 64 / (int)sizeof(T);
  // a chain's red buffer: the Hessians' products (2 P) from the block
  static constexpr int kRed = 2 * P;
  const T* par;  // packed parameters, device memory (`poly_locate`)
  int D, M, F, NNZ;
  int R, RS;  // features staged in shared memory, their row stride
  // STREAM: features a tile, tiles of the features R.., 16-byte vectors a
  // tile row, and the lane's swizzle of its rows (PolyGaussian's)
  int TW, NT, NVT, swl;
  bool bound_on, decay_on, full;
  T nrm, gamma, alpha, alpha2;
  const T *WT, *dat, *vinv, *fmu, *mup, *Hp, *mud, *Hd, *slo, *sdf, *Pm,
      *ints, *tiles;
  T mp[NE], md[NE];  // this lane's bound and decay centres
  mutable T dec;     // the decay penalty of the last evaluation

  __host__ __device__ static int up4(int n) { return (n + 3) & ~3; }
  __host__ __device__ int n_phi() const {
    return up4(STREAM ? R + NT * TW : F);
  }
  // a chain's buffers, from its start: x (the bound's delta), xa (the
  // decay's delta until the bound is done, then [x0, 1]), phi, gphi, red
  // (hdel, hdd), g (m0 from the block, then d logp / d m0), and r, m
  __host__ __device__ int o_phi() const { return P + up4(P + 1); }
  __host__ __device__ int o_gphi() const { return o_phi() + n_phi(); }
  __host__ __device__ int o_red() const { return o_gphi() + up4(F); }
  __host__ __device__ int o_g() const { return o_red() + kRed; }
  __host__ __device__ int warp_elems() const {
    return o_g() + (full ? 3 : 1) * up4(M);
  }
  __host__ __device__ int chain_base(int c) const {
    return 2 * P + kCtl + c * warp_elems();
  }
  __host__ __device__ int int_elems() const {
    return up4((poly_n_ints(*this) * 4 + (int)sizeof(T) - 1) /
               (int)sizeof(T));
  }
  __host__ __device__ int coef_offset() const {
    return chain_base(kWarps) + int_elems();
  }
  __host__ __device__ int tile_elems() const { return STREAM ? M * TW : 0; }
  __host__ __device__ size_t smem_elems() const {
    return coef_offset() + (size_t)M * RS + 2 * (size_t)tile_elems();
  }
  __host__ void locate() { poly_locate(*this); }

  // the block's shared memory, addressed from its symbol where it is used
  __device__ __forceinline__ static T* sm() {
    extern __shared__ __align__(16) unsigned char g_smem[];
    return reinterpret_cast<T*>(g_smem);
  }
  __device__ __forceinline__ static int* flags() {
    return reinterpret_cast<int*>(sm() + 2 * P);
  }
  __device__ __forceinline__ static uint64_t* tile_bar(int b) {
    return reinterpret_cast<uint64_t*>(flags() + kWarps) + b;
  }
  __device__ __forceinline__ T* tile_buf(int t) const {
    return sm() + coef_offset() + (size_t)M * RS + (t & 1) * tile_elems();
  }
  // chain i of a tick's list (three bits a chain, the first again past the
  // chains with work) and the instantiation a tick of n chains runs
  __device__ __forceinline__ static int chain(unsigned list, int i) {
    return (list >> (3 * i)) & 7;
  }
  __device__ __forceinline__ static int group(int n) {
    return n > 4 ? 8 : n > 2 ? 4 : n;
  }

  __device__ void stage(T* smem) const {
    poly_stage(*this, smem, smem + chain_base(kWarps), smem + coef_offset());
    if constexpr (STREAM) {
      if (threadIdx.x == 0) {
        mbar_init(tile_bar(0), kWarps * 32 + 1);
        mbar_init(tile_bar(1), kWarps * 32 + 1);
      }
      // the staged tiles' stores before the bulk copies that overwrite them
      fence_proxy_async();
    }
  }

  __device__ void bind(T*) {
    const int lane = threadIdx.x & 31;
    // phi past F: zeros, which meet the staged padding's and the last
    // tile's zeros
    T* const phi = sm() + chain_base(threadIdx.x >> 5) + o_phi();
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
  // staged rows, in buffer t & 1. An evaluation's forward pass reads tiles
  // 0 .. NT - 1 (steps 1 .. NT - 1), its back pass NT - 1 .. 0 (steps NT ..
  // 2 NT - 2); step s copies the next tile of its pass into the buffer that
  // the step before read (`step_tile`), so that every evaluation starts
  // with tiles 0 and 1 in their buffers, none in flight. A step waits for
  // its tile (every thread at the buffer's mbarrier) when a copy brought
  // it: steps 2 .. NT - 1 and NT + 1 .. 2 NT - 2.
  __device__ __forceinline__ void load_tile(int t) const {
    if (threadIdx.x != 0) return;
    const unsigned bytes = (unsigned)(tile_elems() * sizeof(T));
    mbar_expect(tile_bar(t & 1), bytes);
    bulk_copy(tile_buf(t), tiles + (size_t)t * tile_elems(), bytes,
              tile_bar(t & 1));
  }
  __device__ __forceinline__ void await_step(int s) const {
    if (s >= 2 && s != NT)
      mbar_arrive_wait(tile_bar((s < NT ? s : 2 * NT - 2 - s) & 1));
  }
  __device__ __forceinline__ int step_tile(int s) const {
    return s < NT ? (s + 1 < NT ? s + 1 : -1) : 2 * NT - 3 - s;
  }

  // ---- the block's products, for the tick's chains ----
  // hdel = Hp del and hdd = Hd dd of each chain (its x and xa buffers, zero
  // past D) into its red buffer: thread t, output j = t mod P for the chains
  // of its group t / P (two groups of the tick's chains at NE <= 4, where a
  // chain's outputs take half the block), each sum over k in order, as
  // `matvec` sums. The Hessians are symmetric (poly_gaussian_spec
  // symmetrizes them, exactly), so output j's k-th product reads H[k, j]:
  // at each k a warp reads one row of H, coalesced, from L2, KC values of
  // k at a time, the next KC's loads in flight while these are summed (a
  // thread reading its own row j, contiguous, was slower: each load of a
  // warp touched 32 lines).
  template <int NC>
  __device__ __forceinline__ void hess(unsigned list, int n) const {
    using V = Vec16<T>;
    using VT = typename V::type;
    constexpr int G = NC > 1 && 2 * P <= kWarps * 32 ? 2 : 1;
    constexpr int NH = NC / G, KC = 8;
    const int Dn = D, j = threadIdx.x % P, h = threadIdx.x / P;
    if (j >= Dn || h >= G) return;
    const bool bon = bound_on, don = decay_on;
    const T *const hp = Hp + j, *const hd = Hd + j;
    T* const s = sm();
    int cb[NH];
    T ap[NH], ad[NH];
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      cb[i] = chain_base(chain(list, h * NH + i));
      ap[i] = T(0);
      ad[i] = T(0);
    }
    // H[k, j] for k = k0 + u, u < KC; past D row D - 1, times a zero delta:
    // +-0, which changes no bit of a sum that started at +0
    auto load = [&](int k0, T (&a)[KC], T (&b)[KC]) {
#pragma unroll
      for (int u = 0; u < KC; ++u) {
        const int k = min(k0 + u, Dn - 1) * Dn;
        a[u] = bon ? __ldg(hp + k) : T(0);
        b[u] = don ? __ldg(hd + k) : T(0);
      }
    };
    auto use = [&](int k0, const T (&a)[KC], const T (&b)[KC]) {
#pragma unroll
      for (int i = 0; i < NH; ++i) {
#pragma unroll
        for (int v = 0; v < KC / kVec; ++v) {
          const VT dv =
              *reinterpret_cast<const VT*>(s + cb[i] + k0 + v * kVec);
          const VT ev =
              *reinterpret_cast<const VT*>(s + cb[i] + P + k0 + v * kVec);
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            ap[i] += a[v * kVec + e] * V::at(dv, e);
            ad[i] += b[v * kVec + e] * V::at(ev, e);
          }
        }
      }
    };
    T a0[KC], b0[KC], a1[KC], b1[KC];
    load(0, a0, b0);
    for (int k0 = 0; k0 < Dn; k0 += 2 * KC) {
      load(k0 + KC, a1, b1);
      use(k0, a0, b0);
      load(k0 + 2 * KC, a0, b0);
      use(k0 + KC, a1, b1);
    }
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      if (h * NH + i < n) {
        s[cb[i] + o_red() + j] = ap[i];
        s[cb[i] + o_red() + P + j] = ad[i];
      }
    }
  }

  // m0 = phi WT of each chain into its g buffer
  template <int NC>
  __device__ __forceinline__ void fwd(unsigned list, int n) const {
    // the fields, as values (a tile step's barrier clobbers memory)
    const int Mn = M, Fn = F, Rn = R, RSn = RS, TWn = TW, NTn = NT,
              NVTn = NVT, swn = swl;
    const T* const wt = WT;
    const T* const tb = sm() + coef_offset() + (size_t)Mn * RSn;  // tiles
    using V = Vec16<T>;
    using VT = typename V::type;
    T* const s = sm();
    const int tid = threadIdx.x;
    int cb[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) cb[i] = chain_base(chain(list, i));
    const int ph = o_phi(), go = o_g();
    const int Rp = (Rn + kVec - 1) / kVec * kVec;
    const T* const W = s + coef_offset();
    constexpr int kPass = kWarps * 32 * kJo;
    auto store = [&](int p0, T (&acc)[kJo][NC]) {
#pragma unroll
      for (int o = 0; o < kJo; ++o) {
        const int j = p0 + tid + kWarps * 32 * o;
#pragma unroll
        for (int i = 0; i < NC; ++i)
          if (j < Mn && i < n) s[cb[i] + go + j] = acc[o][i];
      }
    };
    for (int p0 = 0; p0 < Mn; p0 += kPass) {
      int jc[kJo];
      T acc[kJo][NC];
#pragma unroll
      for (int o = 0; o < kJo; ++o) {
        jc[o] = min(p0 + tid + kWarps * 32 * o, Mn - 1);
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[o][i] = T(0);
      }
#pragma unroll 2
      for (int f0 = 0; f0 < Rp; f0 += kVec) {
        VT wv[kJo];
#pragma unroll
        for (int o = 0; o < kJo; ++o)
          wv[o] = *reinterpret_cast<const VT*>(W + jc[o] * RSn + f0);
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const VT pv = *reinterpret_cast<const VT*>(s + cb[i] + ph + f0);
#pragma unroll
          for (int o = 0; o < kJo; ++o)
#pragma unroll
            for (int e = 0; e < kVec; ++e)
              acc[o][i] += V::at(wv[o], e) * V::at(pv, e);
        }
      }
      if constexpr (!STREAM) {
        // the features past the staged ones, from device memory (L2)
#pragma unroll 4
        for (int f = Rn; f < Fn; ++f) {
          T wl[kJo];
#pragma unroll
          for (int o = 0; o < kJo; ++o)
            wl[o] = __ldg(wt + (size_t)f * Mn + jc[o]);
#pragma unroll
          for (int i = 0; i < NC; ++i) {
            const T p = s[cb[i] + ph + f];
#pragma unroll
            for (int o = 0; o < kJo; ++o) acc[o][i] += wl[o] * p;
          }
        }
      }
      store(p0, acc);
    }
    if constexpr (STREAM) {
      for (int k = 0; k < NTn; ++k) {
        if (k) tile_step(*this, k);
        const T* const tw = tb + (k & 1) * (Mn * TWn);
        const int fo = ph + Rn + k * TWn;
        for (int p0 = 0; p0 < Mn; p0 += kPass) {
          int jc[kJo];
          T acc[kJo][NC];
#pragma unroll
          for (int o = 0; o < kJo; ++o) {
            jc[o] = min(p0 + tid + kWarps * 32 * o, Mn - 1);
#pragma unroll
            for (int i = 0; i < NC; ++i) acc[o][i] = s[cb[i] + go + jc[o]];
          }
#pragma unroll 2
          for (int v = 0; v < NVTn; ++v) {
            VT wv[kJo];
#pragma unroll
            for (int o = 0; o < kJo; ++o)
              wv[o] = *reinterpret_cast<const VT*>(tw + jc[o] * TWn +
                                                   (v ^ swn) * kVec);
#pragma unroll
            for (int i = 0; i < NC; ++i) {
              const VT pv =
                  *reinterpret_cast<const VT*>(s + cb[i] + fo + v * kVec);
#pragma unroll
              for (int o = 0; o < kJo; ++o)
#pragma unroll
                for (int e = 0; e < kVec; ++e)
                  acc[o][i] += V::at(wv[o], e) * V::at(pv, e);
            }
          }
          store(p0, acc);
        }
      }
    }
  }

  // gphi = WT gm0 of each chain (its g buffer) into its gphi buffer: items
  // of 8 features and NCB chains, round robin over the warps (the tiles
  // first, down from the last; then the staged features; then the rest
  // from device memory); each chain's partials over the lane's outputs in
  // order, then the tree across lanes of all of them at once
  // (`reduce_scatter`)
  template <int NCB>
  __device__ __forceinline__ void back(unsigned list, int n) const {
    // the fields, as values (a tile step's barrier clobbers memory)
    const int Mn = M, Fn = F, Rn = R, RSn = RS, TWn = TW, NTn = NT,
              NVTn = NVT, swn = swl;
    const T* const wt = WT;
    const T* const tb = sm() + coef_offset() + (size_t)Mn * RSn;  // tiles
    using V = Vec16<T>;
    using VT = typename V::type;
    constexpr int NV = kBack / kVec;
    T* const s = sm();
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int ncb = (n + NCB - 1) / NCB, nj = (Mn + 31) / 32;
    const int go = o_g(), gp = o_gphi();
    // one item: chains cbk NCB .. of the list, the 8 weights of output jr
    // from `load`, the sums to gphi[f0 ..] below lim
    auto item = [&](int cbk, int f0, int lim, auto&& load) {
      int cb[NCB];
#pragma unroll
      for (int i = 0; i < NCB; ++i)
        cb[i] = chain_base(chain(list, cbk * NCB + i));
      T acc[NCB * kBack];
#pragma unroll
      for (int v = 0; v < NCB * kBack; ++v) acc[v] = T(0);
#pragma unroll(kBackUnroll)
      for (int t = 0; t < nj; ++t) {
        const int j = lane + 32 * t, jr = min(j, Mn - 1);
        T wl[kBack], gj[NCB];
        load(jr, wl);
#pragma unroll
        for (int i = 0; i < NCB; ++i)
          gj[i] = j < Mn ? s[cb[i] + go + jr] : T(0);
#pragma unroll
        for (int i = 0; i < NCB; ++i)
#pragma unroll
          for (int b = 0; b < kBack; ++b)
            acc[i * kBack + b] += wl[b] * gj[i];
      }
      // lane l ends with value l / (32 / (8 NCB)): chain c, feature f
      constexpr int kLanes = 32 / (NCB * kBack);
      const T r = reduce_scatter<T, 16, NCB * kBack>(acc);
      const int v = lane / kLanes, c = v / kBack, f = v % kBack;
      int base = cb[0];
#pragma unroll
      for (int i = 1; i < NCB; ++i)
        if (c == i) base = cb[i];
      if (lane % kLanes == 0 && cbk * NCB + c < n && f0 + f < lim)
        s[base + gp + f0 + f] = r;
    };
    if constexpr (STREAM) {
      const int items = TWn / kBack * ncb;
      for (int k = 0; k < NTn; ++k) {
        const int t = NTn - 1 - k;
        if (k) tile_step(*this, NTn - 1 + k);
        const T* const tw = tb + (t & 1) * (Mn * TWn);
        for (int it = w; it < items; it += kWarps) {
          const int g0 = it / ncb * kBack;
          item(it % ncb, Rn + t * TWn + g0, Fn, [&](int jr, T (&wl)[kBack]) {
#pragma unroll
            for (int v = 0; v < NV; ++v) {
              const VT wv = *reinterpret_cast<const VT*>(
                  tw + jr * TWn + ((g0 / kVec + v) ^ swn) * kVec);
#pragma unroll
              for (int e = 0; e < kVec; ++e) wl[v * kVec + e] = V::at(wv, e);
            }
          });
        }
      }
    }
    const int Rp = (Rn + kVec - 1) / kVec * kVec;
    const T* const W = s + coef_offset();
    const int items = (Rp + kBack - 1) / kBack * ncb;
    for (int it = w; it < items; it += kWarps) {
      const int f0 = it / ncb * kBack;
      item(it % ncb, f0, Rn, [&](int jr, T (&wl)[kBack]) {
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const VT wv = *reinterpret_cast<const VT*>(
              W + jr * RSn + min(f0 + v * kVec, Rp - kVec));
#pragma unroll
          for (int e = 0; e < kVec; ++e) wl[v * kVec + e] = V::at(wv, e);
        }
      });
    }
    if constexpr (!STREAM) {
      const int items = (Fn - Rn + kBack - 1) / kBack * ncb;
      for (int it = w; it < items; it += kWarps) {
        const int f0 = Rn + it / ncb * kBack;
        item(it % ncb, f0, Fn, [&](int jr, T (&wl)[kBack]) {
#pragma unroll
          for (int b = 0; b < kBack; ++b)
            wl[b] = __ldg(wt + (size_t)min(f0 + b, Fn - 1) * Mn + jr);
        });
      }
    }
  }

  // One evaluation: the block's tick, with this warp's chain at x (`work`)
  // or idle. Returns false, having done nothing, when no warp of the block
  // has work. With work: d logp / dx into g, this lane's part of the
  // likelihood's sum into part, the decay penalty into `dec`.
  __device__ __forceinline__ bool eval(bool work, const T (&x)[NE],
                                       T (&g)[NE], T& part_out) const {
    T* const s = sm();
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    T* const own = s + chain_base(w);
    T *const xa = own + P, *const phi = own + o_phi();
    T *const gphi = own + o_gphi(), *const gbuf = own + o_g();
    T *const rbuf = gbuf + up4(M), *const mbuf = rbuf + up4(M);
    // the fields this warp's own parts read, as values (a barrier's memory
    // clobber would have them read from the functor again)
    const int Dn = D, Mn = M, Fn = F, nnz = NNZ;
    const bool bon = bound_on, don = decay_on, fl = full;
    const T al = alpha, al2 = alpha2, gam = gamma;
    const T *const datp = dat, *const vinvp = vinv, *const fmup = fmu;
    const T* const pm = Pm;
    T xm[NE], x0[NE];
    if (work) {
      __syncwarp();  // the lanes are done with the last evaluation's xa
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int d = lane + 32 * e;
        xm[e] = d < Dn ? x[e] : T(0);
        // u = (x - lo) / diff; the bound's delta and the decay's, zero
        // past D, for the block's products
        x0[e] = (xm[e] - s[d]) / s[P + d];
        own[d] = x0[e] - mp[e];
        xa[d] = xm[e] - md[e];
      }
    }
    if (lane == 0) flags()[w] = work ? 1 : 0;
    bar_sync<kBarTile>();  // A: the tick
    unsigned list = 0;
    int n = 0;
#pragma unroll
    for (int c = 0; c < kWarps; ++c)
      if (flags()[c]) list |= (unsigned)c << (3 * n++);
    if (n == 0) return false;
    for (int i = n; i < kWarps; ++i) list |= (list & 7u) << (3 * i);
    if (bon || don) {
      switch (group(n)) {
        case 8: hess<8>(list, n); break;
        case 4: hess<4>(list, n); break;
        case 2: hess<2>(list, n); break;
        default: hess<1>(list, n);
      }
    }
    bar_sync<kBarTile>();  // B: the Hessians' products
    T hdel[NE], hdd[NE];
    bool outside = false;
    T beta = T(1);
    if (work) {
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int d = lane + 32 * e;
        hdel[e] = bon && d < Dn ? own[o_red() + d] : T(0);
        hdd[e] = don && d < Dn ? own[o_red() + P + d] : T(0);
      }
      // the bound: beta^2 = delta' Hp delta, warp-uniform; x0 projected
      if (bon) {
        T sq = T(0);
#pragma unroll
        for (int e = 0; e < NE; ++e) sq += (x0[e] - mp[e]) * hdel[e];
        T b2 = warp_sum(sq);
        b2 = b2 < T(1e-30) ? T(1e-30) : b2;
        beta = m_sqrt(b2);
        outside = beta > al;
        if (outside) {
#pragma unroll
          for (int e = 0; e < NE; ++e)
            x0[e] = (al * x0[e] + (beta - al) * mp[e]) / beta;
        }
      }
#pragma unroll
      for (int e = 0; e < NE; ++e)
        if (lane + 32 * e < Dn) xa[lane + 32 * e] = x0[e];
      if (lane == 0) xa[Dn] = T(1);
      __syncwarp();
      const int* const i1 = reinterpret_cast<const int*>(s + chain_base(kWarps));
#pragma unroll 4
      for (int f = lane; f < Fn; f += 32)
        phi[f] = (xa[i1[f]] * xa[i1[Fn + f]]) * xa[i1[2 * Fn + f]];
    }
    bar_sync<kBarTile>();  // C: every chain's phi
    switch (group(n)) {
      case 8: fwd<8>(list, n); break;
      case 4: fwd<4>(list, n); break;
      case 2: fwd<2>(list, n); break;
      default: fwd<1>(list, n);
    }
    bar_sync<kBarTile>();  // D: every chain's m0
    // the likelihood and d logp / d m0, over this lane's outputs in order
    T part = T(0), sb = T(0);
    if (work) {
      // every output's data, variance and f_mu loaded before the sums
      constexpr int kU = sizeof(T) == 4 ? 16 : 8;
      for (int p0 = 0; p0 < Mn; p0 += 32 * kU) {
        T dv[kU], vv[kU], fv[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int jc = min(p0 + lane + 32 * u, Mn - 1);
          dv[u] = __ldg(datp + jc);
          vv[u] = __ldg(vinvp + jc);
          fv[u] = __ldg(fmup + jc);  // zeros without the bound
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int j = p0 + lane + 32 * u;
          if (j < Mn) {
            const T m0 = gbuf[j];
            const T fm = outside ? fv[u] : T(0);
            const T m =
                outside ? (beta * m0 - (beta - al) * fm) / al : m0;
            const T r = m - dv[u];
            if (fl) {  // the likelihood waits for every r (below)
              rbuf[j] = r;
              if (outside) mbuf[j] = m0 - fm;
            } else {
              const T rv = r * vv[u];
              part += rv * r;
              const T gm = -rv;
              gbuf[j] = outside ? gm * beta / al : gm;
              if (outside) sb += gm * (m0 - fm);
            }
          }
        }
      }
      if (fl) {
        // (P r)_j = sum_k P[k, j] r_k in order of k (P symmetric: row k of
        // P is its column k, read coalesced), four of the lane's outputs at
        // a time; then the likelihood and d logp / d m0
        __syncwarp();
        for (int j0 = lane; j0 < Mn; j0 += 128) {
          T acc[4] = {T(0), T(0), T(0), T(0)};
          for (int k = 0; k < Mn; ++k) {
            const T rk = rbuf[k];
            const T* p = pm + (size_t)k * Mn + j0;
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (j0 + 32 * u < Mn) acc[u] += __ldg(p + 32 * u) * rk;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = j0 + 32 * u;
            if (j < Mn) {
              part += rbuf[j] * acc[u];
              const T gm = -acc[u];
              gbuf[j] = outside ? gm * beta / al : gm;
              if (outside) sb += gm * mbuf[j];
            }
          }
        }
      }
    }
    bar_sync<kBarTile>();  // E: every chain's d logp / d m0
    const int nb = group(n) < kCB ? group(n) : kCB;
    if (nb == kCB)
      back<kCB>(list, n);
    else if (nb == 2)
      back<2>(list, n);
    else
      back<1>(list, n);
    bar_sync<kBarTile>();  // F: every chain's d logp / d phi
    if (!work) return true;
    // d logp / d x0_d over the dimension's sparse row, in order
    const int* const rp =
        reinterpret_cast<const int*>(s + chain_base(kWarps)) + 3 * Fn;
    const int *const cf = rp + Dn + 1, *const c1 = cf + nnz,
              *const c2 = c1 + nnz;
    T g0[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int d = lane + 32 * e;
      T sg = T(0);
      if (d < Dn)
        for (int t = rp[d]; t < rp[d + 1]; ++t)
          sg += gphi[cf[t]] * (xa[c1[t]] * xa[c2[t]]);
      g0[e] = sg;
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
      const T s_beta = sb / al;
      const T dldb = s_beta + dt / beta;
#pragma unroll
      for (int e = 0; e < NE; ++e)
        g[e] = g0[e] * al / beta + dldb * hdel[e] / beta;
    } else {
#pragma unroll
      for (int e = 0; e < NE; ++e) g[e] = g0[e];
    }
    // from u to x
#pragma unroll
    for (int e = 0; e < NE; ++e) g[e] = g[e] / s[P + lane + 32 * e];
    dec = T(0);
    if (don) {
      T sq = T(0);
#pragma unroll
      for (int e = 0; e < NE; ++e) sq += (xm[e] - md[e]) * hdd[e];
      const T ex = warp_sum(sq) - al2;
      if (ex > T(0)) {
        dec = gam * ex;
#pragma unroll
        for (int e = 0; e < NE; ++e) g[e] = g[e] - gam * (T(2) * hdd[e]);
      }
    }
    part_out = part;
    return true;
  }

  __device__ T operator()(const T (&x)[NE], T (&g)[NE]) const {
    T part;
    eval(true, x, g, part);
    return part;
  }
  // idle evaluations, until no warp of the block has work
  __device__ void drain() const {
    const T x[NE] = {};
    T g[NE], part;
    while (eval(false, x, g, part)) {
    }
  }

  __device__ T finish(T sum) const { return (T(-0.5) * sum + nrm) - dec; }
};


// f[8..15]: M, F, NNZ, bound on, decay on, alpha, alpha^2, full
// precision; f[16..21]: the plan's features staged, bytes, stacks in
// shared memory, path (1: streamed tiles), features a tile and a tile's
// bytes (0 and 0 on the other path). The bytes also say which functor
// lays the block out (PolyGaussian's staged Hessians at NE <= 2,
// PolyBlock's chain buffers past): a plan that lays it out otherwise
// fails the launch.
template <typename T, int NE, int KIND, bool STREAM>
cudaError_t launch_poly(const Args<T>& a, const double* f, cudaStream_t s) {
  std::conditional_t<(NE <= 2), PolyGaussian<T, NE, STREAM>,
                     PolyBlock<T, NE, STREAM>>
      p = {};
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
        !swizzled || f[21] != (double)p.M * p.TW * sizeof(T) ||
        (NE > 2 && f[21] >= (double)(1 << 20)))  // an mbarrier's bytes
      return cudaErrorInvalidValue;
    p.NT = (p.F - p.R + p.TW - 1) / p.TW;
  } else if (f[20] != 0.0 || f[21] != 0.0) {
    return cudaErrorInvalidValue;
  }
  p.locate();
  return launch_kernel<T, NE, KIND>(a, p, s, (long long)f[17], f[18] != 0.0);
}

// The entry point of a unit of PolyBlock at one lane width NE (3..8),
// dtype T and path STREAM: the arguments of nuts_traced_launch (ops/
// codegen.py; kind 0 frozen, 1 warmup, 2 block). cudaErrorInvalidValue for
// another dtype, a D whose lane width is not NE, a plan of the other path,
// or arguments the kernels do not take.
template <typename T, int NE, bool STREAM>
cudaError_t launch_poly_unit(int kind, int f64, int C, int D, int K,
                             int maxdepth, uint32_t seed, uint32_t i0,
                             uint32_t cs, int as, int am, const double* f,
                             void* const* p, int n_ptrs, void* stream) {
  if (f64 != (sizeof(T) == 8 ? 1 : 0) || (D + 31) / 32 != NE ||
      kind < kFrozen || kind > kBlock || (f[19] != 0.0) != STREAM)
    return cudaErrorInvalidValue;
  const cudaError_t bad = check_launch(kind, C, D, K, maxdepth, n_ptrs);
  if (bad != cudaSuccess) return bad;
  const Args<T> a = make_args<T>(C, D, K, maxdepth, seed, i0, cs, as, am, f,
                                 p, kind == kWarmup);
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == kBlock) return launch_poly<T, NE, kBlock, STREAM>(a, f, s);
  if (kind == kWarmup) return launch_poly<T, NE, kWarmup, STREAM>(a, f, s);
  return launch_poly<T, NE, kFrozen, STREAM>(a, f, s);
}

}  // namespace
