// The shape of a NUTS kernel launch (csrc/nuts_kernels.cuh::launch_kernel):
// the warps (chains) a block, the blocks, and the shared memory a block asks
// for. Plain C++ with no CUDA in it, so that the CPU tests build and check
// it as it stands (tests/test_torch_leaf.py). Included by nuts_device.cuh.

#pragma once

#include <stddef.h>

#ifdef __CUDACC__
#define NUTS_HD __host__ __device__ __forceinline__
#else
#define NUTS_HD inline
#endif

namespace {

// chains (warps) a block of a collective density, and the most a block of
// any
constexpr int kWarps = 8;
constexpr size_t kMaxSmem = 232448;  // shared memory a block may use, sm_90

// frames per chain: a frame is stored at level `pending` of a leaf that does
// not finish its subtree, at most maxdepth - 2
NUTS_HD int n_levels(int maxdepth) {
  return maxdepth - 1 > 1 ? maxdepth - 1 : 1;
}

struct LaunchShape {
  int warps, blocks;
  int stk_smem;  // 1: every warp's checkpoint stack is in shared memory
  size_t bytes;  // the shared memory a block asks for
};

// A launch of C chains on a card of n_sm SMs. Warps a block: for a density
// that its warp evaluates alone (`per_warp`), the smallest power of two w
// with ceil(C / w) <= n_sm, or kWarps when none below it gives that, so
// that a launch of few chains spreads over the SMs (at C = 64 a block a
// chain) and many chains keep eight a block; kWarps for a collective
// density, whose tick protocols count the block's eight warps. Shared
// memory: the density's `dens_elems` values, plus every warp's checkpoint
// stack when all of it fits in a block; else the stacks stay in global
// scratch.
inline LaunchShape launch_shape(int C, int D, int maxdepth, size_t dens_elems,
                                size_t itemsize, bool per_warp, int n_sm) {
  int w = kWarps;
  if (per_warp)
    for (int v = 1; v < kWarps; v *= 2)
      if ((C + v - 1) / v <= n_sm) {
        w = v;
        break;
      }
  const size_t frames = (size_t)n_levels(maxdepth) * (4 * (size_t)D + 3);
  LaunchShape s;
  s.warps = w;
  s.blocks = (C + w - 1) / w;
  s.bytes = (dens_elems + w * frames) * itemsize;
  s.stk_smem = s.bytes <= kMaxSmem ? 1 : 0;
  if (!s.stk_smem) s.bytes = dens_elems * itemsize;
  return s;
}

}  // namespace
