// NUTS kernels for Hopper (sm_90a), one warp per chain: the densities
// compiled in at D <= 64, their dispatch and the C entry points.
//
// The kernels themselves (`transition`, `nuts_chunk_kernel`,
// `nuts_block_kernel`, `launch_kernel`), which replace the three Pallas TPU
// kernels of the NUTS transitions (bayesfast_tpu/samplers/nuts_pallas.py:431,
// :462, :746), and their design notes are in nuts_kernels.cuh; a density
// traced from a user's torch logp is a functor that ops/codegen.py writes
// into a translation unit of its own against the same header. Here:
// `launch_t`, which picks a compiled-in density by its id
// (ops/densities.py::DENSITY_IDS), at NE = 1 and 2, and the C entry points.
// The densities are in headers whose units of one density and lane width
// take D up to 256 (NE = 3..8): the PolyGaussian surrogate in
// nuts_poly.cuh, the others (Banana, Gaussian, Funnel, Ring, Cauchy) in
// nuts_densities.cuh.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC --fmad=false   (see ../_build.py)

#include "nuts_poly.cuh"

namespace {

template <typename T, int NE, int KIND>
cudaError_t launch_t(const Args<T>& a, int dens, const double* f,
                     cudaStream_t s) {
  switch (dens) {
    case 0: return launch_density<T, NE, KIND, 0>(a, s);
    case 1: return launch_density<T, NE, KIND, 1>(a, s);
    case 2:
      return f[19] != 0.0 ? launch_poly<T, NE, KIND, true>(a, f, s)
                          : launch_poly<T, NE, KIND, false>(a, f, s);
    case 3: return launch_density<T, NE, KIND, 3>(a, s);
    case 4: return launch_density<T, NE, KIND, 4>(a, s);
    case 5: return launch_density<T, NE, KIND, 5>(a, s);
    default: return cudaErrorInvalidValue;
  }
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
  // this library's lane widths; D 65..256 is a unit of its own
  // (nuts_densities.cuh::launch_unit, nuts_poly.cuh::launch_poly_unit)
  if (D <= 32) return launch_ne<T, 1>(kind, a, dens, f, s);
  if (D <= 64) return launch_ne<T, 2>(kind, a, dens, f, s);
  return cudaErrorInvalidValue;
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
// not take (D outside 1..64 here, a malformed pointer table).
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
