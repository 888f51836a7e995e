"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from ``bayesfast_tpu_torch/csrc`` (one nvcc
per source, in parallel), holds each against its plain torch version on the
card, drives the port's paths and checks what comes out:

* sampling: ``bayesfast_tpu_torch.sample`` on the bench's 32-d bounded
  rotated banana with 1024 chains, float32, through warmup and post-warmup
  chunks on the two NUTS chunk kernels ([3]);
* evidence: ``bayesfast_tpu_torch.evidence.GBS`` on that run's post-warmup
  draws under four generator seeds (the SIT flow fit runs its KDE sums on
  the KDE-cdf kernel), held against the banana's exact logz ([6]);
* pooled-metric sampling: the same configuration with
  ``pooled_metric=True``, every warmup transition one launch of the NUTS
  block kernel with the shared Welford update between launches, then the
  frozen chunks ([8]);
* the full metric on the torch tree loop: a correlated 8-d Gaussian with a
  pooled full metric, held against its known covariance ([9]);
* the surrogate Recipe: ``bayesfast_tpu_torch.Recipe.run`` on the DES-like
  pipeline of ``examples/des_like_pipeline.py`` at full width (27
  parameters, a 457-dim data vector) with 1024 chains in float32, every
  sample step on the chunk kernels with the PolyModel -> Gaussian surrogate
  compiled in; n_call and the IS-weighted posterior means against the
  truth ([10]); then both chunk kernels with that density held against
  their plain versions and timed, and held again with a full-covariance
  likelihood ([10b]); [10b] also prints each launch's shared-memory plan
  (the features of the coefficients staged, the checkpoint stacks, the
  bytes a block; a launch fails if the kernel lays a block out otherwise)
  and times the chunks under other plans, whose draws must not change.
* the other samplers, plain torch on the card as they are XLA in the JAX
  package ([11]), each through ``sample`` at 1024 chains: HMC and ChEES on
  the banana of [3] (its moments within 5 standard errors; ChEES's
  trajectory length must adapt), TNUTS and THMC on a tempered Gaussian
  pair at D = 32 in float64 (the importance-weighted moments), the
  ensemble on the banana (rates and acceptance) and on [3b]'s Gaussian
  ([3b]'s gates); each prints its rates, and a profiled HMC warmup call
  its device busy share. HMC, TNUTS, THMC and the ensemble launch no
  kernel: they run first, beside [2]'s nvcc (niced), HMC in this
  process and the others in one of their own (``--free-samplers``); the
  profiled call and ChEES (warm-started from [3]) after [10b]. Then
  [11e]: the NUTS run of [3] and the ChEES run, each checkpointed at the
  end of warmup, loaded and continued, must give the post-warmup draws
  and logp of the uninterrupted runs bit for bit.
* the GBS evidence anchors ([12]): the funnel-16, ring-64 and cauchy-48
  twins of ``examples/{funnel,ring,cauchy}_gbs.py``
  (``bayesfast_tpu_torch/examples``), each ``main()`` at the example's
  configuration (64 chains, 1000 warmup of 2500 iterations, float64, the
  example's seed) under ``nuts_kernel='cuda'``: every transition on the
  chunk kernels with the density compiled in, GBS with its SIT fit on the
  KDE kernel; rhat and logz against the fiducial gated, n_call printed
  beside the JAX package's, the chunk kernels' device seconds beside the
  chunk calls' host seconds. Then each density's chunk and block kernels
  against their plain versions at 64 chains (a block a chain), K = 2,
  float64 and float32 (the cauchy's at depth 8: its trees reach 1023
  leapfrogs), and timed at depth 10; and the cauchy's frozen chunk at 201
  chains (two warps a block, the last block partial).
* the cubic surrogate ([13]): [10]'s Recipe with both sample steps on a
  linear + quadratic + cubic-2 + cubic-3 PolyModel (the reference's
  'cubic-3' order on the nine nonlinear parameters, 238 features), every
  transition on the chunk kernels with that density compiled in; n_call,
  the walls, the launches and the IS-weighted means as [10] prints them.
  The true model is quadratic in those parameters, so the cubic terms fit
  to about 0, and the surrogate has no input_scales: [13] shows the cubic
  spec routed and launched, [13b] runs the cubic arithmetic and the scales.
  Then [13b]: the frozen chunk, warmup chunk and block kernels with a
  cubic surrogate refitted to a seeded cubic term, without and with the
  surrogate's own input_scales, against their plain versions in float64
  and float32 (bitwise), each dtype's shared-memory plan (features
  staged, the streamed tiles' width, the L2 bytes a leapfrog and block),
  and the chunks and a block launch timed; then the chunks under the
  streamed path's other tile widths and with each chain reading the
  unstaged features itself (tile 0), timed and held bitwise to the
  plan's.
* a user's own torch density ([14]): ``bench.py``'s banana-32 written in
  torch (``bayesfast_tpu_torch/examples/user_densities.py``), traced into
  a program whose functor is generated and built in [2] beside the other
  kernels, through ``sample`` at [3]'s configuration under
  ``nuts_kernel='auto'``: every transition on the traced chunk kernels (0
  tree-loop transitions), [3]'s gates, its rates beside [3]'s. Then the
  traced frozen and warmup chunks and a block launch bitwise against the
  program's interpreter at 256 chains, float32 and float64, timed there
  and at 1024 chains beside the compiled-in banana's chunks on the same
  state; the funnel, ring and cauchy user forms' traced frozen chunk
  bitwise in float64 on [12]'s final states; each traced instantiation's
  registers and spills, nvcc seconds and kernel times.
* a ``Density`` plan traced into the kernels ([15]): the 2-d donut Recipe
  (``bayesfast_tpu_torch/examples/donut_recipe.py``, the reference's
  headline example: OptimizeStep on a linear surrogate, two SampleSteps on
  a quadratic one, each plan ending in the user's ``f_1``, the decay, IS
  over 200 draws; 8 chains x 1000 iterations, float64) through
  ``Recipe.run`` under ``nuts_kernel='auto'``: every transition on the
  chunk kernels with the plan's generated functor (0 tree-loop
  transitions), the two plans' units built in [2] from the Recipe's
  objects before any fit and none during the run; n_call and the
  IS-weighted E[r] gated, each step's wall, the chunk calls' host seconds
  and kernel ms. Then the quadratic plan's frozen and warmup chunks and a
  block launch bitwise against the program's interpreter at the Recipe's
  8 chains on its final state, float64 and float32, and timed.
* the kernels past D = 64 ([16]; ``bayesfast_tpu_torch/examples/
  wide_gaussians.py``): Neal's 100-d Gaussian (the compiled-in Gaussian,
  its unit at NE = 4) and Hoffman & Gelman's 250-d MVN (the user's torch
  logp traced, NE = 8, its precision streamed through two shared-memory
  tiles a block), each through
  ``sample`` at 1024 chains, float32, depth 10, seed 32 under
  ``nuts_kernel='auto'`` (0 tree-loop transitions, no unit built during
  the run, post-warmup divergences below 5 %, every coordinate's mean
  within 5 group standard errors of 0; Neal's variances within 10 %, the
  MVN's mean x'Px within 5 % of 250), the MVN also with a pooled metric
  on the block kernel; then [16a]: each new instantiation's frozen and
  warmup chunks (K = 2) and block launch bitwise against their plain
  versions in float32 and float64 on the runs' final states (the MVN's
  at depth 6), and timed at depth 10,
  with the MVN's tile plan and L2 bytes a leapfrog and block; the same
  for column tiles and an odd count of tiles (a D = 4 density with a 4 x
  990 matrix: its adjoint's rows in column tiles, 35 tiles an evaluation
  in float64) at 64 chains; and the MVN's frozen chunk with every tile
  copied twice (a variant of its float32 unit), timed at 1024 chains and
  on one block beside the unit as built: what the copies cost. Their
  seven units are built in [2] beside the others.
* a ``Density`` plan past D = 64 ([17]; ``bayesfast_tpu_torch/examples/
  wide_recipe.py``): the DES-like Recipe at D = 100 (9 parameters with a
  quadratic response, 91 linear, 457 outputs, 1024 chains, float32)
  through ``Recipe.run`` under ``nuts_kernel='cuda'``: every SampleStep on
  the chunk kernels with the compiled-in ``PolyGaussian`` at NE = 4 (a
  unit of its own, its Hessians read from device memory, its coefficients
  streamed through shared tiles), the last one's warmup pooled, one block
  launch a transition; n_call, the walls of each phase and part, the
  kernels' device s by kind, each launch's shared-memory plan; 0 tree-loop
  transitions, block launches in the pooled step and every IS-weighted
  mean within 1 analytic sigma gated. Then [17a]: the frozen chunk, warmup
  chunk and block launch bitwise against their plain versions in float32
  and float64 with ``PolyGaussian`` at NE = 4 (on [17]'s last state) and
  NE = 8 (a D = 250 surrogate on a seeded state), and with MVN-250 written
  as a traced ``Density`` plan (on [16c]'s state); at NE = 4 also on a
  partial last block of 60 chains and on a state whose trees differ widely
  in size (a block's chains finish early, one runs on alone: the block
  evaluates the density for its chains together past D = 64,
  ``PolyBlock``); each plan with WT's shared-memory and the Hessians' L2
  bytes a block and leapfrog; each timed at 1024 chains with its slowest
  chain, bound, registers and spills. The four ``PolyGaussian`` units
  build beside [3]-[9] and are loaded in [2c].

* the JAX package's ``DensityLite`` with a user's own gradient ([18]):
  ``bench.py``'s banana-32 written as a JAX user writes it,
  ``DensityLite(logp=, grad=, vectorized=False)`` with each a function of
  one point and the gradient by hand
  (``bayesfast_tpu_torch/examples/user_densities.py::bench_banana_user``),
  its pair traced into a program with no adjoint and generated as a unit
  in [2], through ``sample`` at [3]'s configuration under
  ``nuts_kernel='cuda'``: 0 tree-loop transitions, no unit built during
  the run, [3]'s gates and the moments within 5 standard errors, its
  rates and its chunk kernels' device seconds beside [14]'s (the tracer's
  adjoint of the same logp), both programs' K = 2 chunks on one state.
  Then the frozen and warmup chunks (K = 2) and a block launch of both
  forms (``grad=`` and the batched ``logp_and_grad=``, one unit) bitwise
  against the program's interpreter at 256 chains, float32 and float64,
  at depth 8; last, the external form (``traceable=False``, numpy) over
  1024 rows on the host pool against the torch logp, and ``sample()`` on
  it refused before any device work.

The build's ``-Xptxas -v`` report, kept beside the library, gives each
NUTS kernel's registers and spills ([2b]); a PolyGaussian, Funnel, Ring or
Cauchy instantiation that spills fails the run, except float64 at D > 32,
and so does a traced one in float32 or at NE = 1; [16]'s units at NE = 4
and 8 are printed, not gated (past NE = 2 a lane's state spills). Each
phase prints its wall, and a line before the last ones all of them.

Each path runs with every launch count set to 0 just before it and read
just after. Every phase that fails makes the script exit non-zero; without
a CUDA device it exits non-zero before printing any result. Run from the
repository root, with no arguments:

    python3 chip_smoke.py

Output, last lines: the card's name and power limit as nvidia-smi reports
them, one JSON line with each kernel's measurements, and
``{"ok": true, "device": {...}}``.

Registers and spills past D = 64 at every lane width (the Gaussian's units
and a traced x'Px at NE = 3..8, float32 and float64, built in parallel):

    python3 chip_smoke.py --ptxas-sweep

A/B against another checkout on the same card:

    python3 chip_smoke.py --ab PARENT [--gbs-seeds N]

PARENT is a directory holding the other checkout's ``bayesfast_tpu_torch/``
(for example ``git archive <commit> bayesfast_tpu_torch | tar -x -C
bayesfast_tpu_torch/build/parent``). The script then runs ``_ab_one`` once
per checkout, in the order PARENT, this checkout, this checkout, PARENT,
each in a process of its own that imports that checkout's package and
builds its kernels, and prints every reading and the ratios of the two
checkouts' means. Each process runs [3] and [8] (warmup and post-warmup
it/s), [10] and [13] (each Recipe's n_call, largest IS-weighted deviation
and chunk-kernel device seconds) and, on the final states, draws and
surrogates that the first process saved, so that every process times the
same inputs, [5]'s chunks, [10b]'s PolyGaussian chunks and [13b]'s cubic
ones (float32 and float64) and [8c]'s block launch with their slowest
chains, [7]'s KDE kernel,
[8d]'s pooled transitions and busy share, [16a]'s MVN-250 K = 2 frozen
and warmup chunks and block launch (float32, device only, on a state at
1024 chains that the first process samples) with the L2 bytes a leapfrog
and block and the unit's registers and spills, and GBS on the per-chain
draws under generator seeds 0 to N - 1 (default 5). Its readings go to
``--work`` (default ``bayesfast_tpu_torch/build/ab``), one JSON file a
process. Each process also runs [12]'s three anchor runs (n_call, logz,
rhat_max, the draws' digest, the chunk kernels' device seconds) and times,
on the device alone, each anchor's K = 2 chunks on its run's final state
(float64 and float32) and its user form's (traced, float64), the traced
banana's on [3]'s state and Neal-100's on a seeded one (float32, 1024
chains). Last, the A/B says whether the banana draws of [3] and [8], the
Recipes' n_call and deviation, [10b]'s and [13b]'s outputs, [12]'s runs, a
frozen and a warmup chunk of each of [12]'s anchors and of [14]'s traced
banana (float64, a seeded state) and MVN-250's chunks and block launch are
bitwise equal in all four processes, and
exits 1 if one is not, or if this checkout's build spills ([2b]). It also
prints each library's nvcc seconds, each checkout built alone.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np

_REPO = os.path.dirname(os.path.abspath(__file__))

# the bench configuration (bench.py)
N_CHAIN, D, Q, N_WARMUP, N_POST = 1024, 32, 0.01, 400, 300
# transitions per chunk in the kernel-vs-plain checks: the plain versions'
# eager calls are most of the smoke's wall; 2 keeps a warmup chunk's
# window switch inside the chunk
K_CMP = 2
MAX_TREEDEPTH, MAX_CHANGE = 10, 1000.
# [9]: the tree loop on a correlated Gaussian (200 + 150 iterations since
# [15] came: the covariance's error read 0.01 at 300 + 300, the gate 0.2)
TREE_D, TREE_CHAINS, TREE_WARMUP, TREE_POST, TREE_COV_TOL = 8, 256, 200, 150, 0.2
# GBS as benchmarks/suite.py:197 runs it, and the banana's exact logz
# (benchmarks/results.jsonl, "fiducial")
F_CALL, N_Q_MAX, LOGZ_EXACT, LOGZ_TOL = 0.05, 100_000, -127.364, 0.25
# [6]'s generator seeds: a seed's logz spreads by sd 0.007-0.009, well
# inside the gate on the mean (its quoted error, ~0.021)
GBS_SEEDS = 4
KDE_M = 512        # queries per column in the KDE kernel-vs-plain checks
KDE_F32_TOL = 2e-6  # the float32 kernel against the float64 plain version
# [10]: the DES-like Recipe (examples/des_like_pipeline.py) at full width
DES_D, DES_N_DATA, DES_CHAINS, DES_TRUTH = 27, 457, 1024, 0.1
DES_NONLINEAR = np.arange(9)      # parameters with quadratic response
DES_TRACES = ({'n_iter': 1500, 'n_warmup': 600},
              {'n_iter': 1200, 'n_warmup': 400})
DES_N_IS, DES_JAX_NCALL, DES_REF_NCALL = 500, 1128, 2626
# [13b]: the cubic surrogate's fit points (of [13]'s last step's draws)
CUBIC_FIT = 1000
# [11]: the other samplers at the bench width, plain torch on the card;
# iterations cut below [3]'s 400 + 300 to fit the smoke's time (the post
# iterations cut again when [15] came: each gate is in standard errors)
H_WARMUP, H_POST, HMC_STEPS = 1000, 75, 32   # HMC on banana-32
C_WARMUP, C_POST = 200, 40         # ChEES on banana-32, warm-started
T_D, T_VAR, T_BASE_VAR = 32, 0.5, 4.0   # the tempered Gaussian pair
T_WARMUP, T_POST = 70, 30          # TNUTS
TH_WARMUP, TH_POST, THMC_STEPS = 100, 60, 16
E_WARMUP, E_POST = 500, 300        # the ensemble on banana-32
EG_WARMUP, EG_POST = 1000, 750     # the ensemble on [3b]'s Gaussian
N_PROFILE = 20                     # HMC warmup transitions profiled
# [12]: the GBS anchors, run as their twins run them (the examples'
# configuration: 64 chains, 1000 warmup of 2500 iterations, float64); the
# JAX package's n_call (benchmarks/results.jsonl) beside the port's, and
# the fiducial logz each must meet within ANCHOR_SIGMAS quoted errors
ANCHORS = (('funnel', 16, '3.06 M'), ('ring', 64, '10.2 M'),
           ('cauchy', 48, '32.4-33.8 M'))
ANCHOR_RHAT, ANCHOR_SIGMAS = 1.02, 4.0
# the trees' depth limit of the cauchy's bitwise checks ([12], and its
# user form's in [14]): its trees reach 1023 leapfrogs, each leaf of the
# plain version a few dozen eager torch calls; timed at depth 10
ANCHOR_CHECK_DEPTH = {'cauchy': 8}
# the chains of [12]'s further cauchy check: two warps a block, the last
# block partial (csrc/nuts_launch.cuh::launch_shape)
ANCHOR_WIDE_CHAINS = 201
# [14]: a user's own torch densities (bayesfast_tpu_torch/examples/
# user_densities.py) traced into the kernels: the generated units built in
# [2] (the bench banana in both dtypes, the anchors' user forms in
# float64), and the chains of the traced banana's bitwise checks
TRACED_UNITS = (('bench_banana', 'float32'), ('bench_banana', 'float64'),
                ('funnel', 'float64'), ('ring', 'float64'),
                ('cauchy', 'float64'))
TRACED_CHAINS = 256
# [18]: the bench banana with the user's own gradient
# (bayesfast_tpu_torch/examples/user_densities.py::bench_banana_user): its
# two forms (grad= of one point under vectorized=False, and the batched
# logp_and_grad=) generate one unit a dtype, built in [2]; the trees' depth
# limit of their bitwise checks at TRACED_CHAINS chains (a leaf of the
# plain version is some 30 eager torch calls; the kernels are timed at
# depth 10), the external form's rows on the host pool and its tolerance
# against the torch logp (both float64)
USER_FORMS = ('grad', 'logp_and_grad')
USER_CHECK_DEPTH, USER_EXT_ROWS, USER_EXT_RTOL = 8, 1024, 1e-10
# [15]: the 2-d donut Recipe (bayesfast_tpu_torch/examples/donut_recipe.py,
# the reference's headline example; 8 chains, float64): n_call at most the
# notebook's ~330 plus 20 %, and the IS-weighted E[r] within DONUT_R_TOL of
# the analytic mean of r under the donut, 5 + 0.25 / 5
DONUT_NCALL, DONUT_R, DONUT_R_TOL = 400, 5.05, 0.25
DONUT_UNITS = (('linear', 'float64'), ('quadratic', 'float64'),
               ('quadratic', 'float32'))
# [16]: past D = 64 (bayesfast_tpu_torch/examples/wide_gaussians.py):
# Neal's 100-d Gaussian compiled in (a unit at NE = 4) and Hoffman &
# Gelman's 250-d MVN traced (NE = 8), through sample() at 1024 chains,
# float32, depth 10, seed 32 under 'auto'; the units built in [2]. The
# iterations are cut to [16]'s two minutes: each gate is in standard
# errors of its own run, or relative (Neal's variances, the MVN's x'Px)
WIDE_UNITS = (('neal_100', 'float32'), ('neal_100', 'float64'),
              ('mvn_250', 'float32'), ('mvn_250', 'float64'),
              ('wide_4', 'float32'), ('wide_4', 'float64'))
COPIES_TWICE = 'mvn_250 float32, tiles copied twice'
WIDE_CHAINS, WIDE_SEED, WIDE_GROUPS = 1024, 32, 32
NEAL_WARMUP, NEAL_POST = 300, 200
MVN_WARMUP, MVN_POST, MVN_POOLED_WARMUP, MVN_POOLED_POST = 200, 100, 100, 20
# [16a]: transitions a chunk, and the chains of the MVN's plain float32
# chunk (its plain version runs a 256 x 256 matvec per leaf and chain) and
# of every float64 check
WIDE_K, MVN_CMP_CHAINS, WIDE_F64_CHAINS = 2, 64, 64
# [17]: the DES-like Recipe at D = 100 (bayesfast_tpu_torch/examples/
# wide_recipe.py: 457 outputs, 1024 chains, float32, its own iterations)
# under 'cuda', its generator seed; [17a]: the PolyGaussian units at NE = 4
# (D = 100) and NE = 8 (D = 250), float32 and float64, built in [2]; the
# chains of their bitwise checks and of the MVN plan's, and the trees'
# depth limit of the checks at D = 250 (a leaf of the plain version is
# some 4 D + F torch calls, and a launch lasts as long as its deepest
# tree; the kernels are timed at depth 10), the D = 250 surrogate's fit
# points
WIDE_RECIPE_SEED, WIDE_POLY_DIMS = 27, (100, 250)
WIDE_POLY_CHAINS, WIDE_NE8_CHAINS, MVN_PLAN_CHAINS = 64, 32, 16
WIDE_CHECK_DEPTH, WIDE_POLY_FIT = 6, 600
# [17a]'s further NE = 4 checks, at depth WIDE_CHECK_DEPTH: a partial last
# block of [17]'s last state, and a state of mixed tree sizes
# (``_mixed_state``)
WIDE_PARTIAL_CHAINS, WIDE_MIXED_CHAINS = 60, 24
# --ab: MVN-250's saved state, from a per-chain sample() at 1024 chains,
# float32, seed 32 of this many warmup + post iterations (the first process)
MVN_AB_WARMUP, MVN_AB_POST = 100, 10
# the niceness of the background builds' nvcc (``_Background``)
NVCC_NICE = 10
# one NVIDIA H100 SXM: fp32 and fp64 outside the tensor cores (NVIDIA's
# data sheet), device memory
PEAK_FP32, PEAK_FP64, PEAK_BYTES = 67e12, 34e12, 3.35e12
# operations per Phi evaluation of the KDE kernel (csrc/kde.cu's note):
# difference, divide, scale, some 20 for the erf, the multiply-add of the sum
KDE_OPS_PER_PHI = 25


def _nvidia_smi():
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as exc:
        return f'nvidia-smi unavailable ({exc!r})'


def _nbytes(*objs):
    """Bytes of every tensor in ``objs`` (tensors, tuples, dicts)."""
    import torch
    n = 0
    for o in objs:
        if torch.is_tensor(o):
            n += o.numel() * o.element_size()
        elif isinstance(o, dict):
            n += _nbytes(*o.values())
        elif isinstance(o, (tuple, list)):
            n += _nbytes(*o)
    return n


def _bound(ops, nbytes, peak=PEAK_FP32):
    """(bound_ms, bound_by): the larger of the operations over the peak
    rate of their type (default fp32) and the bytes over the memory
    rate."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else \
        (t_bytes, 'bytes')


def _leapfrog_ops(dim):
    """Operations of one leapfrog of the banana behind the fused bound
    transform, read off csrc/nuts.cu: two D x D matvecs (4 D^2) and about
    85 elementwise operations per dimension (the transform and its
    log-Jacobian, the banana terms and their gradient, the momentum and
    position updates, the energy and U-turn sums)."""
    return 4 * dim * dim + 85 * dim


def _anchor_leapfrog_ops(name, dim):
    """Operations of one leapfrog of an anchor density behind the fused
    bound transform, read off csrc/nuts.cu: about 70 a dimension for the
    transition's own (the banana's 85 less its terms: the transform and its
    log-Jacobian, the integrator, the energy and U-turn sums), plus the
    density's: the funnel's x_i^2, its sum and -x_i e^(-2 b x0) (4 a
    dimension) and some 40 on lane 0 (the exponential, the butterfly, g_0,
    logp); the ring's squares, two neighbour sums, the gradient's product
    and divide and the logp term (10); the cauchy's two shifted squares,
    two reciprocals, the sum, a log (~20) and the gradient (37)."""
    per_dim = {'funnel': 4, 'ring': 10, 'cauchy': 37}[name]
    return (70 + per_dim) * dim + (40 if name == 'funnel' else 0)


def _time_ms(torch, fn, n):
    """Mean ms of ``n`` calls after a warm one (CUDA events); returns
    (ms, the warm call's result)."""
    out = fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n, out


class _CallEvents:
    """CUDA events around every call of the NUTS kernels' C entry points
    (``nuts_chunk_launch``, ``nuts_block_launch``, ``nuts_traced_launch``)
    of every library loaded, inside the wrappers: a launch's device time
    without the wrapper's host work before it (the spec lookup, the
    allocations), which a small launch does not hide. A context manager;
    ``events`` holds (kind, K, start, end) a launch, ``device_ms()`` their
    sum once the card is done."""
    _NAMES = ('nuts_chunk_launch', 'nuts_block_launch', 'nuts_traced_launch')

    def __init__(self, torch):
        self.torch, self.events, self._saved = torch, [], []
        self._patched = set()

    @staticmethod
    def _kind(name, args):
        if name == 'nuts_chunk_launch':
            return ('warmup' if args[0] else 'frozen'), int(args[5])
        if name == 'nuts_block_launch':
            return 'block', 1
        return ('frozen', 'warmup', 'block')[args[0]], int(args[4])

    def __enter__(self):
        from bayesfast_tpu_torch import _build
        for lib in list(_build._libs.values()):
            self._patch(lib)
        # a library loaded while the context lasts (a generated unit's at
        # its first launch) is patched as it is handed to the wrapper
        for loader in ('load_library', 'load_traced'):
            fn = getattr(_build, loader)
            self._saved.append((_build, loader, fn))
            setattr(_build, loader, self._loading(fn))
        return self

    def _loading(self, load):
        def call(*args, **kwargs):
            lib = load(*args, **kwargs)
            self._patch(lib)
            return lib
        return call

    def _patch(self, lib):
        if id(lib) in self._patched:
            return
        self._patched.add(id(lib))
        for name in self._NAMES:
            fn = getattr(lib, name, None)
            if fn is not None:
                self._saved.append((lib, name, fn))
                setattr(lib, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        torch = self.torch

        def call(*args):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            err = fn(*args)
            e1.record()
            self.events.append((*self._kind(name, args), e0, e1))
            return err
        return call

    def __exit__(self, *exc):
        for obj, name, fn in reversed(self._saved):
            setattr(obj, name, fn)
        self._saved, self._patched = [], set()

    def device_ms(self):
        self.torch.cuda.synchronize()
        return sum(e0.elapsed_time(e1) for *_, e0, e1 in self.events)


def _device_ms(torch, fn, n):
    """Mean device ms of the launches of ``n`` calls of ``fn`` after a warm
    one (``_CallEvents``); returns (ms a call, the warm call's result)."""
    out = fn()
    torch.cuda.synchronize()
    with _CallEvents(torch) as ev:
        for _ in range(n):
            fn()
    return ev.device_ms() / n, out


def _plain_once(torch, fn):
    """One call of a plain version timed with CUDA events (its host syncs
    wait on the card); returns (ms, its result). Each comparison times its
    plain call so, and the timing tables quote that call."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1), out


def _ms_text(ms):
    return 'not timed' if ms is None else f'{ms:.3f} ms'


def _bench_density(dtype):
    from scipy.stats import special_ortho_group
    from bayesfast_tpu_torch.interop import banana_density
    bounds = np.stack((np.full(D, -15.), np.full(D, 15.))).T
    const = float(np.sum(np.log(bounds[:, 1] - bounds[:, 0])))
    A = special_ortho_group.rvs(D, random_state=0)
    return A, banana_density(A, Q, bounds, const, dtype=dtype)


_DISCRETE = ('tree_depth', 'tree_size', 'diverging')


def _as_dict(q, q_last, stats):
    d = dict(stats._asdict(), q=q, q_final=q_last)
    d['diverging'] = d['diverging'].int()
    return d


def _compare(name, ker, ref, n_chain=N_CHAIN):
    """The kernel's outputs must equal the plain version's bit for bit (the
    plain versions take every operation and sum in the kernels' order).
    Prints on how many chains the tree statistics agree and the largest
    float difference; returns that difference."""
    import torch
    same = torch.ones(n_chain, dtype=torch.bool, device=ref['q'].device)
    for k in _DISCRETE:
        same &= (ker[k] == ref[k]).reshape(-1, n_chain).all(dim=0)
    frac = same.float().mean().item()
    bad = (~same).nonzero().flatten().tolist()
    if bad:
        print(f'  {name}: discrete stats differ on chains {bad[:20]}')
    max_err = 0.0
    for k in ref:
        if k in _DISCRETE:
            continue
        a, b = ker[k].double(), ref[k].double()
        # equal infinities (a diverged energy) agree
        err = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
        max_err = max(max_err, err.max().item())
    bitwise = all(torch.equal(ker[k], ref[k]) for k in ref)
    print(f'  {name}: bitwise equal: {bitwise}; discrete agree on '
          f'{frac:.4%} of chains, max abs err {max_err:.3e} -> '
          f'{"ok" if bitwise else "FAIL"}')
    if not bitwise:
        raise AssertionError(f'{name}: kernel disagrees with its plain '
                             'version')
    return max_err


def _counters():
    """Every kernel wrapper's launch counter, by kernel name."""
    from bayesfast_tpu_torch.ops import kde as tk
    from bayesfast_tpu_torch.samplers import nuts_cuda as nc
    return {'nuts_warmup': nc.nuts_warmup_chunk_batched,
            'nuts_multi': nc.nuts_chunk_batched,
            'nuts_block': nc.nuts_transition_batched,
            'kde_cdf': tk.kde_cdf_batch}


def _sample_path(torch, bt, den, A, tag, expect, checkpoint=None,
                 **trace_kw):
    """The bench configuration through ``sample``: a 2-iteration start-up
    call, the rest of warmup, then post-warmup in three calls; every launch
    count set to 0 just before and read just after. Checks the counts
    against ``expect``, the samples and the banana's moments; returns
    (trace tuple, launches, rates): warmup and post-warmup it/s, ESS/s.
    With ``checkpoint`` a path, the trace is saved there at the end of
    warmup ([11e] resumes it)."""
    bt.utils.set_generator(32)
    trace = bt.NTrace(n_chain=N_CHAIN, n_iter=N_WARMUP + N_POST,
                      n_warmup=N_WARMUP, **trace_kw)
    for f in _counters().values():
        f.launches = 0
    t0 = time.time()
    tt = bt.sample(den, trace, n_run=2, verbose=False, n_update=2)
    t_start = time.time() - t0
    torch.cuda.synchronize()
    t0 = time.time()
    tt = bt.sample(den, tt, n_run=N_WARMUP - 2, verbose=False, n_update=100)
    torch.cuda.synchronize()
    dt_warm = time.time() - t0
    if checkpoint is not None:
        bt.utils.checkpoint.save(tt, checkpoint)
    dt_post = 0.0
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        tt = bt.sample(den, tt, n_run=N_POST // 3, verbose=False,
                       n_update=N_POST // 3)
        torch.cuda.synchronize()
        dt_post += time.time() - t0
    launches = {k: f.launches for k, f in _counters().items()}
    print(f'{tag}: launches {launches} (expected {expect})')
    if any(launches[k] != expect.get(k, 0) for k in launches):
        raise AssertionError('the main path did not run every transition '
                             'on the kernels')
    s_t = tt.trace.samples
    s = tt.get(flatten=False)
    if not (np.isfinite(s_t).all() and np.isfinite(s).all()
            and s.shape == (N_CHAIN, N_POST, D)):
        raise AssertionError(f'non-finite or misshapen samples {s.shape}')
    st = tt.trace._stats_arrays
    div_post = float(np.mean(st['diverging'][:, N_WARMUP:]))
    size_post = float(np.mean(st['tree_size'][:, N_WARMUP:]))
    depth_post = float(np.mean(st['tree_depth'][:, N_WARMUP:]))
    acc_post = float(np.mean(st['mean_tree_accept'][:, N_WARMUP:]))
    ess = float(np.mean(_ess(s)))
    rates = dict(warmup_its=N_CHAIN * (N_WARMUP - 2) / dt_warm,
                 post_its=N_CHAIN * N_POST / dt_post, ess_s=ess / dt_post)
    print(f'    start-up call (Sobol, descent, probe, 2 iterations) '
          f'{t_start:.2f} s')
    print(f'    warmup {rates["warmup_its"]:.1f} it/s, post '
          f'{rates["post_its"]:.1f} it/s, ESS/s {rates["ess_s"]:.1f}'
          f' (ESS {ess:.1f})')
    print(f'    post-warmup: mean tree size {size_post:.2f}, depth '
          f'{depth_post:.3f}, accept {acc_post:.4f}, divergent '
          f'{div_post:.4f}, leapfrogs/s '
          f'{N_CHAIN * N_POST * size_post / dt_post:.4g}')
    if not div_post < 0.05:
        raise AssertionError(f'post-warmup divergence fraction {div_post}')
    if not acc_post > 0.5:
        raise AssertionError(f'post-warmup acceptance {acc_post}')
    # the banana's own moments: z = A x has E[z_even] = 1 and
    # E[z_odd] = E[z_even^2] = 1.5
    z = s.reshape(-1, D) @ A.T
    zm = (z[:, 0::2].mean(), z[:, 1::2].mean())
    print(f'    posterior E[z_even] {zm[0]:.4f} (1), E[z_odd] {zm[1]:.4f} '
          f'(1.5)')
    if not (abs(zm[0] - 1.0) < 0.1 and abs(zm[1] - 1.5) < 0.2):
        raise AssertionError(f'banana moments off: {zm}')
    return tt, launches, rates


def _kernel_vs_plain(torch, den, carry, dtype):
    """Both kernels against their plain versions at C=1024, D=32, K=2 on
    the main path's final state (positions, adapted metric and step size)
    cast to ``dtype``, plus the chain_start split. Returns the max abs
    errors and the plain versions' ms (each the one call compared)."""
    from bayesfast_tpu_torch.samplers import nuts_cuda as nc
    from bayesfast_tpu_torch.samplers.metrics import init_diag_metric
    from bayesfast_tpu_torch.samplers.step_size import init_step_size
    q = carry.q.to(dtype).contiguous()
    var = nc._mat(carry.metric.var, N_CHAIN, D, q)
    eps = torch.exp(carry.step.log_bar).to(dtype)
    den = den if dtype == torch.float32 else _bench_density(dtype)[1]
    plain_lpg = nc.plain_lpg(den)
    seed, i0 = 20240601, 37
    tag = str(dtype).replace('torch.', '')
    errs, plain_ms = {}, {}

    # frozen chunk
    metric = init_diag_metric(q, var)
    ker = _as_dict(*nc.nuts_chunk_batched(seed, q, metric, eps, K_CMP,
                                          MAX_TREEDEPTH, MAX_CHANGE,
                                          density=den, i0=i0))
    plain_ms['nuts_multi'], o = _plain_once(torch, lambda: nc.nuts_chunk_plain(
        seed, q, var, eps, K_CMP, MAX_TREEDEPTH, MAX_CHANGE, plain_lpg, i0))
    ref = _as_dict(o['q'], o['q_final'], nc._chunk_stats(o, dtype))
    print(f'  frozen {tag}: mean tree depth '
          f'{ref["tree_depth"].float().mean().item():.3f}, divergent '
          f'{ref["diverging"].float().mean().item():.4f}')
    errs['nuts_multi'] = _compare(f'nuts_multi {tag}', ker, ref)

    # warmup chunk, with a refresh and a window switch inside it
    wsched, _ = nc._window_schedule(4, 0, 5, K_CMP, 1, True)
    step = init_step_size(eps)
    args = (K_CMP, MAX_TREEDEPTH, MAX_CHANGE, 0.8, 0.05, 0.75, 10., True,
            True, wsched)
    ker = nc.nuts_warmup_chunk_batched(seed, q, step, metric, *args,
                                       density=den, i0=i0)
    steps, mets = nc._warmup_leaves(q, step, metric)
    plain_ms['nuts_warmup'], ref = _plain_once(
        torch, lambda: nc.nuts_warmup_chunk_plain(seed, q, steps, mets, *args,
                                                  plain_lpg, i0))
    errs['nuts_warmup'] = _compare(f'nuts_warmup {tag}', ker, ref)

    # a chain_start split is bitwise equal within the kernel
    h = N_CHAIN // 2
    full = nc.nuts_chunk_batched(seed, q, metric, eps, K_CMP, MAX_TREEDEPTH,
                                 MAX_CHANGE, density=den, i0=i0)
    m_a = init_diag_metric(q[:h], var[:h])
    m_b = init_diag_metric(q[h:], var[h:])
    a = nc.nuts_chunk_batched(seed, q[:h], m_a, eps[:h], K_CMP,
                              MAX_TREEDEPTH, MAX_CHANGE, density=den, i0=i0)
    b = nc.nuts_chunk_batched(seed, q[h:], m_b, eps[h:], K_CMP,
                              MAX_TREEDEPTH, MAX_CHANGE, density=den, i0=i0,
                              chain_start=h)
    split_ok = (torch.equal(full[0], torch.cat([a[0], b[0]], dim=1))
                and torch.equal(full[2].tree_size,
                                torch.cat([a[2].tree_size, b[2].tree_size],
                                          dim=1)))
    print(f'  chain_start split {tag}: '
          f'{"bitwise equal" if split_ok else "FAIL"}')
    if not split_ok:
        raise AssertionError('chain_start split is not bitwise equal')
    return errs, plain_ms


def _time_chunks(torch, den, carry, plain_ms=None, ops=None, suffix='',
                 peak=PEAK_FP32, timer=_time_ms, k=K_CMP):
    """One K=2 (``k``) chunk of each kernel at a path's shapes and final
    state
    (CUDA events; the kernel warmed up first), beside the plain version's
    ms that its comparison measured (``plain_ms``, by name + suffix; None:
    not timed), and the chunk's bound from the leapfrogs its trees took
    times ``ops`` per leapfrog (default: the banana's) over ``peak``.
    Returns ({name + suffix: (ms, plain_ms, bound_ms, bound_by)}, {name +
    suffix: its slowest chain, ``_slowest_chain``}, {name: the warm call's
    outputs}). ``timer``: ``_time_ms`` (the wrapper's calls, CUDA events)
    or ``_device_ms`` (the launches alone)."""
    from bayesfast_tpu_torch.samplers import nuts_cuda as nc
    q, metric, step = carry.q, carry.metric, carry.step
    C, dim = q.shape
    ops = _leapfrog_ops(dim) if ops is None else ops
    var = nc._mat(metric.var, C, dim, q)
    eps = torch.exp(step.log_bar)
    wsched, _ = nc._window_schedule(400, 370, 240, k, 1, True)
    args = (k, MAX_TREEDEPTH, MAX_CHANGE, 0.8, 0.05, 0.75, 10., True,
            True, wsched)
    steps, mets = nc._warmup_leaves(q, step, metric)
    runs = {
        'nuts_multi': (
            lambda: nc.nuts_chunk_batched(5, q, metric, eps, k,
                                          MAX_TREEDEPTH, MAX_CHANGE,
                                          density=den, i0=700),
            (q, var, eps)),
        'nuts_warmup': (
            lambda: nc.nuts_warmup_chunk_batched(5, q, step, metric, *args,
                                                 density=den, i0=700),
            (q, steps, mets)),
    }
    times, chains, outs = {}, {}, {}
    for name, (kern, inputs) in runs.items():
        ms, out = timer(torch, kern, 5)
        outs[name] = out
        p_ms = (plain_ms or {}).get(name + suffix)
        sizes = (out[2].tree_size if name == 'nuts_multi'
                 else out['tree_size'])
        leapfrogs = int(sizes.sum())
        bound = _bound(leapfrogs * ops, _nbytes(inputs, out), peak)
        times[name + suffix] = (ms, p_ms) + bound
        print(f'  {name}{suffix}: one K={k} chunk at C={C}, D={dim}, '
              f'{str(q.dtype)[6:]}: kernel {ms:.3f} ms, plain torch '
              f'{_ms_text(p_ms)}; {leapfrogs} leapfrogs, bound '
              f'{bound[0]:.4f} ms ({bound[1]})')
        chains[name + suffix] = _slowest_chain(f'  {name}{suffix}', ms,
                                               sizes.sum(dim=0))
    return times, chains, outs


def _slowest_chain(tag, ms, sizes):
    """Print the max and mean per-chain leapfrog count of a launch and the
    launch's ns per leapfrog on its slowest chain (a launch lasts as long as
    that chain's serial chain of leapfrogs); returns them."""
    mx, mean = int(sizes.max()), float(sizes.float().mean())
    print(f'{tag}: per-chain leapfrogs max {mx}, mean {mean:.2f}; '
          f'{1e6 * ms / mx:.1f} ns per leapfrog on the slowest chain')
    return dict(ms=ms, max_leapfrogs=mx, mean_leapfrogs=mean,
                ns_per_leapfrog=1e6 * ms / mx)


def _block_inputs(torch, carry, dtype):
    """The block kernel's inputs on a pooled carry, cast to ``dtype``: the
    positions, the shared (D,) variance as a diag state and the per-chain
    warmup step sizes."""
    from bayesfast_tpu_torch.samplers.metrics import init_diag_metric
    q = carry.q.to(dtype).contiguous()
    var = carry.metric.var.to(dtype)
    return (q, init_diag_metric(torch.zeros_like(var), var),
            torch.exp(carry.step.log_step).to(dtype))


def _block_vs_plain(torch, den, carry, dtype):
    """[8b] The block kernel against its plain version at C=1024, D=32 on
    the pooled path's final state, and 4 block launches under
    ``_transition_seed`` seeds against one K=2 chunk launch (bitwise).
    Returns the max abs error and the plain version's ms (the call
    compared)."""
    from bayesfast_tpu_torch.samplers import nuts_cuda as nc
    den = den if dtype == torch.float32 else _bench_density(dtype)[1]
    q, metric, eps = _block_inputs(torch, carry, dtype)
    var = nc._mat(metric.var, N_CHAIN, D, q)
    seed, i0 = 20240601, 37
    tag = str(dtype).replace('torch.', '')

    def rows(q_new, stats):
        d = dict(stats._asdict(), q=q_new)
        d['diverging'] = d['diverging'].int()
        return d

    ker = rows(*nc.nuts_transition_batched(seed, q, metric, eps,
                                           MAX_TREEDEPTH, MAX_CHANGE,
                                           density=den))
    plain_ms, o = _plain_once(torch, lambda: nc.nuts_block_plain(
        seed, q, var, eps, MAX_TREEDEPTH, MAX_CHANGE, nc.plain_lpg(den)))
    ref = rows(o['q'], nc._chunk_stats(o, dtype))
    print(f'  block {tag}: mean tree depth '
          f'{ref["tree_depth"].float().mean().item():.3f}, divergent '
          f'{ref["diverging"].float().mean().item():.4f}')
    err = _compare(f'nuts_block {tag}', ker, ref)

    # transition t of a chunk is a block launch under the folded seed
    qc, qf, sc = nc.nuts_chunk_batched(seed, q, metric, eps, K_CMP,
                                       MAX_TREEDEPTH, MAX_CHANGE,
                                       density=den, i0=i0)
    qb, same = q, True
    for t in range(K_CMP):
        qb, sb = nc.nuts_transition_batched(
            nc._transition_seed(seed, i0, t), qb, metric, eps,
            MAX_TREEDEPTH, MAX_CHANGE, density=den)
        same &= torch.equal(qb, qc[t]) and all(
            torch.equal(a, b[t]) for a, b in zip(sb, sc))
    same &= torch.equal(qb, qf)
    print(f'  {K_CMP} block launches vs one K={K_CMP} chunk {tag}: '
          f'{"bitwise equal" if same else "FAIL"}')
    if not same:
        raise AssertionError('block launches differ from the chunk')
    return err, plain_ms


def _time_block(torch, den, q, metric, eps, plain_ms=None, ops=None,
                peak=PEAK_FP32, tag='[8c]', timer=_time_ms):
    """One block launch on ``q`` under ``metric`` and step sizes ``eps``
    (CUDA events; [8c] on the pooled path's final state, [12] on an
    anchor's) beside the plain version's ms that its comparison measured
    (``plain_ms``; None: not timed), and its bound from the leapfrogs its
    trees took times ``ops`` per leapfrog (default: the banana's) over
    ``peak``. Returns ((ms, plain_ms, bound_ms, bound_by), its slowest
    chain)."""
    from bayesfast_tpu_torch.samplers import nuts_cuda as nc
    C, dim = q.shape
    ops = _leapfrog_ops(dim) if ops is None else ops
    ms, out = timer(torch, lambda: nc.nuts_transition_batched(
        5, q, metric, eps, MAX_TREEDEPTH, MAX_CHANGE, density=den), 10)
    leapfrogs = int(out[1].tree_size.sum())
    bound = _bound(leapfrogs * ops, _nbytes(q, metric.var, eps, out), peak)
    print(f'{tag} one block transition at C={C}, D={dim}, '
          f'{str(q.dtype)[6:]}: kernel {ms:.3f} ms, plain torch '
          f'{_ms_text(plain_ms)}; {leapfrogs} leapfrogs, bound '
          f'{bound[0]:.4f} ms ({bound[1]})')
    return (ms, plain_ms) + bound, _slowest_chain(tag, ms, out[1].tree_size)


def _tree_loop(torch, bt):
    """[9] The full metric on the torch tree loop, on the card: a
    correlated Gaussian (no kernel spec) with a pooled full metric, its
    sample covariance held against the known one. Returns the launch
    counts of the run (all 0: the tree loop is plain torch)."""
    from bayesfast_tpu_torch.samplers.metrics import FullMetricState
    rng = np.random.default_rng(9)
    L = np.tril(rng.normal(size=(TREE_D, TREE_D)) * 0.4) + np.diag(
        np.linspace(0.5, 1.5, TREE_D))
    cov = L @ L.T
    prec = torch.as_tensor(np.linalg.inv(cov), dtype=torch.float32,
                           device=bt.config.get_device())
    den = bt.DensityLite(
        logp=lambda x: -0.5 * torch.sum((x @ prec) * x, -1),
        input_size=TREE_D)
    for f in _counters().values():
        f.launches = 0
    t0 = time.time()
    tt = bt.sample(den, bt.NTrace(n_chain=TREE_CHAINS,
                                  n_iter=TREE_WARMUP + TREE_POST,
                                  n_warmup=TREE_WARMUP, metric='full',
                                  pooled_metric=True, random_generator=9),
                   verbose=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: f.launches for k, f in _counters().items()}
    s = tt.get()
    err = float(np.abs(np.cov(s, rowvar=False) - cov).max())
    ms = tt.trace._carry.metric
    st = tt.trace._stats_arrays
    print(f'[9] tree loop, full pooled metric, Gaussian D={TREE_D}, '
          f'{TREE_CHAINS} chains, {TREE_WARMUP} + {TREE_POST} iterations, '
          f'float32: wall {wall:.2f} s, post-warmup mean tree size '
          f'{st["tree_size"][:, TREE_WARMUP:].mean():.2f}; max |sample cov '
          f'- cov| {err:.4f} (gate {TREE_COV_TOL}); launches {launches}')
    if not (isinstance(ms, FullMetricState) and ms.cov.is_cuda
            and tuple(ms.cov.shape) == (TREE_D, TREE_D)):
        raise AssertionError('the run did not keep a pooled full metric on '
                             'the card')
    if not (np.isfinite(s).all() and err < TREE_COV_TOL):
        raise AssertionError(f'tree-loop covariance off by {err}')
    if any(launches.values()):
        raise AssertionError('the tree loop launched a kernel')
    return launches


def _ess(s):
    """ESS per dimension of draws ``s`` (C, N, D), summed over 8 chain
    groups (``utils/acor.py``), as [3] reports it."""
    from bayesfast_tpu_torch.utils.acor import effective_sample_size
    gs = s.shape[0] // 8
    return sum(effective_sample_size(s[g * gs:(g + 1) * gs])
               for g in range(8))


def _smoke_dir():
    """A gitignored directory of the checkout for [11]'s checkpoints."""
    path = os.path.join(_REPO, 'bayesfast_tpu_torch', 'build', 'smoke')
    os.makedirs(path, exist_ok=True)
    return path


def _run_sampler(torch, bt, den, trace, tag, n_warm, n_post, saves=()):
    """``trace`` through ``sample`` as [3] runs NUTS: a 2-iteration
    start-up call, the rest of warmup, then post-warmup in one call; every
    kernel's launch count set to 0 just before and read just after (these
    samplers launch none). ``saves`` are (iteration, path) pairs at which
    the trace is checkpointed. Prints warmup and post-warmup it/s,
    leapfrogs/s (logp evaluations/s for the ensemble), ESS/s, the
    post-warmup acceptance and divergence; returns (trace tuple, rates)."""
    for f in _counters().values():
        f.launches = 0
    cuts = sorted({2, n_warm, *(i for i, _ in saves)})
    t0 = time.time()
    tt = bt.sample(den, trace, n_run=2, verbose=False)
    t_start = time.time() - t0
    dt_warm = 0.0
    for a, b in zip(cuts[:-1], cuts[1:]):
        torch.cuda.synchronize()
        t0 = time.time()
        tt = bt.sample(den, tt, n_run=b - a, verbose=False)
        torch.cuda.synchronize()
        dt_warm += time.time() - t0
        for i, path in saves:
            if i == b:
                bt.utils.checkpoint.save(tt, path)
    torch.cuda.synchronize()
    t0 = time.time()
    tt = bt.sample(den, tt, n_run=n_post, verbose=False)
    torch.cuda.synchronize()
    dt_post = time.time() - t0
    launches = {k: f.launches for k, f in _counters().items()}
    if any(launches.values()):
        raise AssertionError(f'{tag} launched a NUTS kernel: {launches}')
    C = trace.n_chain
    s = tt.get(flatten=False)
    if not (np.isfinite(tt.trace.samples).all() and np.isfinite(s).all()
            and s.shape[:2] == (C, n_post)):
        raise AssertionError(f'{tag}: non-finite or misshapen samples')
    st = tt.trace._stats_arrays
    post = {k: np.asarray(v[:, n_warm:], np.float64) for k, v in st.items()}
    ensemble = isinstance(trace, bt.ETrace)
    if ensemble:
        steps, unit = 1.0, 'logp evaluations/s'
        acc = post['accepted'].mean()
        div = 0.0
    else:
        steps = post['tree_size' if 'tree_size' in post else
                     'n_int_step'].mean()
        unit = 'leapfrogs/s'
        acc = post['mean_tree_accept' if 'mean_tree_accept' in post
                   else 'accept_stat'].mean()
        div = post['diverging'].mean()
    ess = float(np.mean(_ess(s)))
    rates = dict(warmup_its=C * (n_warm - 2) / dt_warm,
                 post_its=C * n_post / dt_post, ess_s=ess / dt_post,
                 steps_s=C * n_post * steps / dt_post, accept=float(acc),
                 diverging=float(div), post_s=dt_post, start_s=t_start)
    print(f'{tag}: {C} chains, D={s.shape[-1]}, {n_warm} + {n_post} '
          f'iterations, launches {launches}')
    print(f'    start-up call (2 iterations) {t_start:.2f} s; warmup '
          f'{rates["warmup_its"]:.1f} it/s, post {rates["post_its"]:.1f} '
          f'it/s, {unit} {rates["steps_s"]:.4g}, ESS/s '
          f'{rates["ess_s"]:.1f} (ESS {ess:.1f} a dimension)')
    print(f'    post-warmup: mean {"leapfrogs" if not ensemble else "steps"}'
          f' an iteration {steps:.2f}, accept {acc:.4f}, divergent '
          f'{div:.4f}')
    if not div < 0.05:
        raise AssertionError(f'{tag}: post-warmup divergence {div}')
    return tt, rates


def _group_se(stat, x, n_groups=32):
    """Standard error of ``stat`` over the chains of ``x`` (C, ...) from
    its spread over ``n_groups`` groups of chains: the chains are
    independent, so this counts every correlation along a chain."""
    n_groups = min(n_groups, x.shape[0])
    gs = x.shape[0] // n_groups
    vals = np.array([stat(x[g * gs:(g + 1) * gs]) for g in range(n_groups)])
    return vals.std(0, ddof=1) / np.sqrt(n_groups)


def _banana_moments(tt, A, tag):
    """The banana's moments E[z_even] = 1 and E[z_odd] = 1.5 (z = A x),
    each within 5 standard errors. The statistic is the per-draw mean of
    the even (odd) coordinates; its standard error sd / sqrt(ESS) (ESS of
    that series, ``utils/acor.py``), or the spread over 32 groups of chains
    where that is larger (a slowly mixing run's short chains
    underestimate their integrated time)."""
    z = tt.get(flatten=False) @ A.T
    for name, y, want in (('z_even', z[..., 0::2].mean(-1), 1.0),
                          ('z_odd', z[..., 1::2].mean(-1), 1.5)):
        ess = float(_ess(y[..., None])[0])
        se_ess = float(y.std() / np.sqrt(ess))
        se_grp = float(_group_se(np.mean, y))
        tol = 5 * max(se_ess, se_grp)
        m = float(y.mean())
        print(f'    E[{name}] {m:.4f} ({want}), tolerance {tol:.4f} (5 se; '
              f'sd / sqrt(ESS {ess:.1f}) {se_ess:.5f}, over chain groups '
              f'{se_grp:.5f})')
        if not abs(m - want) < tol:
            raise AssertionError(f'{tag}: E[{name}] {m} off {want} by more '
                                 f'than {tol}')


def _weighted(s, w):
    """Importance-weighted mean and variance per dimension of draws ``s``
    (..., D) with weights ``w`` (...)."""
    sf, wf = s.reshape(-1, s.shape[-1]), w.reshape(-1)
    mean = (sf * wf[:, None]).sum(0) / wf.sum()
    return mean, ((sf - mean) ** 2 * wf[:, None]).sum(0) / wf.sum()


def _tempered_moments(tt, tag):
    """[11c]'s gates: every weight > 0, u on both sides of 0 on > 2 % of
    draws, and in every dimension the importance-weighted mean within 5
    standard errors of 0 and variance within 5 of 0.5. The standard errors
    are sd / sqrt(ESS) and 0.5 sqrt(2 / ESS), ESS the smaller of the
    weights' Kish ESS and the ``utils/acor.py`` ESS, or the spread over 32
    groups of chains where that is larger: a chain's draws stay in one
    tempering phase for long stretches, which neither ESS sees."""
    s = tt.get(flatten=False, original_space=False)
    w = tt.get(return_type='weights', flatten=False)
    u = tt.get(return_type='u', flatten=True)
    wf = w.reshape(-1)
    below, above = float((u < 0).mean()), float((u > 0).mean())
    kish = float(wf.sum() ** 2 / (wf ** 2).sum())
    ess_acor = _ess(s)
    ess = np.minimum(kish, ess_acor)
    mean, var = _weighted(s, w)
    sw = np.concatenate([s, w[..., None]], axis=-1)
    se_grp_m = _group_se(lambda x: _weighted(x[..., :-1], x[..., -1])[0], sw)
    se_grp_v = _group_se(lambda x: _weighted(x[..., :-1], x[..., -1])[1], sw)
    tol_m = 5 * np.maximum(np.sqrt(var / ess), se_grp_m)
    tol_v = 5 * np.maximum(T_VAR * np.sqrt(2.0 / ess), se_grp_v)
    print(f'    weights: min {wf.min():.4g}, Kish ESS {kish:.1f}; acor ESS '
          f'min {ess_acor.min():.1f} / mean {ess_acor.mean():.1f}; u < 0 on '
          f'{below:.3f}, u > 0 on {above:.3f} of draws')
    print(f'    standard errors, mean over dimensions: from the ESS '
          f'{np.mean(np.sqrt(var / ess)):.5f} (mean), '
          f'{np.mean(T_VAR * np.sqrt(2.0 / ess)):.5f} (variance); over '
          f'chain groups {se_grp_m.mean():.5f}, {se_grp_v.mean():.5f}')
    print(f'    weighted mean: max |mean| / tolerance '
          f'{np.max(np.abs(mean) / tol_m):.3f} (max |mean| '
          f'{np.abs(mean).max():.4f}, tolerances {tol_m.min():.4f}-'
          f'{tol_m.max():.4f}); weighted variance: max |var - {T_VAR}| / '
          f'tolerance {np.max(np.abs(var - T_VAR) / tol_v):.3f} (max '
          f'{np.abs(var - T_VAR).max():.4f}, tolerances {tol_v.min():.4f}-'
          f'{tol_v.max():.4f})')
    if not (np.all(wf > 0) and below > 0.02 and above > 0.02):
        raise AssertionError(f'{tag}: weights or temperature off')
    if not (np.all(np.abs(mean) < tol_m)
            and np.all(np.abs(var - T_VAR) < tol_v)):
        raise AssertionError(f'{tag}: weighted moments off')


def _tempered_pair(torch, bt):
    """The tempered Gaussian pair of ``tests/test_tempered.py`` at D = 32:
    target variance 0.5, base variance 4 (unnormalized), and ``logxi`` that
    puts the two normalizers level."""
    def gauss(var):
        return bt.DensityLite(logp=bt.ops.DiagGaussian(
            np.zeros(T_D), np.full(T_D, var), dtype=torch.float64),
            input_size=T_D)
    return (gauss(T_VAR), gauss(T_BASE_VAR),
            0.5 * T_D * np.log(T_VAR / T_BASE_VAR))


def _hmc(torch, bt, den, A):
    """[11a] HMC through ``sample`` at 1024 chains; it launches no kernel,
    so it runs beside [2]'s nvcc (niced). Checkpoints HMC ``N_PROFILE``
    transitions before the end of its warmup for ``_other_samplers``'
    profiled call; returns its rates."""
    # ---- [11a] HMC on banana-32, from the Sobol starts (the descent and
    # the step probe as for NUTS). With 32 leapfrogs its chains need ~1000
    # warmup iterations before the banana's moments settle (700 leave
    # E[z_odd] 6 standard errors high, in the JAX package too) ----
    bt.utils.set_generator(32)
    prof_path = os.path.join(_smoke_dir(), 'hmc_warmup.pkl')
    tt, rates = _run_sampler(
        torch, bt, den, bt.HTrace(n_chain=N_CHAIN, n_iter=H_WARMUP + H_POST,
                                  n_warmup=H_WARMUP, n_int_step=HMC_STEPS),
        '[11a] HMC, banana-32', H_WARMUP, H_POST,
        saves=[(H_WARMUP - N_PROFILE, prof_path)])
    _banana_moments(tt, A, '[11a]')
    return rates


def _tempered_and_ensemble():
    """``--free-samplers``: [11c] TNUTS and THMC on the tempered Gaussian
    pair and [11d] the ensemble through ``sample`` at 1024 chains, in a
    process of their own that ``main`` starts beside [2]'s build and
    [11a] (none of them launches a kernel). Returns 0; a gate that fails
    raises."""
    import torch
    sys.path.insert(0, _REPO)
    import bayesfast_tpu_torch as bt
    warnings.filterwarnings('ignore', message='for chain #')
    bt.config.set_nuts_kernel('cuda')
    den = _bench_density(torch.float32)[1]
    out = {}
    # ---- [11c] TNUTS and THMC on the tempered Gaussian pair, in float64:
    # in float32 the base phase's weights (delta up to ~130 at D = 32)
    # underflow to 0 ----
    target, base, logxi = _tempered_pair(torch, bt)
    bt.config.set_dtype(torch.float64)
    for name, cls, n_w, n_p, kw in (
            ('TNUTS', bt.TNTrace, T_WARMUP, T_POST, {}),
            ('THMC', bt.THTrace, TH_WARMUP, TH_POST,
             {'n_int_step': THMC_STEPS})):
        bt.utils.set_generator(32)
        trace = cls(density_base=base, logxi=logxi, n_chain=N_CHAIN,
                    n_iter=n_w + n_p, n_warmup=n_w, **kw)
        tt, out[name] = _run_sampler(
            torch, bt, target, trace,
            f'[11c] {name}, tempered Gaussian, float64', n_w, n_p)
        _tempered_moments(tt, f'[11c] {name}')
        if name == 'TNUTS':
            print(f'    TNUTS on the tree loop: '
                  f'{out[name]["post_s"] / n_p:.4f} s a post-warmup '
                  'transition')
    bt.config.set_dtype(torch.float32)
    # ---- [11d] the ensemble: banana-32, then [3b]'s Gaussian ----
    bt.utils.set_generator(32)
    te, out['Ensemble'] = _run_sampler(
        torch, bt, den, bt.ETrace(n_chain=N_CHAIN, n_iter=E_WARMUP + E_POST,
                                  n_warmup=E_WARMUP),
        '[11d] ensemble, banana-32', E_WARMUP, E_POST)
    if not 0 < out['Ensemble']['accept'] < 1:
        raise AssertionError('[11d]: ensemble acceptance out of (0, 1)')
    mean, var_g, den_g = _diag_gaussian(torch, bt)
    bt.utils.set_generator(3)
    tg, out['Ensemble_gauss'] = _run_sampler(
        torch, bt, den_g, bt.ETrace(n_chain=N_CHAIN,
                                    n_iter=EG_WARMUP + EG_POST,
                                    n_warmup=EG_WARMUP),
        "[11d] ensemble, [3b]'s Gaussian", EG_WARMUP, EG_POST)
    _gaussian_gate(tg.get(), mean, var_g, '[11d]')
    return 0


class _Process:
    """``chip_smoke.py *args`` in a process of its own, started at once,
    its output kept in a temporary file; ``join()`` waits for it, prints
    its output and raises if it failed. A process not joined is killed at
    exit."""

    def __init__(self, *args):
        import atexit
        import tempfile
        self._args = args
        self._out = tempfile.TemporaryFile('w+')
        self._proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *args],
            stdout=self._out, stderr=subprocess.STDOUT, text=True)
        atexit.register(self._proc.kill)

    def join(self):
        rc = self._proc.wait()
        self._out.seek(0)
        sys.stdout.write(self._out.read())
        self._out.close()
        if rc != 0:
            raise RuntimeError(f'chip_smoke.py {" ".join(self._args)} '
                               f'failed (exit code {rc})')


def _other_samplers(torch, bt, den, A, nuts_tt, nuts_path):
    """[11] the samplers that need [3] or the card to themselves: [11a]'s
    profiled HMC warmup call (from ``_hmc``'s checkpoint), ChEES
    warm-started from [3]'s last draws, then the checkpoint resume of
    [11e] against the uninterrupted NUTS run of [3] (``nuts_tt``, saved at
    the end of its warmup to ``nuts_path``) and the ChEES run of [11b].
    Returns the rates by sampler."""
    out = {}
    work = _smoke_dir()
    # one HMC warmup call of N_PROFILE transitions, resumed from its
    # checkpoint
    tp = bt.utils.checkpoint.load(os.path.join(work, 'hmc_warmup.pkl'))
    out['HMC_busy'] = _device_share(
        torch, f'[11a] profiled HMC warmup call ({N_PROFILE} transitions)',
        lambda: bt.sample(den, tp, n_run=N_PROFILE, verbose=False))
    # ---- [11b] ChEES on banana-32, warm-started as a Recipe step is: from
    # [3]'s last draws with the diag metric of its draws, held fixed. From
    # the Sobol starts its shared trajectory locks short (the clip at eps
    # x max_leapfrogs meets the step's early dip) and 1000 warmup
    # iterations leave E[z_odd] 10-20 standard errors low, in the JAX
    # package too ----
    bt.utils.set_generator(32)
    chees_path = os.path.join(work, 'chees_warmup.pkl')
    tc, out['CHEES'] = _run_sampler(
        torch, bt, den, bt.CTrace(
            n_chain=N_CHAIN, n_iter=C_WARMUP + C_POST, n_warmup=C_WARMUP,
            x_0=nuts_tt.get(flatten=False)[:, -1],
            metric=bt.samplers._get_metric(nuts_tt, 'diag'),
            adapt_metric=False),
        '[11b] ChEES, banana-32, warm-started', C_WARMUP, C_POST,
        saves=[(C_WARMUP, chees_path)])
    _banana_moments(tc, A, '[11b]')
    tl = tc.trace._stats_arrays['traj_len'][0]
    # the stats record the length each transition used: post-warmup
    # transitions all use the last warmup update's
    print(f'    trajectory length {tl[0]:.4f} at the start, '
          f'{tl[C_WARMUP]:.4f} after warmup; mean leapfrogs an iteration '
          f'{tc.trace._stats_arrays["n_int_step"][0].mean():.2f}')
    if not (abs(np.log(tl[C_WARMUP])) > 0.01
            and np.all(tl[C_WARMUP:] == tl[C_WARMUP])):
        raise AssertionError('[11b]: the trajectory length did not adapt in '
                             'warmup, or moved after it')
    # ---- [11e] checkpoint resume on the card ----
    for name, path, ref, n_w in (('NUTS', nuts_path, nuts_tt, N_WARMUP),
                                 ('ChEES', chees_path, tc, C_WARMUP)):
        tr = bt.TraceTuple.load(path)
        if any(t.device.type != 'cpu' for t in _tensors(tr.trace._carry)):
            raise AssertionError(f'[11e] {name}: the checkpoint kept device '
                                 'tensors')
        tr = bt.sample(den, tr, verbose=False)
        same = (np.array_equal(tr.trace.samples[:, n_w:],
                               ref.trace.samples[:, n_w:])
                and np.array_equal(tr.trace.logp[:, n_w:],
                                   ref.trace.logp[:, n_w:]))
        print(f'[11e] {name}: saved at the end of warmup ({n_w}), loaded '
              f'(its carry on the CPU), {tr.i_iter - n_w} post-warmup '
              f'iterations on the card: draws and logp bitwise equal to the '
              f'uninterrupted run: {same}')
        if not same:
            raise AssertionError(f'[11e] {name}: the resumed run differs')
    return out


def _diag_gaussian(torch, bt):
    """[3b]'s bounded diagonal Gaussian, D = 8: (mean, variance,
    density)."""
    mean = np.linspace(-2., 2., 8)
    var_g = np.linspace(0.2, 3., 8)
    den_g = bt.DensityLite(
        logp=bt.ops.DiagGaussian(mean, var_g, dtype=torch.float32),
        input_size=8, input_scales=np.stack([np.full(8, -20.),
                                             np.full(8, 20.)]).T,
        hard_bounds=True)
    return mean, var_g, den_g


def _gaussian_gate(sg, mean, var_g, tag):
    """[3b]'s moment gates on draws ``sg`` (N, 8)."""
    m_err = np.max(np.abs(sg.mean(0) - mean) / np.sqrt(var_g))
    v_err = np.max(np.abs(sg.var(0) / var_g - 1))
    print(f'{tag} diag Gaussian D=8: max |mean err| / sd {m_err:.4f} (gate '
          f'0.05), max |var ratio - 1| {v_err:.4f} (gate 0.1)')
    if not (np.isfinite(sg).all() and m_err < 0.05 and v_err < 0.1):
        raise AssertionError(f'{tag}: diag Gaussian moments off')


def _gbs_on_trace(bt, tt, den):
    """[6] GBS on the main path's post-warmup draws under generator seeds
    0 .. GBS_SEEDS - 1, the KDE launches of the first run read just after
    it. Gate: the mean logz over the seeds within the mean quoted error of
    the exact logz, and every seed's logz within LOGZ_TOL of it (a single
    seed's logz moves by the seeds' spread, sd 0.011-0.014, whenever the
    KDE's rounding moves). Returns the kde_cdf launches of one GBS run."""
    from bayesfast_tpu_torch.ops import kde as tk
    n_half = N_CHAIN // 2
    runs = []
    for seed in range(GBS_SEEDS):
        bt.utils.set_generator(seed)
        for f in _counters().values():
            f.launches = 0
        t0 = time.time()
        gbs = bt.evidence.GBS(f_call=F_CALL, n_q_max=N_Q_MAX)
        logz, err = gbs(tt, den.logp)
        wall = time.time() - t0
        runs.append((float(logz), float(err)))
        if seed == 0:
            launches = tk.kde_cdf_batch.launches
            prof = {k: round(v, 3) for k, v in gbs.last_profile.items()}
            fit = {k: round(v, 3) for k, v in gbs.sit.last_profile.items()}
            print(f'[6] GBS(f_call={F_CALL}, n_q_max={N_Q_MAX}) on {n_half} '
                  f'x {N_POST} fit rows x {D} dims, {gbs.sit.i_iter} SIT '
                  f'layers, float32, seed 0: logz {logz:.4f} +- {err:.4f} '
                  f'(exact {LOGZ_EXACT}); wall {wall:.3f} s')
            print(f'    phases (s): {prof}; kde_cdf launches {launches}')
            print(f'    SIT fit stages (s): {fit}')
    z = np.array([r[0] for r in runs])
    e = np.array([r[1] for r in runs])
    print(f'    seeds 0-{GBS_SEEDS - 1}: logz ' +
          ', '.join(f'{v:.4f}' for v in z))
    print(f'    mean logz {z.mean():.4f} (sd {z.std(ddof=1):.4f}), mean '
          f'quoted error {e.mean():.4f}; |mean - exact| '
          f'{abs(z.mean() - LOGZ_EXACT):.4f}, max |logz - exact| '
          f'{np.abs(z - LOGZ_EXACT).max():.4f} (gate {LOGZ_TOL})')
    if not (np.isfinite(z).all() and np.all((0 < e) & (e < 0.1))
            and abs(z.mean() - LOGZ_EXACT) <= e.mean()
            and np.all(np.abs(z - LOGZ_EXACT) <= LOGZ_TOL)):
        raise AssertionError(f'GBS logz over seeds is off: {runs}')
    if launches == 0:
        raise AssertionError('the SIT fit did not launch the KDE kernel')
    return launches


def _device_share(torch, tag, fn):
    """``fn()`` under torch.profiler: the device's kernel time (its busy
    time, one stream) over the run's host wall, and the kernels that take
    the most of it; returns the busy share (None if not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    # the device's activity alone, read from the raw events: with the
    # host's every operator recorded, or the events parsed into
    # key_averages(), reading them took 15-30 s a call
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    by_name = {}  # each device event's name: (ns, count)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ns, n = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (ns + e.duration_ns(), n + 1)
    busy = sum(ns for ns, _ in by_name.values()) / 1e9
    if busy == 0:
        print(f'{tag}: the profiler recorded no device time; device busy '
              'share not measured')
        return None
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    print(f'{tag}: wall {wall:.3f} s, device busy {busy:.3f} s '
          f'({100 * busy / wall:.1f} %), idle {100 * (1 - busy / wall):.1f} '
          '%; top device kernels:')
    for key, (ns, n) in top:
        print(f'    {ns / 1e6:9.2f} ms  {n:6d} x  {key[:90]}')
    return busy / wall


def _pooled_step_share(torch, den, carry, n):
    """[8d] ``n`` pooled warmup transitions of ``ChainDriver.run`` from the
    pooled path's final state: host ms per transition without the
    profiler, then the device busy share under it; returns both."""
    from bayesfast_tpu_torch.config import get_nuts_kernel
    from bayesfast_tpu_torch.samplers.chain import ChainDriver
    drv = ChainDriver(den, max_treedepth=MAX_TREEDEPTH, pooled_metric=True,
                      nuts_kernel=get_nuts_kernel())
    drv.run(carry, [True] * 2)
    torch.cuda.synchronize()
    t0 = time.time()
    drv.run(carry, [True] * n)
    torch.cuda.synchronize()
    ms = 1e3 * (time.time() - t0) / n
    print(f'[8d] {n} pooled warmup transitions (ChainDriver.run, no '
          f'back-transform): {ms:.3f} ms each')
    return ms, _device_share(torch, f'[8d] profiled {n} transitions',
                             lambda: drv.run(carry, [True] * n))


def _kde_inputs(torch, draws, dtype, n_cut=0, m=KDE_M):
    """The KDE kernel's inputs at the SIT fit's shape, on the card: the
    first half of the chains' post-warmup ``draws`` (C, N, D), as GBS fits
    them, standardized, as D columns of points (less the last ``n_cut``),
    ``m`` sorted queries a column, equal weights and Scott-rule
    bandwidths; returns (x, data, w, h) in ``dtype``."""
    dim = draws.shape[-1]
    y = draws[:draws.shape[0] // 2].reshape(-1, dim)
    y = (y - y.mean(0)) / y.std(0)
    y = y[:y.shape[0] - n_cut]
    N = y.shape[0]
    xq = np.sort(np.random.default_rng(7).normal(size=(dim, KDE_M)) * 1.5,
                 axis=1)[:, :m]
    h = y.std(0) * N ** -0.2
    return [torch.as_tensor(a, dtype=dtype, device=torch.device('cuda', 0))
            for a in (xq, y.T.copy(), np.full(N, 1.0 / N), h)]


def _kde_library(torch, x, data, w, h):
    """The KDE cdf sums as PyTorch calls, 1024 points a block: ``ndtr`` of
    the standardized differences and a ``matmul`` with the weights (the
    library time beside the KDE kernel; the port never calls it). x (D,
    M), data (D, N), w (N,), h (D,) -> (D, M)."""
    acc = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    for j in range(0, data.shape[1], 1024):
        z = (x[:, :, None] - data[:, None, j:j + 1024]) / h[:, None, None]
        acc += torch.matmul(torch.special.ndtr(z), w[j:j + 1024])
    return acc


def _kde_vs_plain(torch, tt):
    """[7] The KDE kernel against its plain version at the SIT fit's shape
    (D = 32 columns of the main path's draws, M = 512 queries, N = 153,600
    points) and at M = 500, N = 153,595 (a short last split and group and
    masked queries), both forms of Phi, float32 and float64, and D = 1
    through kde_cdf_device; then its time beside its bound, the plain
    version and the blocked ndtr + matmul formulation. Returns the float32
    max abs error and (ms, plain_ms, bound_ms, bound_by, library_ms)."""
    from bayesfast_tpu_torch.ops import kde as tk
    draws = tt.get(flatten=False)
    err32, outs = 0.0, {}
    # (points cut, queries): the SIT fit's shape, then one whose last split
    # and last group are short and whose last block masks 12 queries
    shapes = ((0, KDE_M), (5, KDE_M - 12))
    for dt in (torch.float64, torch.float32):
        tag = str(dt).replace('torch.', '')
        for n_cut, m in shapes:
            x, data, w, hd = _kde_inputs(torch, draws, dt, n_cut, m)
            for erf in ('exact', 'as'):
                k = tk.kde_cdf_batch(x, data, w, hd, erf)
                torch.cuda.synchronize()
                p = tk.kde_cdf_batch_plain(x, data, w, hd, erf)
                e = (k.double() - p.double()).abs().max().item()
                k1 = tk.kde_cdf_device(x[3], data[3], w, hd[3], erf)
                p1 = tk.kde_cdf_batch_plain(x[3:4], data[3:4], w, hd[3:4],
                                            erf)[0]
                e1 = (k1.double() - p1.double()).abs().max().item()
                bitwise = torch.equal(k, p) and torch.equal(k1, p1)
                if n_cut == 0:
                    outs[dt, erf] = (k, p)
                print(f'  kde_cdf {tag} {erf} M={m} N={data.shape[1]}: D={D} '
                      f'max abs err {e:.3e}, D=1 {e1:.3e}; bitwise equal: '
                      f'{bitwise}')
                if not bitwise:
                    raise AssertionError(f'kde_cdf {tag} {erf} M={m} '
                                         'disagrees with its plain version')
                if dt == torch.float32:
                    err32 = max(err32, e, e1)
    # the float32 kernel against the float64 plain version: what the
    # float32 terms and group sums cost in accuracy
    for erf in ('exact', 'as'):
        e = (outs[torch.float32, erf][0].double()
             - outs[torch.float64, erf][1]).abs().max().item()
        print(f'  kde_cdf float32 kernel vs float64 plain, {erf}: max abs err '
              f'{e:.3e} (gate {KDE_F32_TOL:g})')
        if not e <= KDE_F32_TOL:
            raise AssertionError(f'kde_cdf float32 {erf} is off the float64 '
                                 'plain version')
    x, data, w, hd = _kde_inputs(torch, draws, torch.float32)
    N = data.shape[1]
    ms, _ = _time_ms(torch, lambda: tk.kde_cdf_batch(x, data, w, hd), 10)
    plain_ms, _ = _time_ms(torch, lambda: tk.kde_cdf_batch_plain(
        x, data, w, hd), 2)
    lib_ms, _ = _time_ms(torch, lambda: _kde_library(torch, x, data, w, hd),
                         2)
    bound = _bound(KDE_OPS_PER_PHI * D * KDE_M * N,
                   _nbytes(x, data, w, hd) + D * KDE_M * 4)
    print(f'  kde_cdf float32 exact at D={D}, M={KDE_M}, N={N}: kernel '
          f'{ms:.3f} ms, plain {plain_ms:.3f} ms, blocked ndtr + matmul '
          f'{lib_ms:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]})')
    return err32, (ms, plain_ms) + bound + (lib_ms,)


def _make_des_model(seed=0):
    """The DES-like true model and its data, as
    ``examples/des_like_pipeline.py:_make_model`` builds them: a 457-dim
    data vector, linear in 27 parameters plus a quadratic response in the
    first 9, and the data at 0.1 in every parameter. Also returns the
    model's Jacobian at the truth."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(DES_N_DATA, DES_D)) / np.sqrt(DES_D)
    B = rng.normal(size=(DES_N_DATA, 9, 9)) / 18.0
    B = (B + np.swapaxes(B, 1, 2)) / 2

    def forward(x, *args, **kwargs):
        """The 'expensive' external model (host-only numpy)."""
        x = np.asarray(x)
        quad = np.einsum('dij,i,j->d', B, x[DES_NONLINEAR], x[DES_NONLINEAR])
        return A @ x + quad

    truth = np.full(DES_D, DES_TRUTH)
    data = forward(truth)
    jac = A.copy()
    jac[:, DES_NONLINEAR] += 2 * np.einsum('dij,j->di', B,
                                           truth[DES_NONLINEAR])
    return forward, data, jac


def _des_surrogate(cubic, scales=None):
    """The sample steps' PolyModel: linear in every parameter plus
    quadratic in the nine nonlinear ones ([10]), or plus quadratic, cubic-2
    and cubic-3 there, the reference's 'cubic-3' order on them ([13]: 28 +
    45 + 81 + 84 = 238 features); ``scales`` its own input_scales."""
    from bayesfast_tpu_torch.modules import PolyConfig, PolyModel
    orders = ('quadratic', 'cubic-2', 'cubic-3') if cubic else (
        'quadratic',)
    return PolyModel([PolyConfig('linear')] + [
        PolyConfig(o, input_mask=DES_NONLINEAR) for o in orders],
        input_size=DES_D, output_size=DES_N_DATA, input_vars='x',
        output_vars='m', input_scales=scales)


def _des_recipe_objects(bt, cubic=False):
    """The example's Density, surrogates and steps at DES_CHAINS chains;
    with ``cubic`` both sample steps fit the cubic surrogate."""
    from bayesfast_tpu_torch.modules import Gaussian, PolyModel
    forward, data, jac = _make_des_model()
    para_range = np.stack([np.full(DES_D, -5.0), np.full(DES_D, 5.0)]).T
    model = bt.Module(fun=forward, input_vars='x', output_vars='m',
                      input_shapes=[DES_D], output_shapes=[DES_N_DATA],
                      traceable=False)
    like = Gaussian(mean=data, cov=np.full(DES_N_DATA, 0.05),
                    input_vars='m', output_vars='logp')
    density = bt.Density(density_name='logp', module_list=[model, like],
                         input_vars='x', input_shapes=[DES_D],
                         input_scales=para_range, hard_bounds=True,
                         decay_options={'use_decay': True})
    surro_0 = PolyModel('linear', input_size=DES_D, output_size=DES_N_DATA,
                        input_vars='x', output_vars='m')
    surro_1 = _des_surrogate(cubic)
    tr = [dict(n_chain=DES_CHAINS, **t) for t in DES_TRACES]
    opt = bt.recipe.OptimizeStep(surrogate_list=surro_0, alpha_n=2,
                                 sample_trace=dict(tr[0]))
    sam = [bt.recipe.SampleStep(surrogate_list=surro_1, alpha_n=2,
                                reuse_samples=1, sample_trace=dict(t))
           for t in tr]
    post = bt.recipe.PostStep(n_is=DES_N_IS, k_trunc=0.25)
    rec = bt.Recipe(density=density, optimize=opt, sample=sam, post=post)
    # the analytic posterior covariance at the truth, (J' S^-1 J)^-1
    sigma = np.sqrt(np.diag(np.linalg.inv(jac.T @ jac / 0.05)))
    return rec, sigma


def _run_recipe(torch, rec, per_call=lambda out: ()):
    """``rec.run()`` instrumented, for [10], [13] and [15]: the wall of each
    phase (optimize, sample, post) and part (true model, fits, Laplace,
    sample(), IS); each sample() call's seconds, launches, tree-loop
    transitions, end time and ``per_call(its TraceTuple)``; the chunk
    calls' host seconds (``ChainDriver.run_warmup_chunk`` and
    ``run_frozen_chunk``, each to a synchronized card) and the kernels'
    device time by launch kind and K (CUDA events around each launch, read
    once the run is over: recording them does not wait on the card); the
    generated units the run built. The device time is the C launch calls'
    (``_CallEvents``), without the wrappers' host work. Every launch count
    and the tree-loop
    count are set to 0 just before the run and read just after. Returns a
    dict of them."""
    from bayesfast_tpu_torch import _build
    from bayesfast_tpu_torch.core import recipe as rmod
    from bayesfast_tpu_torch.samplers import nuts as tree
    from bayesfast_tpu_torch.samplers.chain import ChainDriver
    counters = _counters()
    calls = []
    parts = dict(true_model_s=0.0, fit_s=0.0, laplace_s=0.0, sample_s=0.0,
                 is_s=0.0)
    sample = rmod.sample

    def timed_sample(density, sample_trace=None, **kw):
        before = {k: f.launches for k, f in counters.items()}
        tr0 = tree.nuts_transition_batched.transitions
        torch.cuda.synchronize()
        t0 = time.time()
        out = sample(density, sample_trace=sample_trace, verbose=False, **kw)
        torch.cuda.synchronize()
        t1 = time.time()
        parts['sample_s'] += t1 - t0
        calls.append((t1 - t0, {k: f.launches - before[k]
                                for k, f in counters.items()},
                      tree.nuts_transition_batched.transitions - tr0, t1)
                     + tuple(per_call(out)))
        return out

    wrapped_on = []

    def timed(obj, name, key, into):
        fn = getattr(obj, name)

        def wrapped(*a, **kw):
            t0 = time.time()
            out = fn(*a, **kw)
            into[key] += time.time() - t0
            return out
        setattr(obj, name, wrapped)
        wrapped_on.append((obj, name))

    phases = dict(optimize=0.0, sample=0.0, post=0.0)
    for name, key in (('_opt_step', 'optimize'), ('_sam_step', 'sample'),
                      ('_pos_step', 'post')):
        timed(rec, name, key, phases)
    for name, key in (('_eval_true', 'true_model_s'),
                      ('_laplace_pass', 'laplace_s'),
                      ('_true_logp', 'is_s')):
        timed(rec, name, key, parts)
    timed(rec.density, 'fit', 'fit_s', parts)
    host = {'chunk_calls': 0, 'chunk_host_s': 0.0}
    chunk_fns = {n: getattr(ChainDriver, n)
                 for n in ('run_warmup_chunk', 'run_frozen_chunk')}

    def host_timed(fn):
        def wrapped(self, *a, **kw):
            t0 = time.time()
            out = fn(self, *a, **kw)
            torch.cuda.synchronize()
            host['chunk_host_s'] += time.time() - t0
            host['chunk_calls'] += 1
            return out
        return wrapped

    call_events = _CallEvents(torch).__enter__()
    rmod.sample = timed_sample
    for n, fn in chunk_fns.items():
        setattr(ChainDriver, n, host_timed(fn))
    for f in counters.values():
        f.launches = 0
    tree.nuts_transition_batched.transitions = 0
    # (an A/B's parent checkout may predate the record)
    builds = getattr(_build, 'traced_builds', {})
    built = set(builds)
    t0 = time.time()
    try:
        rec.run()
    finally:
        run_s = time.time() - t0
        rmod.sample = sample
        call_events.__exit__()
        for n, fn in chunk_fns.items():
            setattr(ChainDriver, n, fn)
        # the objects' own methods again (a copy of the density must fit
        # its own surrogates)
        for obj, name in wrapped_on:
            delattr(obj, name)
    torch.cuda.synchronize()
    # the launch mix: (kind, K) -> launches, device ms
    mix = {}
    for kind, k, e0, e1 in call_events.events:
        n, ms = mix.get((kind, k), (0, 0.0))
        mix[kind, k] = (n + 1, ms + e0.elapsed_time(e1))
    parts['kernels_s'] = sum(ms for _, ms in mix.values()) / 1e3
    return dict(run_s=run_s, start=t0, phases=phases, parts=parts,
                calls=calls, mix=mix, host=host,
                launches={k: f.launches for k, f in counters.items()},
                n_tree=tree.nuts_transition_batched.transitions,
                built={k: v for k, v in builds.items()
                       if k not in built})


def _mix_text(mix):
    return '; '.join(f'{kind} {k}: {n}, {ms / 1e3:.3f}, {ms / (n * k):.3f}'
                     for (kind, k), (n, ms) in sorted(mix.items()))


def _des_recipe(torch, bt, cubic=False):
    """[10] The DES-like Recipe (optimize, two sample steps, IS) at full
    width with DES_CHAINS chains in float32 through ``Recipe.run``: every
    surrogate sample step on the NUTS chunk kernels with the compiled-in
    PolyModel -> Gaussian density; [13] with ``cubic``, the same with the
    cubic surrogate in both sample steps. Times each step and its parts,
    counts the launches of each sample() call, and checks n_call and the
    IS-weighted posterior means against the truth. Returns (the Recipe,
    the run's launch counts, its n_call, largest IS-weighted deviation in
    sigma and the chunk kernels' device seconds)."""
    tag = '[13]' if cubic else '[10]'
    bt.utils.set_generator(27)
    rec, sigma = _des_recipe_objects(bt, cubic)

    def per_call(out):
        # |draw mean - truth| / sigma, post-warmup tree depth and acceptance
        st = out.trace._stats_arrays
        n_w = out.trace.n_warmup
        return (np.abs(out.get().mean(0) - DES_TRUTH) / sigma,
                float(st['tree_depth'][:, n_w:].mean()),
                float(st['mean_tree_accept'][:, n_w:].mean()))

    run = _run_recipe(torch, rec, per_call)
    phases, parts, calls, mix = (run['phases'], run['parts'], run['calls'],
                                 run['mix'])
    launches, n_tree = run['launches'], run['n_tree']
    res = rec.get()
    w = res.weights_trunc
    mean = np.sum(res.samples * w[:, None], axis=0) / np.sum(w)
    z = np.abs(mean - DES_TRUTH) / sigma
    # the last step's own draws, unweighted, and the weights' spread
    x_q = rec.recipe_trace.results.sample[-1].samples
    z_q = np.abs(x_q.mean(0) - DES_TRUTH) / sigma
    ess = np.sum(res.weights) ** 2 / np.sum(res.weights ** 2)
    n_cut = int(np.sum(res.weights_trunc < res.weights))
    print(f'{tag} DES-like Recipe, D={DES_D}, N_DATA={DES_N_DATA}, '
          f'{DES_CHAINS} chains, float32, '
          f'{"cubic" if cubic else "quadratic"} surrogate, Recipe.run(): ' +
          ', '.join(f'{k} {v:.2f} s' for k, v in phases.items()))
    print(f'    parts (s): ' + ', '.join(f'{k} {v:.3f}'
                                        for k, v in parts.items()))
    if cubic:
        print('    the true model is quadratic in the nine parameters, so the '
              'cubic terms fit to about 0 and no input_scales are set: '
              '[13b] runs non-zero cubic coefficients and the scales')
    for i, (dt, ln, nt, _, zs, depth, acc) in enumerate(calls):
        step = 'optimize' if i == 0 else f'sample #{i - 1}'
        print(f'    {step}: sample() {dt:.2f} s, launches '
              f'{ {k: v for k, v in ln.items() if v} }, tree-loop '
              f'transitions {nt}; post-warmup tree depth {depth:.3f}, '
              f'accept {acc:.3f}, |draw mean - {DES_TRUTH}| max '
              f'{zs.max():.3f} sigma')
    print('    chunk launches (kind, K: launches, device s, ms a '
          'transition): ' + _mix_text(mix))
    print(f'    n_call {res.n_call} ([10]: JAX package record '
          f'{DES_JAX_NCALL}, reference {DES_REF_NCALL}); tree-loop '
          f'transitions {n_tree}')
    print(f'    IS-weighted posterior means - {DES_TRUTH}, in analytic sigma:'
          f' max {z.max():.3f} (JAX record < 0.5), mean {z.mean():.3f}; '
          f'sigma {sigma.min():.4f}-{sigma.max():.4f}')
    print('    ' + ' '.join(f'{v:.3f}' for v in mean))
    print(f'    the last step\'s {x_q.shape[0]} draws, unweighted: max '
          f'{z_q.max():.3f} sigma, mean {z_q.mean():.3f}; IS weights: ESS '
          f'{ess:.1f} of {res.weights.size}, max / mean '
          f'{res.weights.max() / res.weights.mean():.3f}, {n_cut} truncated')
    if not (len(calls) == 1 + len(DES_TRACES) and all(
            ln['nuts_warmup'] > 0 and ln['nuts_multi'] > 0
            and ln['nuts_block'] == 0 and nt == 0
            for _, ln, nt, *_ in calls)):
        raise AssertionError(f'{tag}: a Recipe sample step did not run '
                             'every transition on the chunk kernels')
    if not (np.isfinite(mean).all() and z.max() < 1.0):
        raise AssertionError(f'{tag}: posterior means off: {z.max()} sigma')
    if not (res.n_call is not None and res.n_call <= DES_REF_NCALL):
        raise AssertionError(f'{tag}: n_call {res.n_call} > '
                             f'{DES_REF_NCALL}')
    return rec, launches, dict(n_call=int(res.n_call),
                               max_dev_sigma=float(z.max()),
                               kernels_s=parts['kernels_s'])


def _full_cov_density(den):
    """A copy of the Recipe's density whose likelihood has a full
    covariance, 0.05 I plus a random SPD part (seeded): the PolyGaussian
    kernels then take the precision-matvec branch."""
    import copy
    den = copy.deepcopy(den)
    L = np.random.default_rng(10).normal(size=(DES_N_DATA, DES_N_DATA))
    den.module_list[1].cov = (0.05 * np.eye(DES_N_DATA)
                              + L @ L.T / DES_N_DATA ** 2)
    return den


def _poly_leapfrog_ops(dim, spec):
    """Operations of one leapfrog of the PolyGaussian density behind the
    fused bound transform, read off csrc/nuts.cu and counted from the spec:
    F M multiply-adds forward and F M back (4 F M), a butterfly per feature
    (10 F), the third factor of each feature whose triple has one (i3 < D),
    the likelihood per output (8 M), the sparse rows of the gradient (a
    product and an add an entry, 2 NNZ, and the partners' product where
    both partners are inputs), the bound's and the decay's D x D matvecs
    (4 D^2), about 85 elementwise operations per dimension (transform,
    integrator, energy and U-turn sums), and with input scales their
    subtract and two divides per dimension. Without cubic features and
    scales this is the two-index density's count."""
    M, F, NNZ = (int(v) for v in spec['scalars'][2:5])
    trip, rows = spec['index']['trip'], spec['index']['rows']
    n_third = int((trip[2] < dim).sum())
    n_pair = int(((rows[0] < F) & (rows[1] < dim) & (rows[2] < dim)).sum())
    a = spec['arrays']
    scaled = bool((a['slo'] != 0).any() or (a['sdiff'] != 1).any())
    return (4 * F * M + 10 * F + n_third + 8 * M + 2 * NNZ + n_pair
            + 4 * dim * dim + 85 * dim + 3 * dim * scaled)


def _chunks_vs_plain(torch, den, carry, dtype, name, suffix, label='',
                     block=False, warmup=True, k=K_CMP, depth=MAX_TREEDEPTH):
    """Both chunk kernels (the frozen one alone without ``warmup``; with
    ``block`` one block launch too) with the density ``den`` (``name`` in
    the printed lines) against their plain versions at K = 2 (``k``) on a
    path's final state cast to ``dtype``: [10b]'s PolyGaussian, [12]'s
    anchors, [14]'s traced densities, [16]'s and [17a]'s wide ones (at
    ``depth``, the trees' depth limit). Returns the max abs errors and the
    plain versions' ms (each the one call compared), keyed by kernel +
    suffix."""
    from bayesfast_tpu_torch.samplers import nuts_cuda as nc
    from bayesfast_tpu_torch.samplers.metrics import init_diag_metric
    from bayesfast_tpu_torch.samplers.step_size import init_step_size
    q = carry.q.to(dtype).contiguous()
    C, dim = q.shape
    var = nc._mat(carry.metric.var, C, dim, q)
    eps = torch.exp(carry.step.log_bar).to(dtype)
    plain_lpg = nc.plain_lpg(den)
    seed, i0 = 20240601, 37
    tag = label + str(dtype).replace('torch.', '')
    metric = init_diag_metric(q, var)
    errs, plain_ms = {}, {}
    ker = _as_dict(*nc.nuts_chunk_batched(seed, q, metric, eps, k, depth,
                                          MAX_CHANGE, density=den, i0=i0))
    ms, o = _plain_once(torch, lambda: nc.nuts_chunk_plain(
        seed, q, var, eps, k, depth, MAX_CHANGE, plain_lpg, i0))
    ref = _as_dict(o['q'], o['q_final'], nc._chunk_stats(o, dtype))
    print(f'  {name} frozen {tag}: mean tree depth '
          f'{ref["tree_depth"].float().mean().item():.3f}, divergent '
          f'{ref["diverging"].float().mean().item():.4f}')
    errs['nuts_multi' + suffix] = _compare(f'nuts_multi {name} {tag}', ker,
                                           ref, C)
    plain_ms['nuts_multi' + suffix] = ms
    if warmup:
        wsched, _ = nc._window_schedule(4, 0, 5, k, 1, True)
        step = init_step_size(eps)
        args = (k, depth, MAX_CHANGE, 0.8, 0.05, 0.75, 10., True, True,
                wsched)
        ker = nc.nuts_warmup_chunk_batched(seed, q, step, metric, *args,
                                           density=den, i0=i0)
        steps, mets = nc._warmup_leaves(q, step, metric)
        ms, ref = _plain_once(torch, lambda: nc.nuts_warmup_chunk_plain(
            seed, q, steps, mets, *args, plain_lpg, i0))
        errs['nuts_warmup' + suffix] = _compare(
            f'nuts_warmup {name} {tag}', ker, ref, C)
        plain_ms['nuts_warmup' + suffix] = ms
    if block:
        def rows(q_new, stats):
            d = dict(stats._asdict(), q=q_new)
            d['diverging'] = d['diverging'].int()
            return d

        ker = rows(*nc.nuts_transition_batched(
            seed, q, metric, eps, depth, MAX_CHANGE, density=den))
        ms, o = _plain_once(torch, lambda: nc.nuts_block_plain(
            seed, q, var, eps, depth, MAX_CHANGE, plain_lpg))
        errs['nuts_block' + suffix] = _compare(
            f'nuts_block {name} {tag}', ker,
            rows(o['q'], nc._chunk_stats(o, dtype)), C)
        plain_ms['nuts_block' + suffix] = ms
    return errs, plain_ms


def _cubic_density(bt, rec, scaled):
    """[13b] A copy of [13]'s density with a fresh cubic surrogate, fitted
    to the true model plus a seeded cubic term in the nine nonlinear
    parameters (so that every cubic coefficient is non-zero) at CUBIC_FIT
    of the last step's draws, evenly strided; with ``scaled`` the
    surrogate has its own input_scales, the box of the fit points."""
    import copy
    x = rec.recipe_trace.results.sample[-1].samples
    x = x[::x.shape[0] // CUBIC_FIT][:CUBIC_FIT]
    T3 = np.random.default_rng(13).normal(
        size=(DES_N_DATA,) + (DES_NONLINEAR.size,) * 3) / 27.0
    scales = np.stack([x.min(0), x.max(0)]).T if scaled else None
    den = copy.deepcopy(rec.density)
    den.surrogate_list = [_des_surrogate(True, scales)]
    vds = den.fun(x, original_space=True, use_surrogate=False)
    for vd, xi in zip(vds, x):
        xn = xi[DES_NONLINEAR]
        vd._fun['m'] = vd._fun['m'] + np.einsum('dijk,i,j,k->d', T3, xn, xn,
                                                 xn)
    den.fit(vds)
    den.use_surrogate = True
    return den


def _cubic_kernels(torch, bt, rec):
    """[13b] The frozen chunk, warmup chunk and block kernels with the cubic
    PolyGaussian density (F = 238 features, M = 457 outputs) against their
    plain versions at C = DES_CHAINS, K = 2, on [13]'s last sample step's
    state, float64 and float32, without and with the surrogate's own input
    scales (on its first TRACED_CHAINS chains); each dtype's shared-memory
    plan printed; the unscaled density's K = 2 chunks and one block launch
    timed in both dtypes, and its chunks
    under the other tile widths (``_stream_plans``). Returns (max abs
    errors by kernel, {dtype: times by kernel + '_cubic'})."""
    from bayesfast_tpu_torch.samplers import nuts_cuda as nc
    from bayesfast_tpu_torch.samplers.metrics import init_diag_metric
    carry = rec.recipe_trace.results.sample[-1].sample_trace.trace._carry
    errs, times = {}, {}
    for scaled in (False, True):
        den = _cubic_density(bt, rec, scaled)
        spec = nc._spec_entry(den, carry.q)[2]
        a = [c._a for c in den.surrogate_list[0].configs]
        print(f'  cubic surrogate{" with input_scales" if scaled else ""}: '
              f'F = {int(spec["scalars"][3])}, NNZ = '
              f'{int(spec["scalars"][4])}; non-zero coefficients: cubic-2 '
              f'{np.count_nonzero(a[2])} of {a[2].size}, cubic-3 '
              f'{np.count_nonzero(a[3])} of {a[3].size}')
        if not (np.count_nonzero(a[2]) and np.count_nonzero(a[3])):
            raise AssertionError('[13b]: the cubic coefficients are zero')
        ops = _poly_leapfrog_ops(DES_D, spec)
        print(f'  bound: {ops} operations a leapfrog (_poly_leapfrog_ops)')
        for dt, peak in ((torch.float64, PEAK_FP64),
                         (torch.float32, PEAK_FP32)):
            c = _cast(carry, dt)
            dens_id, _, _, _, dscal = nc._spec_for(den, c.q)
            plan = nc._spec_plan(dens_id, dscal, DES_D, MAX_TREEDEPTH,
                                 c.q.element_size())
            print(f'  plan {str(dt)[6:]}: '
                  f'{_plan_text(plan, dscal, c.q.element_size())}')
            # the scaled density on the first TRACED_CHAINS chains: it is
            # held, not timed
            e, plain_ms = _chunks_vs_plain(
                torch, den, _first_chains(c, TRACED_CHAINS) if scaled else c,
                dt, 'cubic PolyGaussian', '_cubic',
                label='scaled ' if scaled else '', block=True)
            for k, v in e.items():
                errs[k] = max(errs.get(k, 0.0), v)
            if scaled:
                continue
            t, _, _ = _time_chunks(torch, den, c, plain_ms, ops, '_cubic',
                                   peak)
            C, dim = c.q.shape
            metric = init_diag_metric(c.q, nc._mat(c.metric.var, C, dim,
                                                   c.q))
            t['nuts_block_cubic'] = _time_block(
                torch, den, c.q, metric, torch.exp(c.step.log_bar),
                plain_ms['nuts_block_cubic'], ops, peak,
                '  nuts_block_cubic')[0]
            times[dt] = t
            _stream_plans(torch, den, c, ops)
    return errs, times


def _plan_text(plan, dscal, itemsize, dim=None):
    """A PolyGaussian launch's shared-memory plan (``poly_smem_plan``) in
    words, with the L2 bytes a block reads per leapfrog for the features
    it does not stage (``_l2_bytes``); past D = 64 (``dim``, the plan's
    ``block``: PolyBlock) also the shared-memory bytes of WT and the
    Hessians' L2 bytes a block and leapfrog (``_block_bytes``), beside
    what a warp a chain read (PolyGaussian's design at NE <= 2)."""
    F = int(dscal[3])
    reads = 'the block reads them' if plan.get('block') else \
        'each chain reads them'
    path = (f'streamed tiles of {plan["tile"]} features '
            f'({plan["tile_bytes"]} bytes a buffer)' if plan.get('stream')
            else reads if plan['rows'] < F else 'all staged')
    text = (f'{plan["rows"]} of {F} features staged, {path}; stacks in '
            f'shared memory: {plan["stacks_smem"]}; {plan["bytes"]} bytes a '
            f'block; {_l2_bytes(plan, dscal, itemsize)} L2 bytes of WT a '
            f'leapfrog and block')
    if plan.get('block') and dim is not None:
        b = _block_bytes(plan, dscal, itemsize, dim)
        text += (f'; block-wide: WT read from shared memory {b["wt_smem"]} '
                 f'B a leapfrog and block (a warp a chain: '
                 f'{b["wt_smem_per_chain"]}), the Hessians from L2 '
                 f'{b["hess_l2"]} B ({b["hess_l2_per_chain"]})')
    return text


def _l2_bytes(plan, dscal, itemsize):
    """Bytes a block reads from L2 per leapfrog (all its chains on one) for
    the features of WT that its plan does not stage: on the streamed path
    the tiles' copies (a tick's forward pass copies tiles 2 .. NT - 1, its
    back pass NT - 3 .. 0: each starts on the two tiles the last pass ended
    on); else each of the 8 chains reads every such feature's M
    coefficients twice, forward and back, or, the block together past D =
    64 (PolyBlock), once forward and once a group of chains back
    (``_block_bytes``)."""
    M, F = int(dscal[2]), int(dscal[3])
    if plan.get('stream'):
        n_tiles = -(-(F - plan['rows']) // plan['tile'])
        return 2 * max(n_tiles - 2, 0) * plan['tile_bytes']
    reads = 1 + _block_groups(itemsize) if plan.get('block') else 2 * 8
    return reads * (F - plan['rows']) * M * itemsize


def _block_groups(itemsize):
    """The back pass's chain groups a block of 8 chains at work
    (``csrc/nuts_poly.cuh::PolyBlock::kCB``: 4 chains a group in float32,
    2 in float64)."""
    return 8 // (4 if itemsize == 4 else 2)


def _block_bytes(plan, dscal, itemsize, dim):
    """PolyBlock's reads a block and leapfrog with its 8 chains at work,
    from its plan: WT from shared memory (the forward pass reads each
    staged and streamed feature's row vectors once; the back pass reads
    each group of 8 once for each group of chains, `_block_groups`), and
    the two Hessians from L2 (each value once, or once for each half of
    the chains where two threads a output fit the block, NE <= 4:
    ``PolyBlock::hess``); beside PolyGaussian's, where each of the 8 warps
    read WT forward and back and both Hessians itself."""
    M, F = int(dscal[2]), int(dscal[3])
    n, rows = 16 // itemsize, plan['rows']
    staged = -(-rows // n) * n
    streamed = (-(-(F - rows) // plan['tile']) * plan['tile']
                if plan.get('stream') else 0)
    back = -(-staged // 8) * 8 + streamed
    row = M * itemsize
    P = 32 * -(-dim // 32)
    hess = 2 * dim * dim * itemsize
    return dict(wt_smem=row * (staged + streamed
                               + _block_groups(itemsize) * back),
                wt_smem_per_chain=8 * row * (staged + streamed + back),
                hess_l2=(2 if 2 * P <= 256 else 1) * hess,
                hess_l2_per_chain=8 * hess)


def _stream_plans(torch, den, carry, ops):
    """[13b] The cubic density's K = 2 chunks on ``carry`` under the
    streamed path's other tile widths, and under the path that reads the
    unstaged features in each chain (tile 0, the parent's), timed beside
    the plan's and held bitwise to its outputs: the measurement that
    chooses ``nuts_cuda._TILE``. Each also on one block alone (the first
    8 chains): a slowest chain as slow alone as beside the chip's other
    blocks waits on latency, not on a shared rate."""
    from bayesfast_tpu_torch.samplers import nuts_cuda as nc
    plan_fn = nc._spec_plan
    itemsize = carry.q.element_size()
    tiles = (0, 8, 16, 32) if itemsize == 4 else (0, 8, 16)
    first = None
    try:
        for tile in tiles:
            def plan_of(dens_id, sc, dim, depth, isz, tile=tile):
                return nc.poly_smem_plan(dim, *(int(v) for v in sc[2:5]),
                                         bool(sc[9]), depth, isz, tile)
            nc._spec_plan = plan_of
            dscal = nc._spec_for(den, carry.q)[4]
            plan = plan_of(None, dscal, DES_D, MAX_TREEDEPTH, itemsize)
            tag = f'{str(carry.q.dtype)[6:]} tile {tile}'
            print(f'  plan {tag}: {_plan_text(plan, dscal, itemsize)}')
            _, _, outs = _time_chunks(torch, den, carry, ops=ops,
                                      suffix=f'_cubic {tag}')
            _time_chunks(torch, den, _first_chains(carry, 8), ops=ops,
                         suffix=f'_cubic {tag}, one block')
            first = first or outs
            same = all(all(torch.equal(a, b) for a, b in zip(
                _tensors(outs[k]), _tensors(first[k]))) for k in outs)
            print(f'  {tag}: outputs bitwise equal to tile {tiles[0]}\'s: '
                  f'{same}')
            if not same:
                raise AssertionError(f'the {tag} plan changes the draws')
    finally:
        nc._spec_plan = plan_fn


def _anchor_run(torch, bt, name, jax_ncall):
    """[12] One GBS anchor through its twin's ``main()``
    (``bayesfast_tpu_torch/examples/{name}_gbs.py``: the JAX example's
    configuration and seed, float64), every launch count set to 0 just
    before and read just after. Times the warmup and post-warmup chunk
    calls (host clock around ``ChainDriver``'s, the card synchronized),
    their launches on the device alone (``_CallEvents``) and the Recipe's
    sample and post (GBS) steps; prints the launches, the tree-loop
    transitions, it/s, ESS/s, rhat, n_call, logz against the fiducial and
    GBS's profile. Gates: every transition on the chunk kernels (0 block
    launches and tree-loop transitions), KDE launches, rhat_max <
    ANCHOR_RHAT, |logz - fiducial| <= ANCHOR_SIGMAS errors. Returns
    (density, the trace's final carry, the launch counts, the readings:
    n_call, logz, rhat_max, the draws' digest, the chunk kernels' device
    and the chunk calls' host seconds)."""
    import importlib
    from bayesfast_tpu_torch.samplers import chain as chain_mod
    from bayesfast_tpu_torch.samplers import nuts as tree
    from bayesfast_tpu_torch.utils.acor import effective_sample_size, rhat
    mod = importlib.import_module(f'bayesfast_tpu_torch.examples.{name}_gbs')
    secs = dict(warmup=0.0, post=0.0, sample=0.0, gbs=0.0)
    patches = ((chain_mod.ChainDriver, 'run_warmup_chunk', 'warmup'),
               (chain_mod.ChainDriver, 'run_frozen_chunk', 'post'),
               (bt.Recipe, '_sam_step', 'sample'),
               (bt.Recipe, '_pos_step', 'gbs'))
    originals = [getattr(cls, attr) for cls, attr, _ in patches]

    def timed(fn, key):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            secs[key] += time.time() - t0
            return out
        return wrapped

    for (cls, attr, key), fn in zip(patches, originals):
        setattr(cls, attr, timed(fn, key))
    for f in _counters().values():
        f.launches = 0
    tree.nuts_transition_batched.transitions = 0
    try:
        t0 = time.time()
        with _CallEvents(torch) as ev:
            rec = mod.main()
        wall = time.time() - t0
    finally:
        for (cls, attr, _), fn in zip(patches, originals):
            setattr(cls, attr, fn)
    launches = {k: f.launches for k, f in _counters().items()}
    torch.cuda.synchronize()
    dev_s = {k: sum(e0.elapsed_time(e1) for kind, _, e0, e1 in ev.events
                    if kind == k) / 1e3 for k in ('warmup', 'frozen')}
    n_tree = tree.nuts_transition_batched.transitions
    res = rec.get()
    tt = rec.recipe_trace.results.sample[-1].sample_trace
    s = tt.get(flatten=False)
    C, n_post, dim = s.shape
    n_warm = tt.trace.n_warmup
    st = {k: np.asarray(v[:, n_warm:], np.float64)
          for k, v in tt.trace._stats_arrays.items()}
    ess = float(np.sum(effective_sample_size(s)) / dim)
    r_max = float(np.max(rhat(s)))
    gbs = rec.recipe_trace._s_post.evidence_method
    prof = {k: round(v, 3) for k, v in gbs.last_profile.items()}
    fit = {k: round(v, 3) for k, v in gbs.sit.last_profile.items()}
    off = abs(res.logz - mod.FIDUCIAL)
    print(f'[12] {name}-{dim}: {C} chains, {n_warm} + {n_post} iterations, '
          f'float64, Recipe.run() {wall:.2f} s (sample step '
          f'{secs["sample"]:.2f} s, post {secs["gbs"]:.2f} s)')
    print(f'    launches {launches}; tree-loop transitions {n_tree}')
    print(f'    chunk kernels on the device: warmup {dev_s["warmup"]:.4f} s '
          f'({launches["nuts_warmup"]} launches), frozen '
          f'{dev_s["frozen"]:.4f} s ({launches["nuts_multi"]}); the chunk '
          f'calls on the host: warmup {secs["warmup"]:.4f} s, post '
          f'{secs["post"]:.4f} s')
    print(f'    chunk calls: warmup {C * n_warm / secs["warmup"]:.1f} it/s '
          f'({secs["warmup"]:.2f} s), post {C * n_post / secs["post"]:.1f} '
          f'it/s ({secs["post"]:.2f} s), ESS/s {ess / secs["post"]:.1f}; '
          f'the sample step (start-up and copies too) '
          f'{C * (n_warm + n_post) / secs["sample"]:.1f} it/s, ESS/s '
          f'{ess / secs["sample"]:.1f}; ESS {ess:.1f} a dimension, rhat_max '
          f'{r_max:.4f} (gate {ANCHOR_RHAT})')
    print(f'    post-warmup: tree size mean {st["tree_size"].mean():.2f}, '
          f'max {int(st["tree_size"].max())}; depth mean '
          f'{st["tree_depth"].mean():.3f}; accept '
          f'{st["mean_tree_accept"].mean():.4f}; divergent '
          f'{st["diverging"].mean():.5f}')
    print(f'    n_call {res.n_call} (JAX package: {jax_ncall})')
    print(f'    logz {res.logz:.4f} +- {res.logz_err:.4f}, fiducial '
          f'{mod.FIDUCIAL}: off by {off:.4f} = {off / res.logz_err:.2f} '
          f'errors (gate {ANCHOR_SIGMAS})')
    print(f'    GBS {secs["gbs"]:.2f} s on {C // 2} x {n_post} fit rows, '
          f'{gbs.sit.i_iter} SIT layers: {prof}')
    print(f'    SIT fit stages (s): {fit}')
    n_expect = (int(os.environ.get('N_CHAIN', 64)),
                int(os.environ.get('N_ITER', 2500))
                - int(os.environ.get('N_WARMUP', 1000)), dim)
    if not (np.isfinite(s).all() and s.shape == n_expect):
        raise AssertionError(f'[12] {name}: non-finite or misshapen draws')
    if not (launches['nuts_warmup'] > 0 and launches['nuts_multi'] > 0
            and launches['nuts_block'] == 0 and n_tree == 0):
        raise AssertionError(f'[12] {name}: a transition left the chunk '
                             'kernels')
    if launches['kde_cdf'] == 0:
        raise AssertionError(f'[12] {name}: the SIT fit did not launch the '
                             'KDE kernel')
    if not r_max < ANCHOR_RHAT:
        raise AssertionError(f'[12] {name}: rhat_max {r_max}')
    if not (np.isfinite(res.logz) and off <= ANCHOR_SIGMAS * res.logz_err):
        raise AssertionError(f'[12] {name}: logz {res.logz} +- '
                             f'{res.logz_err}, fiducial {mod.FIDUCIAL}')
    _anchor_kde(torch, s)
    readings = {'n_call': res.n_call, 'logz': float(res.logz),
                'rhat_max': r_max, 'draws': _digest(s),
                'kernels_s': dev_s['warmup'] + dev_s['frozen'],
                'warmup_kernels_s': dev_s['warmup'],
                'frozen_kernels_s': dev_s['frozen'],
                'warmup_host_s': secs['warmup'], 'post_host_s': secs['post']}
    return rec.density, tt.trace._carry, launches, readings


def _anchor_kde(torch, draws):
    """[12] The KDE kernel at an anchor's SIT fit shape (its fit rows, D
    columns, 512 queries a column), float64 as GBS runs it: bitwise
    against its plain version, then timed beside its bound and the blocked
    ndtr + matmul formulation."""
    from bayesfast_tpu_torch.ops import kde as tk
    x, data, w, h = _kde_inputs(torch, draws, torch.float64)
    dim, N = data.shape
    k = tk.kde_cdf_batch(x, data, w, h)
    plain_ms, p = _plain_once(torch, lambda: tk.kde_cdf_batch_plain(
        x, data, w, h))
    ms = _time_ms(torch, lambda: tk.kde_cdf_batch(x, data, w, h), 10)[0]
    lib_ms = _time_ms(torch, lambda: _kde_library(torch, x, data, w, h),
                      2)[0]
    bound = _bound(KDE_OPS_PER_PHI * dim * KDE_M * N,
                   _nbytes(x, data, w, h, k), PEAK_FP64)
    same = torch.equal(k, p)
    print(f'    kde_cdf float64 at D={dim}, M={KDE_M}, N={N}: kernel '
          f'{ms:.3f} ms, plain {plain_ms:.3f} ms, blocked ndtr + matmul '
          f'{lib_ms:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]}); bitwise '
          f'equal to the plain version: {same}')
    if not same:
        raise AssertionError(f'kde_cdf at D={dim} disagrees with its plain '
                             'version')


def _anchor_kernels(torch, name, den, carry):
    """[12] The chunk and block kernels with an anchor density against
    their plain versions (bitwise), then timed, at K = 2 on the anchor's
    final state, float64 then float32. Returns {dtype: (max abs errors,
    times)}, keyed by kernel + '_' + name."""
    from bayesfast_tpu_torch.samplers import nuts_cuda as nc
    from bayesfast_tpu_torch.samplers.metrics import init_diag_metric
    ops = _anchor_leapfrog_ops(name, carry.q.shape[1])
    out = {}
    for dt, peak in ((torch.float64, PEAK_FP64), (torch.float32, PEAK_FP32)):
        c = _cast(carry, dt)
        errs, plain_ms = _chunks_vs_plain(
            torch, den, c, dt, name, f'_{name}', block=True,
            depth=ANCHOR_CHECK_DEPTH.get(name, MAX_TREEDEPTH))
        times = _time_chunks(torch, den, c, plain_ms, ops, f'_{name}',
                             peak)[0]
        key = f'nuts_block_{name}'
        C, dim = c.q.shape
        metric = init_diag_metric(c.q, nc._mat(c.metric.var, C, dim, c.q))
        times[key] = _time_block(torch, den, c.q, metric,
                                 torch.exp(c.step.log_bar), plain_ms[key],
                                 ops, peak, f'  {key}')[0]
        out[dt] = (errs, times)
    return out


def _anchor_partial_block(torch, den, carry):
    """[12] The cauchy's frozen chunk against its plain version (bitwise,
    float64, K = 2, depth ANCHOR_CHECK_DEPTH) at ANCHOR_WIDE_CHAINS chains,
    [12]'s final state tiled: two warps a block with the last block
    partial, where a launch of 64 chains has a block a chain."""
    n, depth = ANCHOR_WIDE_CHAINS, ANCHOR_CHECK_DEPTH['cauchy']
    c = _tiled_chains(carry, n)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    print(f'[12] cauchy frozen chunk vs plain, C={n} on {n_sm} SMs (two '
          f'warps a block on 132, the last block partial: '
          f'csrc/nuts_launch.cuh::launch_shape), K={K_CMP}, depth {depth}, '
          'float64')
    _chunks_vs_plain(torch, den, c, torch.float64, 'cauchy', '_cauchy',
                     label=f'C={n} ', warmup=False, depth=depth)


def _traced_sources(torch):
    """[2] The user densities of [14], each a ``DensityLite`` over a torch
    logp traced on the card, and the generated translation unit of each of
    TRACED_UNITS. Returns ({name: (density, info)}, {'name dtype':
    source})."""
    from bayesfast_tpu_torch.examples.user_densities import DENSITIES
    dens = {name: DENSITIES[name]() for name in dict(TRACED_UNITS)}
    srcs = {f'{name} {dt}': dens[name][0].kernel_spec()['program'].source(
        getattr(torch, dt)) for name, dt in TRACED_UNITS}
    return dens, srcs


def _user_grad_sources(torch):
    """[2] [18]'s densities (``examples/user_densities.py::
    bench_banana_user``: the two forms with the user's gradient and the
    external form), each traced on the card, and the generated unit of the
    first form's program in float32 and float64. Returns ({form: (density,
    info)}, {'user_grad dtype': source})."""
    from bayesfast_tpu_torch.examples.user_densities import bench_banana_user
    dens = {form: bench_banana_user(form)
            for form in USER_FORMS + ('external',)}
    prog = dens[USER_FORMS[0]][0].kernel_spec()['program']
    srcs = {f'user_grad {dt}': prog.source(getattr(torch, dt))
            for dt in ('float32', 'float64')}
    return dens, srcs


def _traced_leapfrog_ops(program):
    """Operations of one leapfrog with a traced density behind the fused
    bound transform: the program's own (``Program.n_ops``, its forward and
    adjoint nodes, 2 m n a matrix product) and about 70 a dimension for
    the transition's (the transform and its log-Jacobian, the integrator,
    the energy and U-turn sums; ``_anchor_leapfrog_ops``)."""
    return program.n_ops + 70 * program.D


def _traced(torch, bt, dens, rates3, anchor_carries, ptxas, builds,
            smi):
    """[14] A user's own torch density on the kernels: bench.py's banana-32
    written in torch (``examples/user_densities.py``) through ``sample``
    at [3]'s configuration under ``nuts_kernel='auto'``: every transition on
    the traced chunk kernels (0 tree-loop transitions), [3]'s gates, its
    rates beside [3]'s. Then the traced frozen and warmup chunks (K = 2)
    and a block launch held bitwise against the program's interpreter at
    TRACED_CHAINS chains of the path's final state, float32 and float64,
    and timed there and at the path's 1024 chains; the funnel, ring and
    cauchy user forms' frozen chunk (K = 2, float64) on [12]'s final
    states. Prints each instantiation's kernel ms, ns a leapfrog on the
    slowest chain, registers and spills (``ptxas``) and its nvcc seconds
    (``builds``, by label). Returns ({kernel row: (launches, max abs
    error, (ms, plain ms, bound ms, bound by))}, the path's rates)."""
    from bayesfast_tpu_torch import config
    from bayesfast_tpu_torch.samplers import nuts as tree
    from bayesfast_tpu_torch.samplers import nuts_cuda as nc
    from bayesfast_tpu_torch.samplers.metrics import init_diag_metric
    config.set_dtype(torch.float32)
    config.set_nuts_kernel('auto')
    den, info = dens['bench_banana']
    prog = den.kernel_spec()['program']
    print(f'[14] traced bench banana: {len(prog.nodes)} nodes '
          f'({prog.describe()}), {prog.n_ops} operations an evaluation, '
          f'{_traced_leapfrog_ops(prog)} a leapfrog')
    # a logp that did not trace would warn and take the tree loop: the
    # launch counts and the tree-loop transitions fail the phase then
    tree.nuts_transition_batched.transitions = 0
    tt, launches, rates = _sample_path(
        torch, bt, den, info['A'], "[14] main path, bench.py's banana "
        "written in torch, nuts_kernel='auto'",
        {'nuts_warmup': 1 + 4 * 2, 'nuts_multi': 3 * 2})
    n_tree = tree.nuts_transition_batched.transitions
    print(f'    tree-loop transitions {n_tree}; [3] compiled-in: warmup '
          f'{rates3["warmup_its"]:.1f} it/s, post {rates3["post_its"]:.1f} '
          f'it/s, ESS/s {rates3["ess_s"]:.1f}; traced / compiled-in: '
          f'warmup {rates["warmup_its"] / rates3["warmup_its"]:.3f}, post '
          f'{rates["post_its"] / rates3["post_its"]:.3f}')
    if n_tree != 0:
        raise AssertionError('[14] transitions ran on the tree loop')
    ops = _traced_leapfrog_ops(prog)
    rows, errs = {}, {}
    carry = _first_chains(tt.trace._carry, TRACED_CHAINS)
    for dt, peak in ((torch.float32, PEAK_FP32), (torch.float64, PEAK_FP64)):
        tag = str(dt)[6:]
        c = _cast(carry, dt)
        C, dim = c.q.shape
        e, plain_ms = _chunks_vs_plain(torch, den, c, dt, 'traced banana',
                                       '_traced', block=True)
        times = _time_chunks(torch, den, c, plain_ms, ops, '_traced', peak)[0]
        metric = init_diag_metric(c.q, nc._mat(c.metric.var, C, dim, c.q))
        times['nuts_block_traced'] = _time_block(
            torch, den, c.q, metric, torch.exp(c.step.log_bar),
            plain_ms['nuts_block_traced'], ops, peak,
            f'  nuts_block_traced {tag}')[0]
        if dt == torch.float32:
            f32_times = times
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
        label = f'bench_banana {tag}'
        print(f'  traced banana {tag}: kernels {_ptxas_text(ptxas, label)}; '
              f'built in {builds[label]}; {smi}')
    print(f'  the same at the path\'s {N_CHAIN} chains, then the compiled-in '
          f'banana of [3] (the same rotation, Q and bounds) on this state:')
    _time_chunks(torch, den, tt.trace._carry, None, ops, '_traced C=1024')
    _time_chunks(torch, _bench_density(torch.float32)[1], tt.trace._carry,
                 suffix='_compiled-in C=1024')
    for kind in ('nuts_multi', 'nuts_warmup', 'nuts_block'):
        k = f'{kind}_traced'
        rows[k] = (launches.get(kind, 0), errs[k], f32_times[k])
    for name, carry_a in anchor_carries.items():
        den_a = dens[name][0]
        prog_a = den_a.kernel_spec()['program']
        ops_a = _traced_leapfrog_ops(prog_a)
        c = _cast(carry_a, torch.float64)
        print(f'[14] traced {name} (the user form): {len(prog_a.nodes)} '
              f'nodes, {ops_a} operations a leapfrog; frozen K={K_CMP} at '
              f'C={c.q.shape[0]}, depth '
              f'{ANCHOR_CHECK_DEPTH.get(name, MAX_TREEDEPTH)}, float64')
        e, plain_ms = _chunks_vs_plain(
            torch, den_a, c, torch.float64, f'traced {name}',
            f'_traced_{name}', warmup=False,
            depth=ANCHOR_CHECK_DEPTH.get(name, MAX_TREEDEPTH))
        times = _time_chunks(torch, den_a, c, plain_ms, ops_a,
                             f'_traced_{name}', PEAK_FP64)[0]
        print(f'  traced {name} float64: kernels '
              f'{_ptxas_text(ptxas, name + " float64")}; built in '
              f'{builds[name + " float64"]}; {smi}')
        k = f'nuts_multi_traced_{name}'
        rows[k] = (0, e[k], times[k])
    return rows, rates


def _user_grad(torch, bt, dens, traced_den, rates14, ptxas, builds, smi):
    """[18] The JAX package's ``DensityLite`` with the user's own gradient:
    bench.py's banana-32 written as a JAX user writes it
    (``DensityLite(logp=, grad=, vectorized=False, ...)``, each a
    function of one point) through ``sample`` at [3]'s configuration
    under ``nuts_kernel='cuda'``: warmup and post-warmup chunks on the
    kernels with the trace of the user's pair (no adjoint), 0 tree-loop
    transitions, no unit built during the run, [3]'s gates and the
    moments within 5 standard errors; its rates and the chunk kernels'
    device seconds beside [14]'s traced banana (the tracer's adjoint of
    the same function), and both programs' K = 2 chunks on the device
    alone on this path's final state. Then for each form (``grad=`` and
    the batched ``logp_and_grad=``, one program and unit) the frozen and
    warmup chunks (K = 2) and a block launch bitwise against the
    program's interpreter at TRACED_CHAINS chains, float32 and float64, at
    depth USER_CHECK_DEPTH; the kernels timed at depth 10. Last, the
    external form (``traceable=False``, the logp of one point in numpy):
    its logp over USER_EXT_ROWS rows on the host pool against the torch
    logp (float64, rtol USER_EXT_RTOL), its rows/s, and ``sample()`` on
    it raising before any device work. Returns {kernel row: (launches,
    max abs error, (ms, plain ms, bound ms, bound by))}."""
    from bayesfast_tpu_torch import _build, config
    from bayesfast_tpu_torch.samplers import nuts as tree
    from bayesfast_tpu_torch.samplers import nuts_cuda as nc
    from bayesfast_tpu_torch.samplers.metrics import init_diag_metric
    config.set_dtype(torch.float32)
    config.set_nuts_kernel('cuda')
    den, info = dens[USER_FORMS[0]]
    prog = den.kernel_spec()['program']
    progs = {f: dens[f][0].kernel_spec()['program'] for f in USER_FORMS}
    same = all(p.source(torch.float32) == prog.source(torch.float32)
               for p in progs.values())
    print(f'[18] bench banana with the user\'s gradient (grad= of one '
          f'point, vectorized=False): {len(prog.nodes)} nodes '
          f'({prog.describe()}), {prog.n_ops} operations an evaluation '
          f'([14]\'s adjoint {traced_den.kernel_spec()["program"].n_ops}), '
          f'{_traced_leapfrog_ops(prog)} a leapfrog; the logp_and_grad= '
          f'form\'s unit the same: {same}')
    tree.nuts_transition_batched.transitions = 0
    built = set(_build.traced_builds)
    with _CallEvents(torch) as ev:
        tt, launches, rates = _sample_path(
            torch, bt, den, info['A'], "[18] main path, the banana with the "
            "user's gradient, nuts_kernel='cuda'",
            {'nuts_warmup': 1 + 4 * 2, 'nuts_multi': 3 * 2})
        dev_s = ev.device_ms() / 1e3
    n_tree = tree.nuts_transition_batched.transitions
    new = sorted(set(_build.traced_builds) - built)
    _banana_moments(tt, info['A'], '[18]')
    print(f'    tree-loop transitions {n_tree}; units built during the '
          f'run: {new or "none"}; the chunk kernels {dev_s:.3f} device s '
          f'({len(ev.events)} launches); [14] traced (adjoint): warmup '
          f'{rates14["warmup_its"]:.1f} it/s, ESS/s '
          f'{rates14["ess_s"]:.1f}; user gradient / adjoint: warmup '
          f'{rates["warmup_its"] / rates14["warmup_its"]:.3f}, post '
          f'{rates["post_its"] / rates14["post_its"]:.3f}, ESS/s '
          f'{rates["ess_s"] / rates14["ess_s"]:.3f}; {smi}')
    if n_tree != 0:
        raise AssertionError('[18] transitions ran on the tree loop')
    if new:
        raise AssertionError(f'[18] the run built {new}')
    ops = _traced_leapfrog_ops(prog)
    print('[18] K=2 chunks on this path\'s final state, device only: the '
          'user\'s gradient, then [14]\'s adjoint of the same function')
    _time_chunks(torch, den, tt.trace._carry, None, ops, '_user_grad C=1024',
                 timer=_device_ms)
    _time_chunks(torch, traced_den, tt.trace._carry, None,
                 _traced_leapfrog_ops(traced_den.kernel_spec()['program']),
                 '_traced C=1024', timer=_device_ms)
    errs, carry = {}, _first_chains(tt.trace._carry, TRACED_CHAINS)
    for form in USER_FORMS:
        den_f = dens[form][0]
        for dt, peak in ((torch.float32, PEAK_FP32),
                         (torch.float64, PEAK_FP64)):
            tag = str(dt)[6:]
            c = _cast(carry, dt)
            e, plain_ms = _chunks_vs_plain(
                torch, den_f, c, dt, f'user gradient ({form}=)',
                '_user_grad', block=True, depth=USER_CHECK_DEPTH)
            for k, v in e.items():
                errs[k] = max(errs.get(k, 0.0), v)
            if form != USER_FORMS[0]:
                continue
            # the plain ms beside the kernel's: the compared call's, at
            # the checks' depth
            C, dim = c.q.shape
            times = _time_chunks(torch, den_f, c, plain_ms, ops,
                                 '_user_grad', peak)[0]
            metric = init_diag_metric(c.q, nc._mat(c.metric.var, C, dim,
                                                   c.q))
            times['nuts_block_user_grad'] = _time_block(
                torch, den_f, c.q, metric, torch.exp(c.step.log_bar),
                plain_ms['nuts_block_user_grad'], ops, peak,
                f'  nuts_block_user_grad {tag}')[0]
            if dt == torch.float32:
                f32_times = times
            label = f'user_grad {tag}'
            print(f'  user gradient {tag}: kernels '
                  f'{_ptxas_text(ptxas, label)}; built in {builds[label]}')
    rows = {f'{kind}_user_grad': (launches.get(kind, 0),
                                  errs[f'{kind}_user_grad'],
                                  f32_times[f'{kind}_user_grad'])
            for kind in ('nuts_multi', 'nuts_warmup', 'nuts_block')}
    _external_form(torch, bt, dens, info)
    return rows


def _external_form(torch, bt, dens, info):
    """[18] The external form: the banana's logp of one point in numpy
    under ``traceable=False``, its rows over the host pool
    (``utils.parallel.get_backend().map``) against the torch logp in
    float64; then ``sample()`` on it, which must raise ``ValueError``
    before any device work (no launch, no tree-loop transition, no
    allocation on the card)."""
    from bayesfast_tpu_torch import config
    from bayesfast_tpu_torch.samplers import nuts as tree
    config.set_dtype(torch.float64)
    ext = dens['external'][0]
    lo, hi = ext.input_scales[:, 0], ext.input_scales[:, 1]
    rng = np.random.default_rng(18)
    x = (info['A'].T @ np.ones(D))[None] + rng.normal(
        size=(USER_EXT_ROWS, D)) * 0.5
    x = np.clip(x, lo * 0.99, hi * 0.99)
    t0 = time.time()
    lp_ext = ext.logp(x)
    dt_ext = time.time() - t0
    lp_ref = dens[USER_FORMS[0]][0].logp(x)
    rel = float(np.max(np.abs(lp_ext - lp_ref) / np.abs(lp_ref)))
    print(f'[18] external form (traceable=False, numpy): {USER_EXT_ROWS} '
          f'rows on the host pool in {dt_ext:.3f} s '
          f'({USER_EXT_ROWS / dt_ext:.0f} rows/s); against the torch logp '
          f'(float64): max rel err {rel:.3e} (tolerance {USER_EXT_RTOL})')
    if not rel < USER_EXT_RTOL:
        raise AssertionError(f'[18] the external logp differs by {rel}')
    config.set_dtype(torch.float32)
    for f in _counters().values():
        f.launches = 0
    tree.nuts_transition_batched.transitions = 0
    torch.cuda.synchronize()
    mem = torch.cuda.memory_allocated()
    try:
        bt.sample(ext, bt.NTrace(n_chain=N_CHAIN, n_iter=20, n_warmup=10),
                  verbose=False)
    except ValueError as exc:
        msg = str(exc)
    else:
        raise AssertionError('[18] sample() ran on the external logp')
    moved = {k: f.launches for k, f in _counters().items() if f.launches}
    n_tree = tree.nuts_transition_batched.transitions
    d_mem = torch.cuda.memory_allocated() - mem
    print(f'    sample() on it raised ValueError: "{msg[:90]}..."; '
          f'launches {moved or "none"}, tree-loop transitions {n_tree}, '
          f'bytes allocated on the card {d_mem}')
    if moved or n_tree or d_mem:
        raise AssertionError('[18] sample() worked on the card before it '
                             'refused the external logp')


def _donut_sources(torch):
    """[2] The generated units of the donut Recipe's two plans ([15]): the
    OptimizeStep's linear surrogate and the SampleSteps' quadratic one, each
    then the user's ``f_1`` and the decay, traced from the Recipe's own
    objects before any fit (a plan's program is a function of its
    structure; a fit changes its parameters only), in DONUT_UNITS' dtypes.
    Returns {'donut plan dtype': source}."""
    from bayesfast_tpu_torch import config
    from bayesfast_tpu_torch.examples import donut_recipe
    dtype = config.get_dtype()
    rec = donut_recipe.build()
    rt = rec.recipe_trace
    den = rec.density
    den.use_surrogate = True
    plans = {'linear': rt._s_optimize.surrogate_list,
             'quadratic': rt._strategy._sample_steps[0].surrogate_list}
    srcs = {}
    for plan, dt in DONUT_UNITS:
        den.surrogate_list = list(plans[plan])
        srcs[f'donut {plan} {dt}'] = den.kernel_spec()['program'].source(
            getattr(torch, dt))
    config.set_dtype(dtype)
    return srcs


def _donut(torch, bt, ptxas, builds, srcs, smi):
    """[15] The 2-d donut Recipe (``examples/donut_recipe.py``) at its
    configuration under ``nuts_kernel='auto'``, float64: both of its
    sampled plans end in the user's ``f_1``, so every transition runs on
    the chunk kernels with the plan's traced functor (0 tree-loop
    transitions), each plan's unit the one [2] built before any fit. Gates
    n_call <= DONUT_NCALL, finite weights and |E[r] - DONUT_R| <=
    DONUT_R_TOL. Then the quadratic plan's frozen and warmup K = 2 chunks
    and a block launch bitwise against the program's interpreter at the
    Recipe's 8 chains on its final state, float64 and float32, and timed.
    Returns {kernel row: (launches, max abs error, (ms, plain ms, bound
    ms, bound by))} with the float64 times."""
    from bayesfast_tpu_torch import config
    from bayesfast_tpu_torch.examples import donut_recipe
    from bayesfast_tpu_torch.samplers import nuts_cuda as nc
    from bayesfast_tpu_torch.samplers.metrics import init_diag_metric
    config.set_nuts_kernel('auto')
    rec = donut_recipe.build()
    run = _run_recipe(torch, rec)
    res = rec.get()
    w = res.weights_trunc
    r_mean = donut_recipe.mean_radius(res)
    ph = run['phases']
    print(f'[15] donut Recipe (examples/donut_recipe.py): D=2, 8 chains x '
          f'1000 (500 warmup), float64, nuts_kernel=\'auto\'; Recipe.run() '
          f'{run["run_s"]:.2f} s: ' +
          ', '.join(f'{k} {v:.2f} s' for k, v in ph.items()))
    print('    parts (s): ' + ', '.join(f'{k} {v:.3f}'
                                        for k, v in run['parts'].items()))
    prev = run['start'] + ph['optimize']
    for i, (dt, ln, nt, t_end) in enumerate(run['calls']):
        step = ('optimize' if i == 0 else
                f'sample step #{i - 1} {t_end - prev:.2f} s,')
        prev = t_end if i else prev
        print(f'    {step} sample() {dt:.2f} s, launches '
              f'{ {k: v for k, v in ln.items() if v} }, tree-loop '
              f'transitions {nt}')
    print(f'    chunk calls: {run["host"]["chunk_calls"]}, host '
          f'{run["host"]["chunk_host_s"]:.3f} s, kernels '
          f'{run["parts"]["kernels_s"] * 1e3:.1f} ms; launches (kind, K: '
          f'launches, device s, ms a transition): {_mix_text(run["mix"])}')
    print(f'    units built during the run: {run["built"] or "none"}; '
          f'each plan\'s unit built in [2]: ' + ', '.join(
              f'{k} {builds[k]}' for k in srcs))
    print(f'    n_call {res.n_call} (gate <= {DONUT_NCALL}; the notebook '
          f'~330, both packages 296 on the CPU); IS-weighted E[r] '
          f'{r_mean:.4f} (gate |E[r] - {DONUT_R}| <= {DONUT_R_TOL}); '
          f'tree-loop transitions {run["n_tree"]}')
    calls = run['calls']
    if not (len(calls) == 3 and run['n_tree'] == 0 and all(
            ln['nuts_warmup'] > 0 and ln['nuts_multi'] > 0 and nt == 0
            for _, ln, nt, _ in calls)):
        raise AssertionError('[15]: a donut sample step did not run every '
                             'transition on the chunk kernels')
    if run['built']:
        raise AssertionError(f'[15]: the run built {run["built"]}: a plan\'s '
                             'program changed with its fit')
    if not (np.isfinite(w).all() and np.isfinite(res.weights).all()):
        raise AssertionError('[15]: non-finite importance weights')
    if not (res.n_call is not None and res.n_call <= DONUT_NCALL):
        raise AssertionError(f'[15]: n_call {res.n_call} > {DONUT_NCALL}')
    if not abs(r_mean - DONUT_R) <= DONUT_R_TOL:
        raise AssertionError(f'[15]: E[r] {r_mean} off {DONUT_R}')
    den = rec.density
    den.use_surrogate = True
    prog = den.kernel_spec()['program']
    if prog.source(torch.float64) != srcs['donut quadratic float64']:
        raise AssertionError('[15]: the last step\'s plan is not the '
                             'quadratic unit of [2]')
    ops = _traced_leapfrog_ops(prog)
    carry = rec.recipe_trace.results.sample[-1].sample_trace.trace._carry
    print(f'[15] the quadratic plan: {len(prog.nodes)} nodes '
          f'({prog.describe()}), {prog.n_ops} operations an evaluation, '
          f'{ops} a leapfrog; kernels vs plain at the Recipe\'s '
          f'{carry.q.shape[0]} chains, its final state, K={K_CMP}')
    errs, times = {}, {}
    for dt, peak in ((torch.float64, PEAK_FP64), (torch.float32, PEAK_FP32)):
        tag = str(dt)[6:]
        c = _cast(carry, dt)
        C, dim = c.q.shape
        e, plain_ms = _chunks_vs_plain(torch, den, c, dt, 'traced donut',
                                       '_donut', block=True)
        # 8 chains: a launch is shorter than the wrapper's host work, so
        # the kernels are timed on the device alone (_CallEvents)
        t = _time_chunks(torch, den, c, plain_ms, ops, '_donut', peak,
                         timer=_device_ms)[0]
        metric = init_diag_metric(c.q, nc._mat(c.metric.var, C, dim, c.q))
        t['nuts_block_donut'] = _time_block(
            torch, den, c.q, metric, torch.exp(c.step.log_bar),
            plain_ms['nuts_block_donut'], ops, peak,
            f'  nuts_block_donut {tag}', timer=_device_ms)[0]
        call_ms = _time_ms(torch, lambda: nc.nuts_chunk_batched(
            5, c.q, metric, torch.exp(c.step.log_bar), K_CMP, MAX_TREEDEPTH,
            MAX_CHANGE, density=den, i0=700), 5)[0]
        print(f'  nuts_multi_donut {tag}: the wrapper\'s call (host work '
              f'and launch, CUDA events) {call_ms:.3f} ms')
        times[dt] = t
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
        label = f'donut quadratic {tag}'
        print(f'  traced donut {tag}: kernels {_ptxas_text(ptxas, label)}; '
              f'built in {builds[label]}; {smi}')
    launches = run['launches']
    return {f'{kind}_donut': (launches[kind], errs[f'{kind}_donut'],
                              times[torch.float64][f'{kind}_donut'])
            for kind in ('nuts_multi', 'nuts_warmup', 'nuts_block')}


def _wide_4(torch):
    """[16a] A D = 4 density with a 4 x 990 matrix: its adjoint's 32 rows
    of 990 pass a buffer, so they stream in column tiles (35 tiles an
    evaluation in float64: an odd count)."""
    import bayesfast_tpu_torch as bt
    W = torch.as_tensor(np.random.default_rng(2).normal(size=(4, 990)))
    return bt.DensityLite(
        logp=lambda x: torch.sum(torch.exp(0.01 * (x @ W.to(x))), -1),
        input_size=4), {}


def _copies_twice(src):
    """The source of a generated unit whose every tile is copied twice
    (``load_tile``'s bulk copies repeated, each buffer's mbarrier counting
    the second copy's arrival too): the same bits, twice the copies."""
    import re
    call = re.search(r'\n( *)bulk_tile\(.*?\);', src, re.S)
    src = src[:call.end()] + call.group(0) + src[call.end():]
    assert src.count('kWarps * 32 + 1);') == 2
    return src.replace('kWarps * 32 + 1);', 'kWarps * 32 + 2);')


def _wide_sources(torch):
    """[2] The targets of [16] (``examples/wide_gaussians.py``) and
    [16a]'s D = 4 density (``_wide_4``), and the generated unit of each of
    WIDE_UNITS: Neal-100's compiled-in Gaussian at NE = 4
    (``nuts_cuda.wide_unit_source``), MVN-250's traced functor at NE = 8,
    the D = 4 density's and the MVN's float32 unit with its tiles copied
    twice (``_copies_twice``). Returns ({name: (density, info)}, {'name
    dtype': source})."""
    from bayesfast_tpu_torch.examples.wide_gaussians import mvn_250, neal_100
    from bayesfast_tpu_torch.ops.densities import DENSITY_IDS
    from bayesfast_tpu_torch.samplers import nuts_cuda as nc
    dens = {'neal_100': neal_100(), 'mvn_250': mvn_250(),
            'wide_4': _wide_4(torch)}
    srcs = {}
    for name, dt in WIDE_UNITS:
        dtype = getattr(torch, dt)
        srcs[f'{name} {dt}'] = (
            nc.wide_unit_source(DENSITY_IDS['gaussian'], 100, dtype)
            if name == 'neal_100' else
            dens[name][0].kernel_spec()['program'].source(dtype))
    srcs[COPIES_TWICE] = _copies_twice(srcs['mvn_250 float32'])
    return dens, srcs


def _unit_registers(srcs, tag='[2b]'):
    """Registers and spills of each generated unit's three kernels, from
    its build's -Xptxas -v output; past NE = 2 a lane's transition state
    spills to local memory (not gated). Returns {label: table}."""
    from bayesfast_tpu_torch import _build
    tables = {}
    for label, src in srcs.items():
        log = _build.build_log(source=src)
        if log is None:
            raise AssertionError(f'no compiler output beside the unit of '
                                 f'{label}')
        tables[label] = _ptxas_table(log)
        print(f'{tag} {label}:')
        for k in sorted(tables[label]):
            print(f'    {k:52s} {tables[label][k]}')
        n_kern = sum(k.startswith('nuts_') for k in tables[label])
        if n_kern != 3:
            raise AssertionError(f'{label}: {n_kern} kernels, not 3')
    return tables


def _gaussian_leapfrog_ops(dim):
    """Operations of one leapfrog of the compiled-in Gaussian behind the
    fused bound transform: about 70 a dimension for the transition's own
    (``_anchor_leapfrog_ops``) and the density's difference, square,
    divide and gradient (4)."""
    return (70 + 4) * dim


def _wide_sample(torch, bt, den, tag, n_warm, n_post, **trace_kw):
    """[16] One target through ``sample`` at WIDE_CHAINS chains, seed
    WIDE_SEED, under 'auto': every launch count and the tree-loop count
    set to 0 just before, read just after, the kernels' device time by
    launch kind and K (``_CallEvents``). Gates 0 tree-loop transitions, no
    unit built during the run, finite draws of the expected shape and
    post-warmup divergences below 5 %. Returns (trace tuple, launches,
    the run's numbers)."""
    from bayesfast_tpu_torch import _build
    from bayesfast_tpu_torch.samplers import nuts as tree
    bt.utils.set_generator(WIDE_SEED)
    trace = bt.NTrace(n_chain=WIDE_CHAINS, n_iter=n_warm + n_post,
                      n_warmup=n_warm, **trace_kw)
    for f in _counters().values():
        f.launches = 0
    tree.nuts_transition_batched.transitions = 0
    built = set(_build.traced_builds)
    torch.cuda.synchronize()
    t0 = time.time()
    with _CallEvents(torch) as ev:
        tt = bt.sample(den, trace, verbose=False)
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: f.launches for k, f in _counters().items()}
    n_tree = tree.nuts_transition_batched.transitions
    new = sorted(set(_build.traced_builds) - built)
    mix = {}
    for kind, k, e0, e1 in ev.events:
        n, ms = mix.get((kind, k), (0, 0.0))
        mix[kind, k] = (n + 1, ms + e0.elapsed_time(e1))
    st = tt.trace._stats_arrays
    s = tt.get(flatten=False)
    div = float(np.mean(st['diverging'][:, n_warm:]))
    size = st['tree_size'][:, n_warm:]
    depth = float(np.mean(st['tree_depth'][:, n_warm:]))
    acc = float(np.mean(st['mean_tree_accept'][:, n_warm:]))
    dim = den.input_size
    print(f'{tag}: {WIDE_CHAINS} chains x {n_warm} + {n_post}, D={dim}, '
          f'float32, sample() {wall:.2f} s; launches '
          f'{ {k: v for k, v in launches.items() if v} }; tree-loop '
          f'transitions {n_tree}; units built during the run: '
          f'{new or "none"}')
    print(f'    launches (kind, K: launches, device s, ms a transition): '
          f'{_mix_text(mix)}')
    print(f'    post-warmup: mean tree size {size.mean():.2f} (max '
          f'{int(size.max())}), depth {depth:.3f}, accept {acc:.4f}, '
          f'divergent {div:.4f}')
    if n_tree != 0:
        raise AssertionError(f'{tag}: transitions ran on the tree loop')
    if new:
        raise AssertionError(f'{tag}: the run built {new}')
    if not (np.isfinite(s).all() and s.shape == (WIDE_CHAINS, n_post, dim)):
        raise AssertionError(f'{tag}: non-finite or misshapen draws '
                             f'{s.shape}')
    if not div < 0.05:
        raise AssertionError(f'{tag}: post-warmup divergence fraction {div}')
    return tt, launches, dict(wall=wall, mix=mix, size=float(size.mean()))


def _stacks_text(den, dim, dtype):
    """Where a launch keeps the checkpoint stacks
    (``csrc/nuts_kernels.cuh::launch_kernel``): beside the density's own
    shared memory when a block's 8 warps' frames fit there, else in global
    scratch."""
    from bayesfast_tpu_torch.ops.codegen import _Layout
    itemsize = dtype.itemsize
    spec = den.kernel_spec()
    own = (_Layout(spec['program'], itemsize).smem * itemsize
           if spec['density'] == 'traced' else 0)
    stacks = 8 * (MAX_TREEDEPTH - 1) * (4 * dim + 3) * itemsize
    where = ('shared memory' if own + stacks <= 232448 else
             'global scratch')
    return (f'checkpoint stacks {stacks} B + the density\'s {own} B of '
            f'232448: {where}')


def _zero_mean_gate(s, tag):
    """Every coordinate's mean over the draws ``s`` (C, N, D) within 5 of
    its standard errors of 0, each from the spread over WIDE_GROUPS = 32
    groups of chains, as [3] reads them (over 8 groups, 7 degrees of
    freedom, a fair run's largest of 250 such ratios passes 5 about a
    third of the time)."""
    m = s.mean((0, 1))
    se = _group_se(lambda a: a.mean((0, 1)), s, WIDE_GROUPS)
    z = np.abs(m) / se
    print(f'    every coordinate\'s mean: max |mean| / group se {z.max():.3f} '
          f'(gate 5; se {se.min():.3g}..{se.max():.3g})')
    if not (np.isfinite(z).all() and z.max() < 5.0):
        raise AssertionError(f'{tag}: a mean is {z.max()} group standard '
                             'errors off 0')


def _wide(torch, bt, dens, srcs, ptxas, builds, smi):
    """[16] The kernels past D = 64: [16b] Neal-100 (the compiled-in
    Gaussian, its unit at NE = 4) and [16c] MVN-250 (the user's torch
    logp traced, NE = 8) through ``sample`` (``_wide_sample``), the MVN
    also with a pooled metric (every warmup transition one block launch);
    the moment gates; then [16a] each new instantiation's frozen and
    warmup chunks (K = WIDE_K) and block launch bitwise against their
    plain versions on the runs' final states, float32 (Neal at 1024
    chains, the MVN at MVN_CMP_CHAINS) and float64 (WIDE_F64_CHAINS), and
    timed in float32 at 1024 chains; the D = 4 density's (``_wide_4``:
    column tiles, an odd count) bitwise at 64 chains; the MVN's frozen and
    warmup chunks with its tiles copied twice (``srcs[COPIES_TWICE]``)
    against its unit as built, at 1024 chains and on one block, bitwise.
    Returns ({kernel row: (launches, max abs error, (ms, plain ms, bound
    ms, bound by))}, the MVN's per-chain run's final carry)."""
    from bayesfast_tpu_torch import config
    from bayesfast_tpu_torch.samplers import nuts_cuda as nc
    from bayesfast_tpu_torch.samplers.metrics import init_diag_metric
    config.set_dtype(torch.float32)
    config.set_nuts_kernel('auto')
    rows = {}
    den_n, info_n = dens['neal_100']
    den_m, info_m = dens['mvn_250']
    prog = den_m.kernel_spec()['program']
    P = info_m['P']

    # ---- [16b] Neal-100 ----
    tn, ln, _ = _wide_sample(torch, bt, den_n, "[16b] Neal-100, compiled-in "
                             "Gaussian (NE = 4)", NEAL_WARMUP, NEAL_POST)
    s = tn.get(flatten=False)
    _zero_mean_gate(s, '[16b]')
    v = s.reshape(-1, s.shape[-1]).var(0) / info_n['sd'] ** 2 - 1.0
    print(f'    variances: max |var / sd^2 - 1| {np.abs(v).max():.4f} (gate '
          f'0.1)')
    if not np.abs(v).max() < 0.1:
        raise AssertionError('[16b]: a variance is off by more than 10 %')

    # ---- [16c] MVN-250, per chain then pooled ----
    print(f'[16c] MVN-250 traced: {len(prog.nodes)} nodes '
          f'({prog.describe()}), {prog.n_ops} operations an evaluation, '
          f'{_traced_leapfrog_ops(prog)} a leapfrog; P^T and P past a '
          f'block\'s shared memory, streamed')
    tm, lm, _ = _wide_sample(torch, bt, den_m, '[16c] MVN-250, per-chain '
                             'metric', MVN_WARMUP, MVN_POST)
    s = tm.get(flatten=False)
    _zero_mean_gate(s, '[16c]')
    flat = s.reshape(-1, s.shape[-1]).astype(np.float64)
    chi2 = float(np.mean(np.sum((flat @ P) * flat, axis=-1)))
    print(f'    mean x\'Px {chi2:.3f} (chi^2_250: 250; gate within 5 %)')
    if not abs(chi2 / 250.0 - 1.0) < 0.05:
        raise AssertionError(f'[16c]: mean x\'Px {chi2} off 250')
    tp, lp, _ = _wide_sample(torch, bt, den_m, '[16c] MVN-250, pooled '
                             'metric', MVN_POOLED_WARMUP, MVN_POOLED_POST,
                             pooled_metric=True)
    var_shape = tuple(tp.trace._carry.metric.var.shape)
    print(f'    shared metric variance shape {var_shape}')
    if var_shape != (250,) or lp['nuts_block'] != MVN_POOLED_WARMUP:
        raise AssertionError(f'[16c]: pooled variance of shape {var_shape},'
                             f' {lp["nuts_block"]} block launches')

    # ---- [16a] the new instantiations bitwise, then timed ----
    cases = (('neal', 'Neal-100', den_n, tn, WIDE_CHAINS, ln,
              _gaussian_leapfrog_ops(100), 'neal_100'),
             ('mvn', 'MVN-250', den_m, tm, MVN_CMP_CHAINS,
              {**lm, 'nuts_block': lp['nuts_block']},
              _traced_leapfrog_ops(prog), 'mvn_250'))
    for key, name, den, tt, c32, launches, ops, unit in cases:
        carry = tt.trace._carry
        errs = {}
        if key == 'mvn':
            for dt in (torch.float32, torch.float64):
                print(f'[16a] MVN-250 {str(dt)[6:]} plan: '
                      f'{_tile_plan(prog, dt.itemsize)}')
        # the MVN's trees reach depth 10 (1023 leapfrogs of a 256 x 256
        # matvec each in its plain version): its checks at depth 6, as
        # [17a]'s
        depth = WIDE_CHECK_DEPTH if key == 'mvn' else MAX_TREEDEPTH
        for dt, n_c in ((torch.float32, c32),
                        (torch.float64, WIDE_F64_CHAINS)):
            c = _cast(_first_chains(carry, n_c), dt)
            print(f'[16a] {name} kernels vs plain, C={n_c}, K={WIDE_K}, '
                  f'depth {depth}, {str(dt)[6:]}, the run\'s final state')
            e, plain_ms = _chunks_vs_plain(torch, den, c, dt, name,
                                           f'_wide_{key}', block=True,
                                           k=WIDE_K, depth=depth)
            for k, val in e.items():
                errs[k] = max(errs.get(k, 0.0), val)
            if dt == torch.float32:
                plain32 = plain_ms
            label = f'{unit} {str(dt)[6:]}'
            print(f'  {name} {str(dt)[6:]}: kernels '
                  f'{_ptxas_text(ptxas, label)}; built in {builds[label]}; '
                  f'{_stacks_text(den, c.q.shape[1], dt)}')
        # timed at the path's 1024 chains (the plain ms: at c32 chains),
        # on the device alone (Neal's launches are shorter than the
        # wrapper's host work)
        C, dim = carry.q.shape
        times = _time_chunks(torch, den, carry, plain32, ops,
                             f'_wide_{key}', k=WIDE_K, timer=_device_ms)[0]
        metric = init_diag_metric(carry.q,
                                  nc._mat(carry.metric.var, C, dim, carry.q))
        times[f'nuts_block_wide_{key}'] = _time_block(
            torch, den, carry.q, metric, torch.exp(carry.step.log_bar),
            plain32[f'nuts_block_wide_{key}'], ops,
            tag=f'  nuts_block_wide_{key}', timer=_device_ms)[0]
        print(f'  {name}: plain ms at C={c32}, depth {depth}; {smi}')
        for kind in ('nuts_multi', 'nuts_warmup', 'nuts_block'):
            k = f'{kind}_wide_{key}'
            rows[k] = (launches.get(kind, 0), errs[k], times[k])

    _stream_checks(torch, dens, srcs, tm.trace._carry, ptxas, builds)
    return rows, tm.trace._carry


def _stream_checks(torch, dens, srcs, carry, ptxas, builds):
    """[16a] The streamed route's other shapes and its copies: the D = 4
    density's (``_wide_4``: column tiles, an odd count) frozen and warmup
    chunks and block launch bitwise against their plain versions on a
    seeded state at 64 chains, float32 and float64; then MVN-250's float32
    chunks on ``carry`` (1024 chains, and its first 8: one block) with
    every tile copied twice (``srcs[COPIES_TWICE]``) against its unit as
    built, device only, bitwise."""
    # ---- [16a] column tiles and an odd count of tiles: the D = 4
    # density's kernels bitwise on a seeded state at 64 chains ----
    from types import SimpleNamespace as NS
    den_w = dens['wide_4'][0]
    wprog = den_w.kernel_spec()['program']
    rng = np.random.default_rng(5)
    dev = torch.device('cuda')
    carry_w = NS(q=torch.as_tensor(rng.normal(size=(64, 4)) * 0.3,
                                   device=dev),
                 metric=NS(var=torch.ones(64, 4, device=dev)),
                 step=NS(log_bar=torch.full((64,), -3.0, device=dev)))
    for dt in (torch.float32, torch.float64):
        tag = str(dt)[6:]
        print(f'[16a] D = 4 x 990 {tag}, C=64, K={WIDE_K}: '
              f'{_tile_plan(wprog, dt.itemsize)}; kernels '
              f'{_ptxas_text(ptxas, f"wide_4 {tag}")}; built in '
              f'{builds[f"wide_4 {tag}"]}')
        _chunks_vs_plain(torch, den_w, carry_w, dt, 'D = 4 x 990', '_wide4',
                         block=True, k=WIDE_K)

    # ---- [16a] what the MVN's tile copies cost: its float32 chunks with
    # every tile copied twice against the unit as built, on [16c]'s final
    # state (device only) ----
    den_m = dens['mvn_250'][0]
    prog = den_m.kernel_spec()['program']
    unit, key = prog.source(torch.float32), str(torch.float32)
    ops = _traced_leapfrog_ops(prog)
    for n in (WIDE_CHAINS, 8):
        c = carry if n == WIDE_CHAINS else _first_chains(carry, n)
        ms, digests = {}, {}
        for label, src in (('as built', unit),
                           ('copied twice', srcs[COPIES_TWICE])):
            prog._sources[key] = src
            try:
                t, _, outs = _time_chunks(torch, den_m, c, ops=ops,
                                          suffix=f' [{label}, C={n}]',
                                          k=WIDE_K, timer=_device_ms)
            finally:
                prog._sources[key] = unit
            ms[label] = [v[0] for v in t.values()]
            digests[label] = _digest(outs)
        same = digests['as built'] == digests['copied twice']
        print(f'[16a] MVN-250 tiles copied twice, C={n}: frozen / warmup '
              f'K={WIDE_K} chunks ' + ' / '.join(
                  f'{b / a - 1:+.2%}' for a, b in zip(
                      ms['as built'], ms['copied twice']))
              + f'; outputs bitwise: {same}')
        if not same:
            raise AssertionError('[16a]: the MVN\'s unit with its tiles '
                                 'copied twice disagrees with it')


def _ptxas_sweep(torch):
    """Registers and spills of the three kernels past D = 64 at every lane
    width NE = 3..8, float32 and float64: the compiled-in Gaussian's unit
    (the transition with the lightest density), a traced -0.5 x'Px at
    D = 32 NE (P a Wishart(D, I) draw: staged in shared memory while it
    fits, else streamed through shared tiles) and the PolyGaussian unit of
    the wide Recipe's surrogate at D = 32 NE on its plan's path
    (``_wide_poly_sources``), all built in parallel.
    Prints each kernel's registers, stack frame and spill bytes and each
    build's nvcc seconds."""
    from scipy.stats import wishart
    from bayesfast_tpu_torch import _build
    from bayesfast_tpu_torch.ops.codegen import _Layout
    from bayesfast_tpu_torch.ops.densities import DENSITY_IDS
    from bayesfast_tpu_torch.ops.trace import trace_density
    from bayesfast_tpu_torch.samplers import nuts_cuda as nc
    def quadratic(P):
        def logp(x):
            return -0.5 * torch.sum((x @ P.to(x)) * x, dim=-1)
        return logp

    srcs = {}
    for ne in range(3, 9):
        D = 32 * ne
        P = torch.as_tensor(wishart(df=D, scale=np.eye(D)).rvs(
            random_state=0))
        prog = trace_density(quadratic(P), D, torch.float64, 'cpu')
        for dt in (torch.float32, torch.float64):
            tag = str(dt)[6:]
            srcs[f'gaussian NE={ne} {tag}'] = nc.wide_unit_source(
                DENSITY_IDS['gaussian'], D, dt)
            staged = [m[7] for m in _Layout(prog, dt.itemsize).mats]
            srcs[f'traced x\'Px NE={ne} {tag} staged {staged}'] = \
                prog.source(dt)
            plan = nc.poly_smem_plan(D, *_wide_poly_shape(D), False,
                                     MAX_TREEDEPTH, dt.itemsize)
            stream = plan.get('stream', False)
            srcs[f'PolyGaussian NE={ne} {tag} streamed {stream}'] = \
                nc.poly_unit_source(D, dt, stream)
    _build.build_library([], sources=list(srcs.values()))
    for label, src in srcs.items():
        stem = os.path.basename(_build.traced_path(src))[6:-3]
        w = _build.last_build_walls.get(stem)
        print(f'[sweep] {label}: nvcc '
              f'{"reused" if w is None else f"{w:.1f} s"}')
    _unit_registers(srcs, '[sweep]')
    print(f'[sweep] {len(srcs)} units built together in '
          f'{_build.last_build_seconds:.1f} s')


def _ptxas_text(ptxas, label):
    return '; '.join(f'{k.split()[0]} {k.split()[-1]}: {v[0]} registers, '
                     f'{v[2]} / {v[3]} B spilled'
                     for k, v in sorted(ptxas.get(label, {}).items()))


def _tile_plan(prog, itemsize):
    """The streamed matrices of a traced program's functor at
    ``itemsize`` (``ops/codegen.py::_Layout``) in words, with the bytes a
    block reads from L2 per leapfrog (``_traced_l2_bytes``)."""
    from bayesfast_tpu_torch.ops.codegen import _Layout
    lay = _Layout(prog, itemsize)
    tiles = getattr(lay, 'tiles', None)
    if tiles is None:
        plan = 'each chain reads its unstaged matrices from L2'
    elif tiles:
        plan = (f'{len(tiles)} tiles an evaluation of 32 rows x {lay.te} '
                f'slots, two buffers of {lay.tile_elems * itemsize} B '
                f'shared by the block\'s 8 chains')
    else:
        plan = 'every matrix staged'
    return (f'{plan}; {lay.smem * itemsize} B of shared memory a block; '
            f'{_traced_l2_bytes(prog, itemsize)} L2 bytes a leapfrog and '
            f'block')


def _traced_l2_bytes(prog, itemsize):
    """Bytes a block reads from L2 per leapfrog (its 8 chains on one) for
    a traced functor's matrices that are not staged: every streamed tile
    once (the layout's schedule); on a checkout without tiles (each chain
    reading them through ``__ldg``) each chain's products' loads, rows x
    32 NI values a product."""
    from bayesfast_tpu_torch.ops.codegen import _Layout
    lay = _Layout(prog, itemsize)
    if hasattr(lay, 'tiles'):
        return lay.l2_bytes()
    total = 0
    for nd in prog.nodes:
        if nd.op == 'mv' and not lay.mats[lay.mat(nd.attr)][7]:
            _, _, m, n, rows, _, _, _ = lay.mats[lay.mat(nd.attr)]
            total += rows * 32 * (-(-n // 32)) * itemsize
    return 8 * total


def _mvn_state(torch, bt):
    """--ab: MVN-250's final state after a per-chain ``sample`` at 1024
    chains, float32, seed WIDE_SEED, MVN_AB_WARMUP + MVN_AB_POST
    iterations (the first process; every process times on it)."""
    from bayesfast_tpu_torch.examples.wide_gaussians import mvn_250
    bt.utils.set_generator(WIDE_SEED)
    tt = bt.sample(mvn_250()[0], bt.NTrace(
        n_chain=WIDE_CHAINS, n_iter=MVN_AB_WARMUP + MVN_AB_POST,
        n_warmup=MVN_AB_WARMUP), verbose=False)
    return tt.trace._carry


def _mvn_timed(torch, carry):
    """--ab: MVN-250's K = WIDE_K frozen and warmup chunks and a block
    launch on ``carry`` (float32, 1024 chains), timed on the device alone
    with their slowest chains, the f32 unit's registers and spills and the
    L2 bytes a leapfrog and block of this checkout. Returns ({kernel:
    slowest chain}, {name: outputs digest}, ptxas table, L2 bytes)."""
    from bayesfast_tpu_torch import _build
    from bayesfast_tpu_torch.examples.wide_gaussians import mvn_250
    from bayesfast_tpu_torch.samplers import nuts_cuda as nc
    from bayesfast_tpu_torch.samplers.metrics import init_diag_metric
    den = mvn_250()[0]
    prog = den.kernel_spec()['program']
    ops = _traced_leapfrog_ops(prog)
    print(f'[16a] MVN-250 float32 plan: {_tile_plan(prog, 4)}')
    _, chains, outs = _time_chunks(torch, den, carry, ops=ops,
                                   suffix='_wide_mvn', k=WIDE_K,
                                   timer=_device_ms)
    C, dim = carry.q.shape
    metric = init_diag_metric(carry.q,
                              nc._mat(carry.metric.var, C, dim, carry.q))
    eps = torch.exp(carry.step.log_bar)
    _, chains['nuts_block_wide_mvn'] = _time_block(
        torch, den, carry.q, metric, eps, ops=ops,
        tag='  nuts_block_wide_mvn', timer=_device_ms)
    block = nc.nuts_transition_batched(5, carry.q, metric, eps,
                                       MAX_TREEDEPTH, MAX_CHANGE,
                                       density=den)
    digests = {f'MVN-250 {k} outputs [16a]': _digest(v)
               for k, v in {**outs, 'nuts_block': block}.items()}
    table = _ptxas_table(_build.build_log(source=prog.source(torch.float32)))
    return chains, digests, table, _traced_l2_bytes(prog, 4)


def _wide_poly_shape(dim):
    """(M, F, NNZ) of the wide Recipe's sample-step surrogate at ``dim``
    parameters (``examples/wide_recipe.py``): dim + 1 linear features and
    n (n + 1) / 2 quadratic ones on the n nonlinear parameters; a
    sparse-row entry a linear feature and two a quadratic one."""
    from bayesfast_tpu_torch.examples import wide_recipe as wr
    n = len(wr.NONLINEAR)
    return wr.N_DATA, dim + 1 + n * (n + 1) // 2, dim + n * (n + 1)


def _wide_poly_sources(torch):
    """[2] The PolyGaussian units of [17] and [17a]: NE = 4 (D = 100) and
    NE = 8 (D = 250), float32 and float64, each on the path its plan
    takes (``poly_smem_plan``: the streamed tiles where two fit). Returns
    {'poly D=.. dtype': source}."""
    from bayesfast_tpu_torch.samplers import nuts_cuda as nc
    srcs = {}
    for dim in WIDE_POLY_DIMS:
        for dt in ('float32', 'float64'):
            dtype = getattr(torch, dt)
            plan = nc.poly_smem_plan(dim, *_wide_poly_shape(dim), False,
                                     MAX_TREEDEPTH, dtype.itemsize)
            srcs[f'poly D={dim} {dt}'] = nc.poly_unit_source(
                dim, dtype, plan.get('stream', False))
    return srcs


class _Background:
    """``fn()`` in a thread of its own, started at once; ``join()`` waits
    for it and returns its result, or raises its exception. The thread
    runs at nice ``NVCC_NICE`` (Linux's nice is a thread's, and the
    processes it starts inherit it): its nvcc then leaves the cores that
    the host-bound phases beside it need to them."""

    def __init__(self, fn):
        import threading
        self._out = self._exc = None

        def run():
            try:
                os.setpriority(os.PRIO_PROCESS, threading.get_native_id(),
                               NVCC_NICE)
                self._out = fn()
            except BaseException as exc:  # raised again in join()
                self._exc = exc
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def join(self):
        self._thread.join()
        if self._exc is not None:
            raise self._exc
        return self._out


def _build_walls(srcs):
    """Build the generated units ``srcs`` ({label: source}) together;
    returns each nvcc's wall by stem, and the build's as 'total'."""
    from bayesfast_tpu_torch import _build
    _build.build_library([], sources=list(srcs.values()))
    return dict(_build.last_build_walls, total=_build.last_build_seconds)


def _poly_units(walls, srcs, ptxas, builds):
    """[2c] The PolyGaussian units of [17] (``_wide_poly_sources``), built
    in the background since [2] (``walls``: each nvcc's wall and the
    build's, from its start): loads them, records each one's nvcc wall in
    ``builds`` and its kernels' registers and spills in ``ptxas``."""
    from bayesfast_tpu_torch import _build
    print(f'[2c] PolyGaussian units past D = 64, built beside [3]-[9] in '
          f'{walls.pop("total"):.1f} s')
    for label, src in srcs.items():
        stem = os.path.basename(_build.traced_path(src))[6:-3]
        w = walls.get(stem)
        builds[label] = 'reused, not built' if w is None else f'{w:.1f} s'
        print(f'    {label}: {stem}, nvcc {builds[label]}')
        _build.load_traced(src)
    ptxas.update(_unit_registers(srcs, '[2c]'))


def _wide_recipe(torch, bt, smi):
    """[17] The DES-like Recipe at D = 100 (``examples/wide_recipe.py``:
    457 outputs, 1024 chains, float32) through ``Recipe.run()`` under
    ``nuts_kernel='cuda'`` (``_run_recipe``): every SampleStep on the chunk
    kernels with the compiled-in PolyGaussian at NE = 4 (its unit built in
    [2]), the last one's warmup pooled, one block launch a transition.
    Prints n_call, the walls of each phase and part, each sample() call's
    launches, tree-loop transitions and metric, the kernels' device s by
    kind and K, each distinct launch plan with its launches, and the
    IS-weighted means in analytic sigma. Gates: 0 tree-loop transitions;
    the per-chain calls' warmup on the warmup chunk kernel and no block
    launch; the pooled call's block launches > 0, no warmup chunk and a
    (D,) metric; no unit built during the run; every IS-weighted mean
    finite and within 1 sigma of the truth. Returns (the Recipe, the run's
    launch counts)."""
    from bayesfast_tpu_torch import config
    from bayesfast_tpu_torch.examples import wide_recipe as wr
    from bayesfast_tpu_torch.samplers import nuts_cuda as nc
    config.set_dtype(torch.float32)
    config.set_nuts_kernel('cuda')
    bt.utils.set_generator(WIDE_RECIPE_SEED)
    rec = wr.build()
    sigma = wr.analytic_sigma()
    plans, plan_fn = {}, nc._spec_plan

    def recorded(dens_id, dscal, dim, depth, itemsize):
        # each launch's plan (``_launch`` asks for it once a launch)
        plan = plan_fn(dens_id, dscal, dim, depth, itemsize)
        if plan is not None:
            key = (dim, itemsize, _plan_text(plan, dscal, itemsize))
            plans[key] = plans.get(key, 0) + 1
        return plan

    def per_call(out):
        st = out.trace._stats_arrays
        n_w = out.trace.n_warmup
        return (float(st['tree_depth'][:, n_w:].mean()),
                float(st['mean_tree_accept'][:, n_w:].mean()),
                tuple(out.trace._carry.metric.var.shape))

    nc._spec_plan = recorded
    try:
        run = _run_recipe(torch, rec, per_call)
    finally:
        nc._spec_plan = plan_fn
    phases, parts, calls = run['phases'], run['parts'], run['calls']
    res = rec.get()
    w = res.weights_trunc
    mean = np.sum(res.samples * w[:, None], axis=0) / np.sum(w)
    z = np.abs(mean - wr.TRUTH) / sigma
    print(f'[17] wide DES-like Recipe (examples/wide_recipe.py): D={wr.D}, '
          f'N_DATA={wr.N_DATA}, {wr.N_CHAIN} chains, float32, '
          f'nuts_kernel=cuda, Recipe.run() {run["run_s"]:.2f} s: '
          + ', '.join(f'{k} {v:.2f} s' for k, v in phases.items()))
    print('    parts (s): ' + ', '.join(f'{k} {v:.3f}'
                                        for k, v in parts.items()))
    for i, (dt, ln, nt, _, depth, acc, shape) in enumerate(calls):
        step = 'optimize' if i == 0 else f'sample #{i - 1}'
        print(f'    {step}: sample() {dt:.2f} s, launches '
              f'{ {k: v for k, v in ln.items() if v} }, tree-loop '
              f'transitions {nt}, metric variance {shape}; post-warmup tree '
              f'depth {depth:.3f}, accept {acc:.3f}')
    print('    launches (kind, K: launches, device s, ms a transition): '
          + _mix_text(run['mix']))
    for (dim, isz, text), n in plans.items():
        print(f'    plan D={dim} float{8 * isz}, {n} launches: {text}')
    print(f'    n_call {res.n_call}; tree-loop transitions {run["n_tree"]}; '
          f'units built during the run: {sorted(run["built"]) or "none"}')
    print(f'    IS-weighted posterior means - {wr.TRUTH}, in analytic sigma:'
          f' max {z.max():.3f} (gate 1), mean {z.mean():.3f}; sigma '
          f'{sigma.min():.4f}-{sigma.max():.4f}; {smi}')
    x_q = rec.recipe_trace.results.sample[-1].samples
    z_q = np.abs(x_q.mean(0) - wr.TRUTH) / sigma
    ess = np.sum(res.weights) ** 2 / np.sum(res.weights ** 2)
    print(f'    the last step\'s {x_q.shape[0]} draws, unweighted: max '
          f'{z_q.max():.3f} sigma, mean {z_q.mean():.3f}; IS weights: ESS '
          f'{ess:.1f} of {res.weights.size}, max / mean '
          f'{res.weights.max() / res.weights.mean():.3f}, '
          f'{int(np.sum(res.weights_trunc < res.weights))} truncated')
    per_chain_ok = all(ln['nuts_warmup'] > 0 and ln['nuts_multi'] > 0
                       and ln['nuts_block'] == 0 for _, ln, *_ in calls[:-1])
    pooled = calls[-1][1] if calls else {}
    if not (len(calls) == 3 and per_chain_ok and run['n_tree'] == 0
            and all(c[2] == 0 for c in calls)
            and pooled['nuts_block'] > 0 and pooled['nuts_multi'] > 0
            and pooled['nuts_warmup'] == 0 and calls[-1][-1] == (wr.D,)):
        raise AssertionError('[17]: a sample step did not run on the kernels '
                             'as its trace asks (per chain: the chunk '
                             'kernels; pooled: the block kernel, then the '
                             'frozen chunks)')
    if run['built']:
        raise AssertionError(f'[17]: the run built {run["built"]}')
    if not (np.isfinite(mean).all() and z.max() < 1.0):
        raise AssertionError(f'[17]: posterior means off: {z.max()} sigma')
    return rec, run['launches']


def _poly_250(torch, bt, n_chain, seed):
    """[17a] A PolyGaussian density at D = 250 (NE = 8): the wide Recipe's
    Density and sample-step surrogate at 250 parameters (F = 296), fitted
    on WIDE_POLY_FIT points around the truth spread by the analytic
    sigma, the surrogate on; and a seeded float32 state of ``n_chain``
    chains within half a sigma of the truth: the metric the posterior's
    variances in the sampling space (the bound transform's slope at the
    truth), steps of about 0.45 (trees of depth ~4). Returns (density,
    carry)."""
    from types import SimpleNamespace as NS
    from bayesfast_tpu_torch.examples import wide_recipe as wr
    from bayesfast_tpu_torch.samplers.metrics import init_diag_metric
    from bayesfast_tpu_torch.samplers.step_size import init_step_size
    dim = WIDE_POLY_DIMS[1]
    forward, data, _ = wr.make_model(dim)
    den = wr.make_density(forward, data, dim)
    den.surrogate_list = [wr.make_surrogate(dim)]
    sigma = wr.analytic_sigma(dim)
    rng = np.random.default_rng(17)
    x = wr.TRUTH + rng.normal(size=(WIDE_POLY_FIT, dim)) * sigma
    den.fit(den.fun(x, original_space=True, use_surrogate=False))
    den.use_surrogate = True
    rng = np.random.default_rng(seed)
    dev, f32 = torch.device('cuda'), torch.float32
    xo = wr.TRUTH + rng.normal(size=(n_chain, dim)) * sigma * 0.5
    q = torch.as_tensor(den.from_original(xo), dtype=f32, device=dev)
    u = (wr.TRUTH + 5.0) / 10.0     # x = -5 + 10 s(t): dx/dt = 10 u (1 - u)
    var = torch.as_tensor(np.tile((sigma / (10 * u * (1 - u))) ** 2,
                                  (n_chain, 1)), dtype=f32, device=dev)
    eps = torch.as_tensor(np.exp(rng.normal(size=n_chain) * 0.2) * 0.45,
                          dtype=f32, device=dev)
    return den, NS(q=q.contiguous(), metric=init_diag_metric(q, var),
                   step=init_step_size(eps, f32, dev))


def _mvn_plan(torch, bt):
    """[17a] Hoffman & Gelman's MVN-250 written as a Density plan: its
    logp the one module of the plan, traced (``Density._program``)."""
    from bayesfast_tpu_torch.examples.wide_gaussians import mvn_250
    P = torch.as_tensor(mvn_250()[1]['P'])
    return bt.Density(density_name='logp', module_list=[bt.Module(
        fun=lambda x: -0.5 * torch.sum((x @ P.to(x)) * x, dim=-1),
        input_vars='x', output_vars='logp')], input_vars='x',
        input_shapes=[250])


def _wide_plan_kernels(torch, bt, rec, launches, mvn_carry, ptxas, builds,
                       smi):
    """[17a] Each new instantiation's frozen chunk, warmup chunk (K =
    WIDE_K) and block launch against its plain version, bitwise, float32
    and float64: PolyGaussian at NE = 4 on [17]'s last state
    (WIDE_POLY_CHAINS chains), at NE = 8 on a seeded state of a D = 250
    surrogate (``_poly_250``, WIDE_NE8_CHAINS), and MVN-250 as a traced
    Density plan at NE = 8 on [16c]'s final state (MVN_PLAN_CHAINS), these
    two at depth WIDE_CHECK_DEPTH; at NE = 4 also a partial last block
    (WIDE_PARTIAL_CHAINS of [17]'s last state) and a state of mixed tree
    sizes (``_mixed_state``, WIDE_MIXED_CHAINS), both at depth
    WIDE_CHECK_DEPTH;
    each one's plan (past D = 64 with the block-wide bytes of
    ``_block_bytes``), registers and spills; then each timed at 1024
    chains in float32, device only, with its slowest chain and bound, and
    the mixed state's block launch. Returns
    {kernel row: (launches on [17]'s path, max abs error, (ms, plain ms,
    bound ms, bound by))}."""
    from bayesfast_tpu_torch.samplers import nuts_cuda as nc
    from bayesfast_tpu_torch.samplers.metrics import init_diag_metric
    carry_r = rec.recipe_trace.results.sample[-1].sample_trace.trace._carry
    den_8, carry_8 = _poly_250(torch, bt, WIDE_CHAINS, 18)
    small_8 = _poly_250(torch, bt, WIDE_NE8_CHAINS, 19)[1]
    den_m = _mvn_plan(torch, bt)
    prog = den_m.kernel_spec()['program']
    cases = (('wide_recipe', 'PolyGaussian NE=4', rec.density, carry_r,
              _first_chains(carry_r, WIDE_POLY_CHAINS), launches),
             ('poly_ne8', 'PolyGaussian NE=8', den_8, carry_8, small_8, {}),
             ('wide_plan', 'MVN-250 Density plan', den_m, mvn_carry,
              _first_chains(mvn_carry, MVN_PLAN_CHAINS), {}))
    rows = {}
    for key, name, den, carry, small, ln in cases:
        dim = carry.q.shape[1]
        depth = MAX_TREEDEPTH if key == 'wide_recipe' else WIDE_CHECK_DEPTH
        if key == 'wide_plan':
            ops = _traced_leapfrog_ops(prog)
            print(f'[17a] {name}: {len(prog.nodes)} nodes '
                  f'({prog.describe()}), the source of [16]\'s MVN unit: '
                  f'{prog.source(torch.float32) == _mvn_source(torch)}')
        else:
            spec = nc._spec_entry(den, carry.q)[2]
            ops = _poly_leapfrog_ops(dim, spec)
            print(f'[17a] {name}: D={dim}, M={int(spec["scalars"][2])}, '
                  f'F={int(spec["scalars"][3])}, NNZ='
                  f'{int(spec["scalars"][4])}; {ops} operations a leapfrog '
                  f'(_poly_leapfrog_ops)')
        errs, plain32 = {}, {}
        for dt in (torch.float32, torch.float64):
            tag = str(dt)[6:]
            n_c = small.q.shape[0]
            if key == 'wide_plan':
                plan, label = _tile_plan(prog, dt.itemsize), f'mvn_250 {tag}'
            else:
                dens_id, _, _, _, dscal = nc._spec_for(den, small.q.to(dt))
                plan = _plan_text(nc._spec_plan(
                    dens_id, dscal, dim, MAX_TREEDEPTH, dt.itemsize), dscal,
                    dt.itemsize, dim)
                label = f'poly D={dim} {tag}'
            print(f'[17a] {name} {tag}: plan: {plan}; kernels '
                  f'{_ptxas_text(ptxas, label)}; built in {builds[label]}')
            print(f'[17a] {name} kernels vs plain, C={n_c}, K={WIDE_K}, '
                  f'depth {depth}, {tag}')
            e, plain_ms = _chunks_vs_plain(torch, den, small, dt, name,
                                           f'_{key}', block=True, k=WIDE_K,
                                           depth=depth)
            for k, v in e.items():
                errs[k] = max(errs.get(k, 0.0), v)
            if dt == torch.float32:
                plain32 = plain_ms
        extra = ()
        if key == 'wide_recipe':
            # a partial last block (warps with no chain), and a state whose
            # trees differ widely in size (warps idle early, one chain of a
            # block on alone), each kernel bitwise in both dtypes
            mixed = _mixed_state(torch, carry_r, WIDE_MIXED_CHAINS)
            extra = (('partial last block',
                      _first_chains(carry_r, WIDE_PARTIAL_CHAINS),
                      WIDE_CHECK_DEPTH),
                     ('mixed tree sizes', mixed, WIDE_CHECK_DEPTH))
        for what, st, dep in extra:
            for dt in (torch.float32, torch.float64):
                print(f'[17a] {name}, {what}: kernels vs plain, '
                      f'C={st.q.shape[0]}, K={WIDE_K}, depth {dep}, '
                      f'{str(dt)[6:]}')
                e, _ = _chunks_vs_plain(torch, den, st, dt, f'{name} {what}',
                                        f'_{key}', block=True, k=WIDE_K,
                                        depth=dep)
                for k, v in e.items():
                    errs[k] = max(errs.get(k, 0.0), v)
        C = carry.q.shape[0]
        times = _time_chunks(torch, den, carry, plain32, ops, f'_{key}',
                             k=WIDE_K, timer=_device_ms)[0]
        metric = init_diag_metric(carry.q,
                                  nc._mat(carry.metric.var, C, dim, carry.q))
        times[f'nuts_block_{key}'] = _time_block(
            torch, den, carry.q, metric, torch.exp(carry.step.log_bar),
            plain32[f'nuts_block_{key}'], ops, tag=f'  nuts_block_{key}',
            timer=_device_ms)[0]
        if extra:
            # the mixed state's block launch: its slowest chain runs on
            # alone, with the whole block
            Cm = mixed.q.shape[0]
            _time_block(torch, den, mixed.q, init_diag_metric(
                mixed.q, nc._mat(mixed.metric.var, Cm, dim, mixed.q)),
                torch.exp(mixed.step.log_bar), None, ops,
                tag=f'  nuts_block_{key}, mixed tree sizes, C={Cm}',
                timer=_device_ms)
        print(f'  {name}: timed at C={C} float32, plain ms at '
              f'C={small.q.shape[0]}; {smi}')
        for kind in ('nuts_multi', 'nuts_warmup', 'nuts_block'):
            k = f'{kind}_{key}'
            rows[k] = (ln.get(kind, 0), errs[k], times[k])
    return rows


def _mixed_state(torch, carry, n):
    """[17a] A state of ``n`` chains whose trees differ widely in size:
    [17]'s last draws (``carry``), and in every block of eight one chain
    at a tenth of its step (a long tree, which a block's other chains
    leave to run on alone) and two moved beyond the surrogate's bound
    (+-2 in every transformed coordinate)."""
    from types import SimpleNamespace as NS
    from bayesfast_tpu_torch.samplers import nuts_cuda as nc
    from bayesfast_tpu_torch.samplers.metrics import init_diag_metric
    from bayesfast_tpu_torch.samplers.step_size import init_step_size
    c = _first_chains(carry, n)
    q = c.q.clone()
    C, dim = q.shape
    var = nc._mat(c.metric.var, C, dim, q)
    eps = nc._row(torch.exp(c.step.log_bar), C, q).clone()
    q[1::8] += 2.0
    q[2::8] -= 2.0
    eps[0::8] *= 0.1
    return NS(q=q.contiguous(), metric=init_diag_metric(q, var),
              step=init_step_size(eps, q.dtype, q.device))


def _mvn_source(torch):
    """The float32 source of [16]'s MVN-250 unit (the DensityLite's)."""
    from bayesfast_tpu_torch.examples.wide_gaussians import mvn_250
    return mvn_250()[0].kernel_spec()['program'].source(torch.float32)


def _wall(walls, tag, t0):
    """Record in ``walls`` and print the wall of phase ``tag``, started at
    ``t0``; returns the time now (the next phase's start)."""
    now = time.time()
    walls[tag] = now - t0
    print(f'    {tag} wall {walls[tag]:.1f} s', flush=True)
    return now


def _ptxas_table(log):
    """Registers, stack frame and spill bytes of each kernel in an ``nvcc
    -Xptxas -v`` log, by a short name read off the mangled one: {name:
    (registers, stack frame bytes, spill store bytes, spill load
    bytes)}."""
    import re
    out, cur, entry = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\w+)", line)
        pb = m and re.search(r'PolyBlockI([fd])Li(\d)ELb([01])EE4eval',
                             m.group(1))
        if pb and m.group(1) != entry:
            # PolyBlock's evaluation, a function of its own (__noinline__)
            cur = (f'PolyBlock::eval {"f32" if pb.group(1) == "f" else "f64"}'
                   f' NE={pb.group(2)}' + (' streamed' if pb.group(3) == '1'
                                            else ''))
            out[cur] = [None, None, None, None]
            continue
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mn = entry = m.group(1)
            kern = re.search(r'nuts_chunk_kernel|nuts_block_kernel', mn)
            name = kern.group(0) if kern else mn
            dens = re.search(r'(PolyBlock|PolyGaussian|Banana|Gaussian|Funnel|'
                             r'Ring|Cauchy|Traced)', mn)
            dt = re.search(r'kernelI([fd])Li(\d)E', mn)
            parts = [name]
            if dt:
                parts += [{'f': 'f32', 'd': 'f64'}[dt.group(1)],
                          f'NE={dt.group(2)}']
            if dens:
                parts.append(dens.group(1))
            if re.search(r'Poly(?:Gaussian|Block)I[fd]Li\dELb1E', mn):
                parts.append('streamed')
            if name == 'nuts_chunk_kernel':
                # the kernel's own flag: the last template argument
                warm = re.search(r'Lb([01])EEEv', mn)
                parts.append('warmup' if warm and warm.group(1) == '1'
                             else 'frozen')
            cur = ' '.join(parts)
            out[cur] = [None, None, None, None]
            continue
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                      r'(\d+) bytes spill loads', line)
        if m and cur:
            out[cur][1:] = [int(v) for v in m.groups()]
        m = re.search(r'Used (\d+) registers', line)
        if m and cur:
            out[cur][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def _check_registers(traced=None):
    """[2b] Registers and spills of every NUTS kernel, from the ``-Xptxas
    -v`` output kept beside the library in use; fails if there is none, or
    if a PolyGaussian, Funnel, Ring or Cauchy instantiation spills, other
    than float64 at D > 32 (NE=2), where the transition's own state fills
    the 255 registers (as it did for PolyGaussian before the coefficients
    were staged). ``traced`` ({label: generated source}, [14]'s and
    [15]'s units): each one's three kernels too, from its own build's
    output; a traced instantiation must not spill in float32, nor in
    float64 at NE = 1. Returns {label: its table}."""
    from bayesfast_tpu_torch import _build
    log = _build.build_log('nuts')
    if log is None:
        raise AssertionError('no compiler output beside the NUTS library')
    table = _ptxas_table(log)
    print('[2b] NUTS kernels, -Xptxas -v (registers, stack frame, spill '
          'stores, spill loads; bytes):')
    for k in sorted(table):
        print(f'    {k:52s} {table[k]}')
    gated = ('PolyGaussian', 'Funnel', 'Ring', 'Cauchy')
    spills = [k for k, v in table.items()
              if any(g in k for g in gated) and (v[2] or v[3])]
    print(f'    {", ".join(gated)} instantiations that spill: {spills}')
    bad = [k for k in spills if 'f64 NE=2' not in k]
    if bad or not all(any(g in k for k in table) for g in gated):
        raise AssertionError(f'instantiations spill: {bad}')
    tables = {}
    for label, src in (traced or {}).items():
        log = _build.build_log(source=src)
        if log is None:
            raise AssertionError(f'no compiler output beside the traced '
                                 f'library of {label}')
        tables[label] = _ptxas_table(log)
        print(f'[2b] traced {label}:')
        for k in sorted(tables[label]):
            print(f'    {k:52s} {tables[label][k]}')
        if len(tables[label]) != 3:
            raise AssertionError(f'traced {label}: {len(tables[label])} '
                                 'kernels, not 3')
        bad = [k for k, v in tables[label].items()
               if ('f32' in k or 'NE=1' in k) and (v[2] or v[3])]
        if bad:
            raise AssertionError(f'traced {label}: spills {bad}')
    return tables


class _SpecDensity:
    """A density that is only a kernel spec, built by the checkout in use
    from a Recipe's saved surrogate (``Density._kernel_sources``) and
    transform, so that every process of an A/B launches the same
    surrogate, each in its own checkout's packing."""
    has_kernel_spec = True

    def __init__(self, sources, transform):
        from bayesfast_tpu_torch.ops.densities import poly_gaussian_spec
        src = {k: v for k, v in sources.items()
               if not (k == 'scales' and v is None)}
        self._spec = poly_gaussian_spec(**src)
        self._spec['transform'] = transform

    def kernel_spec(self):
        return self._spec

    def kernel_spec_key(self):
        return 'saved'


def _cast(obj, dtype):
    """A carry (nested NamedTuples of tensors) with its float tensors cast
    to ``dtype``."""
    import torch
    if torch.is_tensor(obj):
        return obj.to(dtype) if obj.is_floating_point() else obj
    if isinstance(obj, tuple) and hasattr(obj, '_fields'):
        return type(obj)(*(_cast(v, dtype) for v in obj))
    return obj


def _first_chains(obj, n):
    """A carry with every per-chain tensor (leading axis the chains) cut to
    its first ``n`` chains."""
    import torch
    if isinstance(obj, tuple) and hasattr(obj, '_fields'):
        return type(obj)(*(_first_chains(v, n) for v in obj))
    if torch.is_tensor(obj) and obj.dim() and obj.shape[0] == DES_CHAINS:
        return obj[:n].contiguous()
    return obj


def _tiled_chains(obj, n, chains=None):
    """A carry of ``chains`` chains (default: its positions') with every
    per-chain tensor (leading axis the chains) taken at chains 0, 1, ..
    repeated to ``n`` chains."""
    import torch
    chains = obj.q.shape[0] if chains is None else chains
    if isinstance(obj, tuple) and hasattr(obj, '_fields'):
        return type(obj)(*(_tiled_chains(v, n, chains) for v in obj))
    if torch.is_tensor(obj) and obj.dim() and obj.shape[0] == chains:
        idx = torch.arange(n, device=obj.device) % chains
        return obj[idx].contiguous()
    return obj


def _tensors(obj):
    """Every tensor in ``obj`` (tuples, NamedTuples, dicts), in order."""
    import torch
    if torch.is_tensor(obj):
        return [obj]
    if isinstance(obj, dict):
        return [t for k in sorted(obj) for t in _tensors(obj[k])]
    if isinstance(obj, (tuple, list)):
        return [t for v in obj for t in _tensors(v)]
    return []


def _digest(obj):
    """A hash of the bytes of an array or of every tensor in ``obj``: equal
    digests are bitwise equal outputs."""
    import hashlib
    h = hashlib.sha256()
    arrays = [obj] if isinstance(obj, np.ndarray) else [
        t.detach().cpu().numpy() for t in _tensors(obj)]
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _poly_plans(torch, den, carry):
    """[10b] The shared-memory plan of each PolyGaussian launch (the
    launch fails if the kernel library lays a block out otherwise), and
    one K = 2 chunk of each kernel under it on the last sample step's
    state: float32 under its plan (all of WT and the stacks), with half of
    WT (36 of 73 features), each chain reading the rest or streamed in
    tiles of 16, and with no feature staged; float64 under its plan
    (streamed tiles), with the same rows each chain reading the rest
    (the parent's path) and with no feature. Every variant's outputs must
    equal its dtype's plan's bit for bit. Returns {label: slowest
    chain}."""
    from bayesfast_tpu_torch.samplers import nuts_cuda as nc
    spec = nc._spec_entry(den, carry.q)[2]
    F = int(spec['scalars'][3])
    ops = _poly_leapfrog_ops(DES_D, spec)
    plan_fn = nc._spec_plan

    def rows(r, tile=0):  # the layout with the first r features staged
        return lambda dens_id, sc, dim, depth, itemsize: nc._poly_layout(
            dim, *(int(v) for v in sc[2:5]), bool(sc[9]), depth, itemsize,
            r, tile)

    def untiled(dens_id, sc, dim, depth, itemsize):
        return nc.poly_smem_plan(dim, *(int(v) for v in sc[2:5]),
                                 bool(sc[9]), depth, itemsize, 0)

    variants = ((torch.float32, 'plan', plan_fn),
                (torch.float32, 'half of WT', rows(F // 8 * 4)),
                (torch.float32, 'half of WT, tiles of 16',
                 rows(F // 8 * 4, 16)),
                (torch.float32, 'no features', rows(0)),
                (torch.float64, 'plan', plan_fn),
                (torch.float64, 'no tiles', untiled),
                (torch.float64, 'no features', rows(0)))
    firsts, chains = {}, {}
    try:
        for dt, label, plan_of in variants:
            nc._spec_plan = plan_of
            c = _cast(carry, dt)
            dens_id, _, _, _, dscal = nc._spec_for(den, c.q)
            plan = plan_of(dens_id, dscal, c.q.shape[1], MAX_TREEDEPTH,
                           c.q.element_size())
            tag = f'{str(dt)[6:]} {label}'
            print(f'  plan {tag}: '
                  f'{_plan_text(plan, dscal, c.q.element_size())}')
            _, ch, outs = _time_chunks(torch, den, c, ops=ops,
                                       suffix=f'_poly {tag}')
            chains.update(ch)
            first = firsts.setdefault(dt, outs)
            same = all(all(torch.equal(a, b) for a, b in zip(
                _tensors(outs[k]), _tensors(first[k]))) for k in outs)
            print(f'  {tag}: outputs bitwise equal to the plan\'s: {same}')
            if not same:
                raise AssertionError(f'the {tag} plan changes the draws')
    finally:
        nc._spec_plan = plan_fn
    return chains


def _ab_one(tree, state, out_path, n_seeds):
    """One process of the A/B: the checkout at ``tree`` measured as
    ``main`` measures it, its readings written to ``out_path``; the first
    process saves the inputs of the timed phases to ``state``."""
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device.')
    import bayesfast_tpu_torch as bt
    from bayesfast_tpu_torch import _build, config
    from bayesfast_tpu_torch.examples.user_densities import DENSITIES
    from bayesfast_tpu_torch.ops import kde as tk
    assert os.path.dirname(os.path.dirname(bt.__file__)) == tree
    warnings.filterwarnings('ignore', message='for chain #')
    _build.build_library()
    config.set_dtype(torch.float32)
    config.set_nuts_kernel('cuda')
    A, den = _bench_density(torch.float32)
    # each library's nvcc seconds where this process built it (the first
    # process of a checkout)
    res = {'tree': tree, 'device': torch.cuda.get_device_name(0),
           'nvidia_smi': _nvidia_smi(),
           'nvcc_s': dict(getattr(_build, 'last_build_walls', {}))}
    tt, _, res['chain'] = _sample_path(
        torch, bt, den, A, '[3]', {'nuts_warmup': 1 + 4 * 2,
                                   'nuts_multi': 3 * 2})
    tp, _, res['pooled'] = _sample_path(
        torch, bt, den, A, '[8]', {'nuts_block': N_WARMUP,
                                   'nuts_multi': 3 * 2}, pooled_metric=True)
    rec, _, res['recipe'] = _des_recipe(torch, bt)
    rec_c, _, res['recipe_cubic'] = _des_recipe(torch, bt, cubic=True)
    res['digests'] = {'draws [3]': _digest(tt.trace.samples),
                      'draws [8]': _digest(tp.trace.samples)}
    for tag, r in (('[10]', res['recipe']), ('[13]', res['recipe_cubic'])):
        res['digests'][f'n_call, max IS deviation {tag}'] = '%d, %r' % (
            r['n_call'], r['max_dev_sigma'])
    if not os.path.exists(state):
        saved = {'carry': tt.trace._carry, 'pooled': tp.trace._carry,
                 'draws': tt.get(flatten=False)}
        for k, r in (('poly', rec), ('cubic', rec_c)):
            saved[k + '_src'] = r.density._kernel_sources()
            saved[k + '_tf'] = r.density.kernel_spec()['transform']
            saved[k + '_carry'] = \
                r.recipe_trace.results.sample[-1].sample_trace.trace._carry
        saved['mvn_carry'] = _mvn_state(torch, bt)
        torch.save(saved, state)
    st = torch.load(state, weights_only=False)
    res.update(_time_chunks(torch, den, st['carry'])[1])
    # [10b]'s PolyGaussian chunks and [13b]'s cubic ones on the saved
    # surrogates and states, float32 (the Recipes') and float64
    for k, tag in (('poly', '[10b]'), ('cubic', '[13b]')):
        den_p = _SpecDensity(st[k + '_src'], st[k + '_tf'])
        for dt, suffix in ((torch.float32, f'_{k}'),
                           (torch.float64, f'_{k}64')):
            _, chains, outs = _time_chunks(
                torch, den_p, _cast(st[k + '_carry'], dt),
                ops=_poly_leapfrog_ops(DES_D, den_p.kernel_spec()),
                suffix=suffix)
            res.update(chains)
            res['digests'].update({f'{n}{suffix} outputs {tag}': _digest(v)
                                   for n, v in outs.items()})
    # [12]'s instantiations: each anchor's frozen and warmup chunk on a
    # seeded state, float64
    for name, dim, _ in ANCHORS:
        res['digests'][f'{name} chunk outputs [12]'] = _digest(
            _anchor_chunks(torch, name))
    # [14]'s traced banana the same way: the tracer must keep its program
    res['digests']['traced banana chunk outputs [14]'] = _digest(
        _seeded_chunks(torch, DENSITIES['bench_banana']()[0]))
    # [16a]'s MVN-250 kernels on the saved float32 state at 1024 chains
    chains, digests, res['mvn_ptxas'], res['mvn_l2_bytes'] = _mvn_timed(
        torch, st['mvn_carry'])
    res.update(chains)
    res['digests'].update(digests)
    res['nuts_block'] = _time_block(
        torch, den, *_block_inputs(torch, st['pooled'], torch.float32))[1]
    x, data, w, h = _kde_inputs(torch, st['draws'], torch.float32)
    res['kde_ms'] = _time_ms(torch, lambda: tk.kde_cdf_batch(x, data, w, h),
                             10)[0]
    res['pooled_ms'], res['busy_share'] = _pooled_step_share(
        torch, den, st['pooled'], 50)
    res['gbs'] = []
    for seed in range(n_seeds):
        bt.utils.set_generator(seed)
        # n_q as [6] sizes it on the trace (f_call x calls, capped)
        logz, err = bt.evidence.GBS(n_q=N_Q_MAX)(st['draws'], den.logp)
        res['gbs'].append((float(logz), float(err)))
    # the other rows of the per-warp leaf, on the device alone: the traced
    # banana's chunks on [3]'s state and Neal-100's on a seeded one
    # (float32, 1024 chains)
    from bayesfast_tpu_torch.examples.wide_gaussians import neal_100
    res.update(_time_chunks(torch, DENSITIES['bench_banana']()[0],
                            st['carry'], suffix='_traced',
                            timer=_device_ms)[1])
    res.update(_time_chunks(torch, neal_100()[0], _neal_state(torch),
                            ops=_gaussian_leapfrog_ops(100), suffix='_neal',
                            timer=_device_ms)[1])
    # [12]'s anchor runs (n_call, logz, rhat_max and the draws bitwise; the
    # chunk kernels' device seconds), then each anchor's K = 2 chunks on the
    # run's final state in float64 and float32, and its user form's
    # (traced) in float64, on the device alone
    res['anchors'] = {}
    for name, dim, jax_ncall in ANCHORS:
        den_a, carry_a, _, r = _anchor_run(torch, bt, name, jax_ncall)
        res['anchors'][name] = r
        res['digests'][f'{name} run [12]: n_call, logz, rhat, draws'] = \
            '%d, %r, %r, %s' % (r['n_call'], r['logz'], r['rhat_max'],
                                r['draws'])
        ops = _anchor_leapfrog_ops(name, dim)
        for dt, sfx, peak in ((torch.float64, '', PEAK_FP64),
                              (torch.float32, '32', PEAK_FP32)):
            res.update(_time_chunks(torch, den_a, _cast(carry_a, dt),
                                    ops=ops, suffix=f'_{name}{sfx}',
                                    peak=peak, timer=_device_ms)[1])
        res.update(_time_chunks(torch, DENSITIES[name]()[0], carry_a,
                                ops=ops, suffix=f'_{name}_traced',
                                peak=PEAK_FP64, timer=_device_ms)[1])
    with open(out_path, 'w') as f:
        json.dump(res, f, indent=1)


def _neal_state(torch):
    """A carry of WIDE_CHAINS chains of Neal-100 (float32) drawn from its
    target with a seeded generator, under its own variances (the target
    is then a standard normal to the sampler) and a step of 0.5: the A/B's
    state for the Gaussian's chunks."""
    import types
    from bayesfast_tpu_torch.samplers.metrics import init_diag_metric
    from bayesfast_tpu_torch.samplers.step_size import init_step_size
    sd = 0.01 * np.arange(1, 101)
    rng = np.random.default_rng(100)
    q = torch.as_tensor(rng.normal(size=(WIDE_CHAINS, 100)) * sd,
                        dtype=torch.float32, device='cuda')
    var = torch.as_tensor(np.broadcast_to(sd ** 2, (WIDE_CHAINS, 100)),
                          dtype=torch.float32, device='cuda').contiguous()
    eps = torch.full((WIDE_CHAINS,), 0.5, dtype=torch.float32, device='cuda')
    return types.SimpleNamespace(q=q, metric=init_diag_metric(q, var),
                                 step=init_step_size(eps))


def _anchor_chunks(torch, name):
    """A frozen and a warmup K = 2 chunk (float64, 64 chains) with the
    compiled-in anchor density ``name`` on a state drawn from a seeded
    generator: the A/B's check that [12]'s instantiations keep their
    draws. Returns the two chunks' outputs."""
    from bayesfast_tpu_torch import interop
    return _seeded_chunks(torch, getattr(interop, f'{name}_density')()[0])


def _seeded_chunks(torch, den):
    """A frozen and a warmup K = 2 chunk (float64, 64 chains) with ``den``
    on a state drawn from a generator seeded by its dimension; returns the
    two chunks' outputs."""
    from bayesfast_tpu_torch.samplers import nuts_cuda as nc
    from bayesfast_tpu_torch.samplers.metrics import init_diag_metric
    from bayesfast_tpu_torch.samplers.step_size import init_step_size
    dim = den.input_size
    rng = np.random.default_rng(dim)
    q = torch.as_tensor(rng.normal(size=(64, dim)) * 0.3, device='cuda')
    var = torch.as_tensor(np.exp(rng.normal(size=(64, dim)) * 0.2),
                          device='cuda')
    eps = torch.as_tensor(np.exp(rng.normal(size=64) * 0.2) * 0.1,
                          device='cuda')
    metric = init_diag_metric(q, var)
    frozen = nc.nuts_chunk_batched(11, q, metric, eps, K_CMP, MAX_TREEDEPTH,
                                   MAX_CHANGE, density=den, i0=5)
    wsched, _ = nc._window_schedule(4, 0, 5, K_CMP, 1, True)
    warm = nc.nuts_warmup_chunk_batched(
        11, q, init_step_size(eps), metric, K_CMP, MAX_TREEDEPTH,
        MAX_CHANGE, 0.8, 0.05, 0.75, 10., True, True, wsched, density=den,
        i0=5)
    return frozen, warm


def _ab_readings(res):
    """The readings of one A/B process, by name."""
    out = {'warmup it/s [3]': res['chain']['warmup_its'],
           'post it/s [3]': res['chain']['post_its'],
           'pooled warmup it/s [8]': res['pooled']['warmup_its'],
           'kde ms [7]': res['kde_ms'],
           'ms per pooled transition [8d]': res['pooled_ms'],
           'busy share [8d]': res['busy_share']}
    rows = ['nuts_block', 'nuts_multi', 'nuts_warmup', 'nuts_multi_poly',
            'nuts_warmup_poly', 'nuts_multi_poly64', 'nuts_warmup_poly64',
            'nuts_multi_cubic', 'nuts_warmup_cubic', 'nuts_multi_cubic64',
            'nuts_warmup_cubic64', 'nuts_multi_wide_mvn',
            'nuts_warmup_wide_mvn', 'nuts_block_wide_mvn']
    rows += [f'{kind}_{sfx}' for sfx in (
        'traced', 'neal', *[f'{a}{t}' for a, _, _ in ANCHORS
                            for t in ('', '32', '_traced')])
             for kind in ('nuts_multi', 'nuts_warmup')]
    for k in rows:
        for f in ('ms', 'max_leapfrogs', 'mean_leapfrogs', 'ns_per_leapfrog'):
            out[f'{k} {f}'] = res[k][f]
    for a, r in res['anchors'].items():
        for f in ('warmup_kernels_s', 'frozen_kernels_s', 'kernels_s',
                  'warmup_host_s', 'post_host_s'):
            out[f'{a} run [12] {f}'] = r[f]
    for k, tag in (('recipe', '[10]'), ('recipe_cubic', '[13]')):
        out[f'recipe n_call {tag}'] = res[k]['n_call']
        out[f'recipe max IS dev, sigma {tag}'] = res[k]['max_dev_sigma']
        out[f'recipe chunk kernels s {tag}'] = res[k]['kernels_s']
    out['MVN-250 L2 bytes a leapfrog and block'] = res['mvn_l2_bytes']
    logz = np.array([z for z, _ in res['gbs']])
    if len(logz) > 1:
        out['gbs logz, mean over seeds'] = float(logz.mean())
        out['gbs logz, sd over seeds'] = float(logz.std(ddof=1))
    return out


def _ab(parent, work, n_seeds):
    """Parent, this checkout, this checkout, parent; then the table.
    Exits 1 if this checkout's build spills ([2b]) or an output that must
    not change differs."""
    from bayesfast_tpu_torch import _build
    _build.build_library()  # this checkout's processes reuse the build
    nvcc = dict(_build.last_build_walls)
    try:
        _check_registers()
        spills = None
    except AssertionError as exc:  # measured all the same, and then fails
        spills = exc
        print(f'[2b] {exc}')
    os.makedirs(work, exist_ok=True)
    state = os.path.join(work, 'state.pt')
    if os.path.exists(state):
        os.unlink(state)
    runs = []
    for i, tree in enumerate((parent, _REPO, _REPO, parent)):
        out = os.path.join(work, f'run{i}.json')
        print(f'[run {i}] {tree}', flush=True)
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        '--ab-one', tree, state, out, '--gbs-seeds',
                        str(n_seeds)], check=True, stdout=subprocess.DEVNULL)
        with open(out) as f:
            runs.append(json.load(f))
    os.unlink(state)
    print(f'device: {runs[0]["device"]}; nvidia-smi: {runs[0]["nvidia_smi"]}')
    rows = [_ab_readings(r) for r in runs]
    print(f'{"reading":34s} {"parent 0":>12s} {"change 1":>12s} '
          f'{"change 2":>12s} {"parent 3":>12s} {"parent/change":>13s}')
    for k in rows[0]:
        v = [r[k] for r in rows]
        ratio = ((v[0] + v[3]) / (v[1] + v[2])
                 if None not in v and v[1] + v[2] else float('nan'))
        print(f'{k:34s} ' + ' '.join(f'{x:12.4f}' if x is not None
                                     else f'{"-":>12s}' for x in v)
              + f' {ratio:13.3f}')
    for i, r in enumerate(runs):
        print(f'gbs run {i}: ' + ', '.join(f'{z:.4f} +- {e:.4f}'
                                           for z, e in r['gbs']))
    # nvcc seconds of each library, each checkout built alone: the parent
    # in its first process, this checkout before the runs
    print(f'nvcc (s), each checkout built alone: parent '
          f'{ {k: round(v, 1) for k, v in runs[0].get("nvcc_s", {}).items()} }'
          f', this checkout { {k: round(v, 1) for k, v in nvcc.items()} }')
    # MVN-250's float32 unit: registers, stack frame and spills, before
    # (the parent) and after
    for i in (0, 1):
        print(f'MVN-250 float32 unit, {("parent", "change")[i]} ([2b]):')
        for k, v in sorted(runs[i]['mvn_ptxas'].items()):
            print(f'    {k:52s} {tuple(v)}')
    # outputs that the change must leave bit for bit as they were
    differ = 0
    for k in runs[0]['digests']:
        v = [r['digests'][k] for r in runs]
        same = len(set(v)) == 1
        differ += not same
        verdict = 'bitwise equal in all four runs' if same else 'DIFFER'
        print(f'{k:40s} {verdict}: {v[0] if same else v}')
    if spills is not None:
        print(f'[2b] {spills}')
    return 1 if differ or spills is not None else 0


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run.', file=sys.stderr)
        return 1
    sys.path.insert(0, _REPO)
    import bayesfast_tpu_torch as bt
    from bayesfast_tpu_torch import _build, config

    # sample() warns once per chain whose post-warmup acceptance is off
    # target (1024 lines a call); the divergence and depth warnings stay
    warnings.filterwarnings('ignore', message='for chain #')
    name = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f'[1] device: {name}; nvidia-smi: {smi}')
    print(f'    torch {torch.__version__}, CUDA {torch.version.cuda}')

    t_run = t_phase = time.time()
    walls = {}  # each phase's wall, in the order run
    # [11c] and [11d] launch no kernel: a process of their own beside [2]
    # and [11a]
    samplers = _Process('--free-samplers')

    # ---- [2] build: one nvcc per source, in parallel, the units that
    # [14]'s traced densities and [15]'s donut plans generate too; in the
    # background, beside the samplers of [11] that launch no kernel ----
    traced_dens, traced_srcs = _traced_sources(torch)
    user_dens, user_srcs = _user_grad_sources(torch)
    traced_srcs.update(user_srcs)
    donut_srcs = _donut_sources(torch)
    traced_srcs.update(donut_srcs)
    wide_dens, wide_srcs = _wide_sources(torch)
    build = _Background(lambda: _build.build_library(
        sources=list(traced_srcs.values()) + list(wide_srcs.values())))
    t_phase = _wall(walls, '[2] sources', t_phase)

    # ---- [11a] HMC (plain torch on the card) beside the build and the
    # process of [11c] and [11d] ----
    config.set_dtype(torch.float32)
    config.set_nuts_kernel('cuda')
    A, den = _bench_density(torch.float32)
    _hmc(torch, bt, den, A)
    samplers.join()
    t_phase = _wall(walls, '[11a, c, d]', t_phase)

    paths = build.join()
    print(f'[2] built {[os.path.relpath(p, _REPO) for p in paths.values()]}'
          f' in {_build.last_build_seconds:.1f} s, beside [11a, c, d]; '
          f'each nvcc (s): '
          f'{ {k: round(v, 1) for k, v in _build.last_build_walls.items()} }')
    builds = {}  # each generated unit's nvcc wall, by its label
    for label, src in {**traced_srcs, **wide_srcs}.items():
        stem = os.path.basename(_build.traced_path(src))[6:-3]
        w = _build.last_build_walls.get(stem)
        builds[label] = 'reused, not built' if w is None else f'{w:.1f} s'
        print(f'    traced {label}: {stem}, nvcc {builds[label]}')
    for lib in _build.LIBRARIES:
        _build.load_library(lib)
    for src in {**traced_srcs, **wide_srcs}.values():
        _build.load_traced(src)
    ptxas = _check_registers(traced_srcs)
    ptxas.update(_unit_registers(wide_srcs))
    # [17]'s PolyGaussian units build beside [3]-[9], whose host-bound
    # phases leave the cores to nvcc
    poly_srcs = _wide_poly_sources(torch)
    poly_build = _Background(lambda: _build_walls(poly_srcs))
    t_phase = _wall(walls, '[2] after [11a, c, d]', t_phase)

    # ---- [3] the sampling path at bench.py's configuration (the port's
    # default device is the card) ----
    nuts_path = os.path.join(_smoke_dir(), 'nuts_warmup.pkl')
    tt, launches, rates3 = _sample_path(torch, bt, den, A, '[3] main path',
                                        {'nuts_warmup': 1 + 4 * 2,
                                         'nuts_multi': 3 * 2},
                                        checkpoint=nuts_path)
    t_phase = _wall(walls, '[3]', t_phase)

    # ---- [3b] known moments: a bounded diag Gaussian through the kernels
    mean, var_g, den_g = _diag_gaussian(torch, bt)
    tg = bt.sample(den_g, bt.NTrace(n_chain=N_CHAIN, n_iter=300,
                                    n_warmup=150, random_generator=3),
                   verbose=False)
    _gaussian_gate(tg.get(), mean, var_g, '[3b]')
    t_phase = _wall(walls, '[3b]', t_phase)

    # ---- [4] each kernel against its plain version, on the main path's
    # final state ----
    print(f'[4] kernel vs plain, C=1024, D=32, K={K_CMP}, bench banana '
          'with bounds')
    carry = tt.trace._carry
    errs64 = _kernel_vs_plain(torch, den, carry, torch.float64)[0]
    errs32, plain32 = _kernel_vs_plain(torch, den, carry, torch.float32)
    t_phase = _wall(walls, '[4]', t_phase)

    # ---- [5] one chunk: kernel time beside the plain version's ----
    print('[5] chunk timing (CUDA events)')
    times = _time_chunks(torch, den, tt.trace._carry, plain32)[0]
    print(f'    max abs err float64 {errs64}, float32 {errs32}')
    t_phase = _wall(walls, '[5]', t_phase)

    # ---- [6] the evidence path: GBS on the sampling path's trace ----
    launches['kde_cdf'] = _gbs_on_trace(bt, tt, den)
    _device_share(torch, '[6b] profiled GBS',
                  lambda: bt.evidence.GBS(f_call=F_CALL, n_q_max=N_Q_MAX)(
                      tt, den.logp))
    t_phase = _wall(walls, '[6]', t_phase)

    # ---- [7] the KDE kernel against its plain version ----
    print('[7] KDE kernel vs plain, SIT fit shape')
    errs32['kde_cdf'], times['kde_cdf'] = _kde_vs_plain(torch, tt)
    t_phase = _wall(walls, '[7]', t_phase)

    # ---- [8] pooled-metric sampling: warmup on the block kernel, one
    # launch per transition, post-warmup on the frozen chunks ----
    tp, pooled, _ = _sample_path(torch, bt, den, A, '[8] pooled main path',
                                 {'nuts_block': N_WARMUP,
                                  'nuts_multi': 3 * 2}, pooled_metric=True)
    launches['nuts_block'] = pooled['nuts_block']
    var_shape = tuple(tp.trace._carry.metric.var.shape)
    print(f'    shared metric variance shape {var_shape}')
    if var_shape != (D,):
        raise AssertionError(f'pooled variance of shape {var_shape}')
    t_phase = _wall(walls, '[8]', t_phase)

    # ---- [8b] the block kernel against its plain version ----
    print('[8b] block kernel vs plain, C=1024, D=32, pooled final state')
    carry = tp.trace._carry
    errs64['nuts_block'] = _block_vs_plain(torch, den, carry,
                                           torch.float64)[0]
    errs32['nuts_block'], plain32 = _block_vs_plain(torch, den, carry,
                                                    torch.float32)
    print(f'    max abs err float64 {errs64["nuts_block"]}, float32 '
          f'{errs32["nuts_block"]}')

    # ---- [8c] one block launch: kernel time beside the plain version's
    times['nuts_block'] = _time_block(
        torch, den, *_block_inputs(torch, carry, torch.float32), plain32)[0]
    _pooled_step_share(torch, den, carry, 50)
    t_phase = _wall(walls, '[8b]-[8d]', t_phase)

    # ---- [9] the full metric on the torch tree loop ----
    _tree_loop(torch, bt)
    t_phase = _wall(walls, '[9]', t_phase)

    # ---- [2c] the PolyGaussian units past D = 64, built since [2] ----
    _poly_units(poly_build.join(), poly_srcs, ptxas, builds)
    t_phase = _wall(walls, '[2c]', t_phase)

    # ---- [10] the DES-like Recipe at full width, every sample step on the
    # chunk kernels with the compiled-in PolyGaussian density ----
    rec, des_launches, _ = _des_recipe(torch, bt)
    launches['nuts_multi_poly'] = des_launches['nuts_multi']
    launches['nuts_warmup_poly'] = des_launches['nuts_warmup']
    t_phase = _wall(walls, '[10]', t_phase)

    # ---- [10b] the PolyGaussian chunk kernels against their plain
    # versions, then timed, on the last sample step's state ----
    print(f'[10b] PolyGaussian chunk kernels vs plain, C={DES_CHAINS}, '
          f'D={DES_D}, M={DES_N_DATA}, K={K_CMP}, step-2 coefficients')
    den_p = rec.density
    carry_p = rec.recipe_trace.results.sample[-1].sample_trace.trace._carry
    errs64.update(_chunks_vs_plain(torch, den_p, carry_p, torch.float64,
                                   'PolyGaussian', '_poly')[0])
    e32, plain32 = _chunks_vs_plain(torch, den_p, carry_p, torch.float32,
                                    'PolyGaussian', '_poly')
    errs32.update(e32)
    from bayesfast_tpu_torch.samplers import nuts_cuda as nc
    spec_p = nc._spec_entry(den_p, carry_p.q)[2]
    times.update(_time_chunks(torch, den_p, carry_p, plain32,
                              ops=_poly_leapfrog_ops(DES_D, spec_p),
                              suffix='_poly')[0])
    print('[10b] shared-memory plans, and the chunks under other plans')
    _poly_plans(torch, den_p, carry_p)
    print('[10b] the same with a full-covariance likelihood (the precision '
          'matvec)')
    den_f = _full_cov_density(den_p)
    for dt in (torch.float64, torch.float32):
        _chunks_vs_plain(torch, den_f, carry_p, dt, 'PolyGaussian', '_poly',
                         label='full cov ')
    t_phase = _wall(walls, '[10b]', t_phase)

    # ---- [11] the other samplers that need [3] (plain torch on the
    # card) and the checkpoint resume of NUTS and ChEES ----
    config.set_dtype(torch.float32)
    _other_samplers(torch, bt, den, A, tt, nuts_path)
    t_phase = _wall(walls, '[11]', t_phase)

    # ---- [12] the GBS anchors through their twins' main(), every
    # transition on the chunk kernels with the density compiled in; then
    # each density's chunk and block kernels held against their plain
    # versions and timed, float64 and float32 ----
    config.set_nuts_kernel('cuda')
    anchor_runs = [(anchor, *_anchor_run(torch, bt, anchor, jax_ncall))
                   for anchor, _, jax_ncall in ANCHORS]
    anchor_rows = {}
    for anchor, den_a, carry_a, launches_a, _ in anchor_runs:
        print(f'[12] {anchor} kernels vs plain, C={carry_a.q.shape[0]}, '
              f'D={carry_a.q.shape[1]}, K={K_CMP}, depth '
              f'{ANCHOR_CHECK_DEPTH.get(anchor, MAX_TREEDEPTH)}, final '
              'state')
        by_dt = _anchor_kernels(torch, anchor, den_a, carry_a)
        if anchor == 'cauchy':
            _anchor_partial_block(torch, den_a, carry_a)
        for kind in ('nuts_multi', 'nuts_warmup', 'nuts_block'):
            k = f'{kind}_{anchor}'
            anchor_rows[k] = (
                launches_a[kind], max(e[k] for e, _ in by_dt.values()),
                by_dt[torch.float64][1][k])
    t_phase = _wall(walls, '[12]', t_phase)

    # ---- [13] the DES-like Recipe with the cubic surrogate in both sample
    # steps, every transition on the chunk kernels; [13b] the three kernels
    # with the cubic density against their plain versions, then timed ----
    config.set_dtype(torch.float32)
    rec_c, cubic_launches, _ = _des_recipe(torch, bt, cubic=True)
    print(f'[13b] cubic PolyGaussian kernels vs plain, C={DES_CHAINS}, '
          f'D={DES_D}, M={DES_N_DATA}, K={K_CMP}, [13]\'s last state')
    errs_c, times_c = _cubic_kernels(torch, bt, rec_c)
    for kind in ('nuts_multi', 'nuts_warmup', 'nuts_block'):
        k = f'{kind}_cubic'
        launches[k] = cubic_launches[kind]
        errs32[k] = errs_c[k]
        times[k] = times_c[torch.float32][k]
    t_phase = _wall(walls, '[13]', t_phase)

    # ---- [14] a user's own torch density traced into the kernels:
    # bench.py's banana written in torch through sample() under 'auto', the
    # traced kernels bitwise against the program's interpreter, the
    # anchors' user forms ----
    traced_rows, rates14 = _traced(
        torch, bt, traced_dens, rates3,
        {a: c for a, _, c, _, _ in anchor_runs}, ptxas, builds, smi)
    t_phase = _wall(walls, '[14]', t_phase)

    # ---- [18] the user's own gradient: the banana as a JAX user writes
    # it (logp= and grad= of one point) through sample() under 'cuda', its
    # traced pair's kernels bitwise against the interpreter in both forms,
    # the external form on the host pool ----
    traced_rows.update(_user_grad(
        torch, bt, user_dens, traced_dens['bench_banana'][0], rates14,
        ptxas, builds, smi))
    t_phase = _wall(walls, '[18]', t_phase)

    # ---- [15] the 2-d donut Recipe under 'auto', every transition on the
    # chunk kernels with its plans traced; the quadratic plan's kernels
    # bitwise against the interpreter ----
    traced_rows.update(_donut(torch, bt, ptxas, builds, donut_srcs, smi))
    t_phase = _wall(walls, '[15]', t_phase)

    # ---- [16] past D = 64: Neal-100 compiled in (NE = 4) and MVN-250
    # traced (NE = 8) through sample() under 'auto', the MVN also pooled;
    # the new instantiations bitwise against their plain versions ----
    wide_rows, mvn_carry = _wide(torch, bt, wide_dens, wide_srcs, ptxas,
                                 builds, smi)
    t_phase = _wall(walls, '[16]', t_phase)

    # ---- [17] a Density plan past D = 64: the DES-like Recipe at D = 100
    # under 'cuda', every SampleStep on the chunk kernels with the
    # compiled-in PolyGaussian at NE = 4, the last one's warmup pooled on
    # the block kernel; [17a] the new instantiations bitwise against their
    # plain versions, and timed ----
    rec_w, wide_launches = _wide_recipe(torch, bt, smi)
    t_phase = _wall(walls, '[17]', t_phase)
    wide_rows.update(_wide_plan_kernels(torch, bt, rec_w, wide_launches,
                                        mvn_carry, ptxas, builds, smi))
    t_phase = _wall(walls, '[17a]', t_phase)

    meta = {
        'nuts_multi': ('bayesfast_tpu_torch/csrc/nuts.cu',
                       'bayesfast_tpu/samplers/nuts_pallas.py:462'),
        'nuts_warmup': ('bayesfast_tpu_torch/csrc/nuts.cu',
                        'bayesfast_tpu/samplers/nuts_pallas.py:746'),
        'kde_cdf': ('bayesfast_tpu_torch/csrc/kde.cu',
                    'bayesfast_tpu/ops/kde_pallas.py:50'),
        'nuts_block': ('bayesfast_tpu_torch/csrc/nuts.cu',
                       'bayesfast_tpu/samplers/nuts_pallas.py:431'),
        # the chunk kernels instantiated with the PolyGaussian density
        'nuts_multi_poly': ('bayesfast_tpu_torch/csrc/nuts.cu',
                            'bayesfast_tpu/samplers/nuts_pallas.py:462'),
        'nuts_warmup_poly': ('bayesfast_tpu_torch/csrc/nuts.cu',
                             'bayesfast_tpu/samplers/nuts_pallas.py:746'),
        # the three kernels with the cubic PolyGaussian density ([13],
        # [13b]); the Recipe does not pool its metric, so the block kernel
        # has no launch on its path
        'nuts_multi_cubic': ('bayesfast_tpu_torch/csrc/nuts.cu',
                             'bayesfast_tpu/samplers/nuts_pallas.py:462'),
        'nuts_warmup_cubic': ('bayesfast_tpu_torch/csrc/nuts.cu',
                              'bayesfast_tpu/samplers/nuts_pallas.py:746'),
        'nuts_block_cubic': ('bayesfast_tpu_torch/csrc/nuts.cu',
                             'bayesfast_tpu/samplers/nuts_pallas.py:431')}
    rows = []
    for k, (src, replaces) in meta.items():
        ms, plain_ms, bound_ms, bound_by = times[k][:4]
        # no single PyTorch call computes a NUTS transition
        lib_ms = times[k][4] if len(times[k]) > 4 else None
        rows.append({'name': k, 'route': 'cuda', 'source': src,
                     'replaces': replaces, 'launches': launches[k],
                     'max_abs_err': errs32[k], 'ms': ms,
                     'plain_ms': plain_ms, 'bound_ms': bound_ms,
                     'bound_by': bound_by, 'library_ms': lib_ms})
    # [12]'s instantiations: launches on the anchors' float64 path (none of
    # them runs the block kernel), the float64 kernel's times; no PyTorch
    # call computes a NUTS transition
    pallas = {'nuts_multi': 462, 'nuts_warmup': 746, 'nuts_block': 431}
    for k, (n, err, (ms, plain_ms, bound_ms, bound_by)) in \
            anchor_rows.items():
        line = pallas[k.rsplit('_', 1)[0]]
        rows.append({'name': k, 'route': 'cuda',
                     'source': 'bayesfast_tpu_torch/csrc/nuts.cu',
                     'replaces': f'bayesfast_tpu/samplers/nuts_pallas.py:'
                                 f'{line}',
                     'launches': n, 'max_abs_err': err, 'ms': ms,
                     'plain_ms': plain_ms, 'bound_ms': bound_ms,
                     'bound_by': bound_by, 'library_ms': None})
    # [14]'s, [15]'s and [18]'s traced instantiations: launches on their
    # main paths (the block kernel has none: each adapts per chain),
    # float32 times for the banana and its user-gradient form, float64 for
    # the anchors' user forms and the donut's quadratic plan
    for k, (n, err, (ms, plain_ms, bound_ms, bound_by)) in \
            traced_rows.items():
        line = pallas[next(p for p in pallas if k.startswith(p))]
        rows.append({'name': k, 'route': 'cuda',
                     'source': 'bayesfast_tpu_torch/csrc/nuts_kernels.cuh',
                     'replaces': f'bayesfast_tpu/samplers/nuts_pallas.py:'
                                 f'{line}',
                     'launches': n, 'max_abs_err': err, 'ms': ms,
                     'plain_ms': plain_ms, 'bound_ms': bound_ms,
                     'bound_by': bound_by, 'library_ms': None})
    # [16]'s and [17]'s instantiations: launches on the targets' paths
    # (Neal's per-chain run has no block launch; the MVN's pooled warmup is
    # its block launches; the wide Recipe's are [17]'s, its pooled step's
    # warmup its block launches; PolyGaussian at NE = 8 and the traced MVN
    # plan run on no path: [17a] launches them), float32 times at 1024
    # chains
    srcs = {'neal': 'nuts_densities.cuh', 'wide_recipe': 'nuts_poly.cuh',
            'poly_ne8': 'nuts_poly.cuh'}
    for k, (n, err, (ms, plain_ms, bound_ms, bound_by)) in wide_rows.items():
        line = pallas[next(p for p in pallas if k.startswith(p))]
        rows.append({'name': k, 'route': 'cuda',
                     'source': 'bayesfast_tpu_torch/csrc/' + next(
                         (v for t, v in srcs.items() if k.endswith(t)),
                         'nuts_kernels.cuh'),
                     'replaces': f'bayesfast_tpu/samplers/nuts_pallas.py:'
                                 f'{line}',
                     'launches': n, 'max_abs_err': err, 'ms': ms,
                     'plain_ms': plain_ms, 'bound_ms': bound_ms,
                     'bound_by': bound_by, 'library_ms': None})
    print('phase walls (s): ' + ', '.join(f'{k} {v:.1f}'
                                          for k, v in walls.items())
          + f'; total {time.time() - t_run:.1f}')
    print(smi)
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


def _args():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--ab', metavar='PARENT',
                    help='time this checkout against PARENT, in turns')
    ap.add_argument('--ab-one', nargs=3, metavar=('TREE', 'STATE', 'OUT'),
                    help='one process of the A/B')
    ap.add_argument('--gbs-seeds', type=int, default=5)
    ap.add_argument('--free-samplers', action='store_true',
                    help='[11c] and [11d] alone (main starts this)')
    ap.add_argument('--ptxas-sweep', action='store_true',
                    help='build the kernels past D = 64 at NE = 3..8 and '
                         'print their registers and spills')
    ap.add_argument('--work', default=os.path.join(
        _REPO, 'bayesfast_tpu_torch', 'build', 'ab'))
    return ap.parse_args()


if __name__ == '__main__':
    a = _args()
    try:
        if a.ab_one:
            rc = _ab_one(os.path.abspath(a.ab_one[0]), *a.ab_one[1:],
                         a.gbs_seeds) or 0
        elif a.ab:
            rc = _ab(os.path.abspath(a.ab), a.work, a.gbs_seeds)
        elif a.free_samplers:
            rc = _tempered_and_ensemble()
        elif a.ptxas_sweep:
            import torch
            sys.path.insert(0, _REPO)
            if not torch.cuda.is_available():
                raise RuntimeError('no CUDA device')
            warnings.filterwarnings('ignore', message='for chain #')
            _ptxas_sweep(torch)
            rc = 0
        else:
            rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
