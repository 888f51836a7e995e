"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from ``bayesfast_tpu_torch/csrc``, holds each
against its plain torch version on the card, drives the main path
(``bayesfast_tpu_torch.sample`` on the bench's 32-d bounded rotated banana
with 1024 chains, float32, through warmup and post-warmup chunks on the two
kernels) and checks what comes out. Every phase that fails makes the script
exit non-zero; without a CUDA device it exits non-zero before printing any
result. Run from the repository root, with no arguments:

    python3 chip_smoke.py

Output, last lines: the card's name and power limit as nvidia-smi reports
them, one JSON line with each kernel's measurements, and
``{"ok": true, "device": {...}}``.
"""

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
K_CMP = 4          # transitions per chunk in the kernel-vs-plain checks
MAX_TREEDEPTH, MAX_CHANGE = 10, 1000.


def _nvidia_smi():
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as exc:
        return f'nvidia-smi unavailable ({exc!r})'


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


def _compare(name, ker, ref, rtol, min_agree):
    """Discrete stats equal on at least ``min_agree`` of the chains; on
    those chains every float within ``rtol`` of the plain value, with a
    floor of 1% of the output's scale (energy differences: of the energy
    scale). Returns the max abs error."""
    import torch
    same = torch.ones(N_CHAIN, dtype=torch.bool, device=ref['q'].device)
    for k in _DISCRETE:
        same &= (ker[k] == ref[k]).reshape(-1, N_CHAIN).all(dim=0)
    frac = same.float().mean().item()
    bad = (~same).nonzero().flatten().tolist()
    if bad:
        print(f'  {name}: discrete stats differ on chains {bad[:20]}')
    escale = ref['energy'].abs().max().double()
    max_err, worst, worst_key = 0.0, 0.0, None
    for k in ref:
        if k in _DISCRETE:
            continue
        a, b = ker[k].double(), ref[k].double()
        # the chain axis: (K, C, D) and (K, C) rows, (C, D) and (C,) states
        if a.dim() == 3 or (a.dim() == 2 and a.shape[0] != N_CHAIN):
            a, b = a[:, same], b[:, same]
        else:
            a, b = a[same], b[same]
        if b.numel() == 0:
            continue
        # equal infinities (a diverged energy) agree
        err = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
        if k in ('energy_change', 'max_energy_change', 'max_de'):
            tol = rtol * (b.abs() + escale)
        else:
            tol = rtol * (b.abs() + 0.01 * b.abs().max())
        max_err = max(max_err, err.max().item())
        w = (err / tol.clamp(min=1e-300)).max().item()
        if w > worst:
            worst, worst_key = w, k
    ok = frac >= min_agree and worst <= 1.0
    bitwise = all(torch.equal(ker[k], ref[k]) for k in ref)
    print(f'  {name}: bitwise equal: {bitwise}')
    print(f'  {name}: discrete agree on {frac:.4%} of chains, max abs err '
          f'{max_err:.3e}, worst err / tolerance {worst:.3f} ({worst_key}) -> '
          f'{"ok" if ok else "FAIL"}')
    if not ok:
        raise AssertionError(f'{name}: kernel disagrees with its plain '
                             'version')
    return max_err


def _kernel_vs_plain(torch, den, carry, dtype, rtol, min_agree):
    """Both kernels against their plain versions at C=1024, D=32, K=4 on
    the main path's final state (positions, adapted metric and step size)
    cast to ``dtype``, plus the chain_start split. Returns the max abs
    errors."""
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
    errs = {}

    # frozen chunk
    metric = init_diag_metric(q, var)
    ker = _as_dict(*nc.nuts_chunk_batched(seed, q, metric, eps, K_CMP,
                                          MAX_TREEDEPTH, MAX_CHANGE,
                                          density=den, i0=i0))
    torch.cuda.synchronize()
    o = nc.nuts_chunk_plain(seed, q, var, eps, K_CMP, MAX_TREEDEPTH,
                            MAX_CHANGE, plain_lpg, i0)
    ref = _as_dict(o['q'], o['q_final'], nc._chunk_stats(o, dtype))
    print(f'  frozen {tag}: mean tree depth '
          f'{ref["tree_depth"].float().mean().item():.3f}, divergent '
          f'{ref["diverging"].float().mean().item():.4f}')
    errs['nuts_multi'] = _compare(f'nuts_multi {tag}', ker, ref, rtol,
                                  min_agree)

    # warmup chunk, with a refresh and a window switch inside it
    wsched, _ = nc._window_schedule(4, 0, 5, K_CMP, 1, True)
    step = init_step_size(eps)
    args = (K_CMP, MAX_TREEDEPTH, MAX_CHANGE, 0.8, 0.05, 0.75, 10., True,
            True, wsched)
    ker = nc.nuts_warmup_chunk_batched(seed, q, step, metric, *args,
                                       density=den, i0=i0)
    torch.cuda.synchronize()
    steps, mets = nc._warmup_leaves(q, step, metric)
    ref = nc.nuts_warmup_chunk_plain(seed, q, steps, mets, *args, plain_lpg,
                                     i0)
    errs['nuts_warmup'] = _compare(f'nuts_warmup {tag}', ker, ref, rtol,
                                   min_agree)

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
    return errs


def _time_chunks(torch, den, carry, device):
    """One K=4 chunk of each kernel beside its plain version, at the main
    path's shapes and final state (CUDA events; the kernel warmed up
    first)."""
    from bayesfast_tpu_torch.samplers import nuts_cuda as nc
    plain_lpg = nc.plain_lpg(den)
    q, metric, step = carry.q, carry.metric, carry.step
    C = q.shape[0]
    var = nc._mat(metric.var, C, D, q)
    eps = torch.exp(step.log_bar)
    wsched, _ = nc._window_schedule(400, 370, 240, K_CMP, 1, True)
    args = (K_CMP, MAX_TREEDEPTH, MAX_CHANGE, 0.8, 0.05, 0.75, 10., True,
            True, wsched)
    steps, mets = nc._warmup_leaves(q, step, metric)
    runs = {
        'nuts_multi': (
            lambda: nc.nuts_chunk_batched(5, q, metric, eps, K_CMP,
                                          MAX_TREEDEPTH, MAX_CHANGE,
                                          density=den, i0=700),
            lambda: nc.nuts_chunk_plain(5, q, var, eps, K_CMP, MAX_TREEDEPTH,
                                        MAX_CHANGE, plain_lpg, 700)),
        'nuts_warmup': (
            lambda: nc.nuts_warmup_chunk_batched(5, q, step, metric, *args,
                                                 density=den, i0=700),
            lambda: nc.nuts_warmup_chunk_plain(5, q, steps, mets, *args,
                                               plain_lpg, 700)),
    }
    times = {}
    for name, (kern, plain) in runs.items():
        def timed(fn, n):
            fn()
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(n):
                fn()
            t1.record()
            torch.cuda.synchronize()
            return t0.elapsed_time(t1) / n
        times[name] = (timed(kern, 5), timed(plain, 1))
        print(f'  {name}: one K={K_CMP} chunk at C={C}, D={D}, float32: '
              f'kernel {times[name][0]:.3f} ms, plain torch '
              f'{times[name][1]:.3f} ms')
    return times


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run.', file=sys.stderr)
        return 1
    sys.path.insert(0, _REPO)
    import bayesfast_tpu_torch as bt
    from bayesfast_tpu_torch import _build, config
    from bayesfast_tpu_torch.samplers import nuts_cuda as nc
    from bayesfast_tpu_torch.utils.acor import effective_sample_size

    # sample() warns once per chain whose post-warmup acceptance is off
    # target (1024 lines a call); the divergence and depth warnings stay
    warnings.filterwarnings('ignore', message='for chain #')
    device = torch.device('cuda', 0)
    name = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f'[1] device: {name}; nvidia-smi: {smi}')
    print(f'    torch {torch.__version__}, CUDA {torch.version.cuda}')

    # ---- [2] build ----
    path = _build.build_library(verbose=True)
    print(f'[2] built {os.path.relpath(path, _REPO)} in '
          f'{_build.last_build_seconds:.1f} s')
    _build.load_library()

    # ---- [3] the main path at bench.py's configuration ----
    config.set_dtype(torch.float32)
    config.set_device(device)
    config.set_nuts_kernel('cuda')
    A, den = _bench_density(torch.float32)
    bt.utils.set_generator(32)
    trace = bt.NTrace(n_chain=N_CHAIN, n_iter=N_WARMUP + N_POST,
                      n_warmup=N_WARMUP)
    nc.nuts_chunk_batched.launches = 0
    nc.nuts_warmup_chunk_batched.launches = 0
    t0 = time.time()
    tt = bt.sample(den, trace, n_run=2, verbose=False, n_update=2)
    t_start = time.time() - t0
    torch.cuda.synchronize()
    t0 = time.time()
    tt = bt.sample(den, tt, n_run=N_WARMUP - 2, verbose=False, n_update=100)
    torch.cuda.synchronize()
    dt_warm = time.time() - t0
    dt_post = 0.0
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        tt = bt.sample(den, tt, n_run=N_POST // 3, verbose=False,
                       n_update=N_POST // 3)
        torch.cuda.synchronize()
        dt_post += time.time() - t0
    launches = {'nuts_warmup': nc.nuts_warmup_chunk_batched.launches,
                'nuts_multi': nc.nuts_chunk_batched.launches}
    expect = {'nuts_warmup': 1 + 4 * 2, 'nuts_multi': 3 * 2}
    print(f'[3] main path: launches {launches} (driver chunks {expect})')
    if launches != expect:
        raise AssertionError('the main path did not run every chunk on the '
                             'kernels')
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
    n_grp = 8
    gs = N_CHAIN // n_grp
    ess = float(sum(np.sum(effective_sample_size(s[g * gs:(g + 1) * gs]))
                    / D for g in range(n_grp)))
    print(f'    start-up call (Sobol, descent, probe, 2 iterations) '
          f'{t_start:.2f} s')
    print(f'    warmup {N_CHAIN * (N_WARMUP - 2) / dt_warm:.1f} it/s, post '
          f'{N_CHAIN * N_POST / dt_post:.1f} it/s, ESS/s {ess / dt_post:.1f}'
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

    # ---- [3b] known moments: a bounded diag Gaussian through the kernels
    mean = np.linspace(-2., 2., 8)
    var_g = np.linspace(0.2, 3., 8)
    den_g = bt.DensityLite(
        logp=bt.ops.DiagGaussian(mean, var_g, dtype=torch.float32),
        input_size=8, input_scales=np.stack([np.full(8, -20.),
                                             np.full(8, 20.)]).T,
        hard_bounds=True)
    tg = bt.sample(den_g, bt.NTrace(n_chain=N_CHAIN, n_iter=300,
                                    n_warmup=150, random_generator=3),
                   verbose=False)
    sg = tg.get()
    m_err = np.max(np.abs(sg.mean(0) - mean) / np.sqrt(var_g))
    v_err = np.max(np.abs(sg.var(0) / var_g - 1))
    print(f'[3b] diag Gaussian D=8: max |mean err| / sd {m_err:.4f}, max '
          f'|var ratio - 1| {v_err:.4f}')
    if not (np.isfinite(sg).all() and m_err < 0.05 and v_err < 0.1):
        raise AssertionError('diag Gaussian moments off')

    # ---- [4] each kernel against its plain version, on the main path's
    # final state ----
    print('[4] kernel vs plain, C=1024, D=32, K=4, bench banana with bounds')
    carry = tt.trace._carry
    errs64 = _kernel_vs_plain(torch, den, carry, torch.float64, 1e-9, 0.999)
    errs32 = _kernel_vs_plain(torch, den, carry, torch.float32, 1e-4, 0.99)

    # ---- [5] one chunk: kernel time beside the plain version's ----
    print('[5] chunk timing (CUDA events)')
    times = _time_chunks(torch, den, tt.trace._carry, device)

    src = 'bayesfast_tpu_torch/csrc/nuts.cu'
    replaces = {'nuts_multi': 'bayesfast_tpu/samplers/nuts_pallas.py:462',
                'nuts_warmup': 'bayesfast_tpu/samplers/nuts_pallas.py:746'}
    print(f'    max abs err float64 {errs64}, float32 {errs32}')
    print(smi)
    print(json.dumps({'kernels': [
        {'name': k, 'route': 'cuda', 'source': src, 'replaces': replaces[k],
         'launches': launches[k], 'max_abs_err': errs32[k],
         'ms': times[k][0], 'plain_ms': times[k][1]}
        for k in ('nuts_multi', 'nuts_warmup')]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
