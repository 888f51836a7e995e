"""Twins of the JAX package's GBS evidence examples
(``examples/{funnel,ring,cauchy}_gbs.py``), on the port.

Each module's ``main()`` samples its anchor density with NUTS through
``Recipe(sample=..., post=GBS)`` in float64 at the example's configuration
(64 chains, 1000 warmup of 2500 iterations, read from ``N_CHAIN``,
``N_ITER`` and ``N_WARMUP``), prints logz beside the fiducial and returns
the Recipe. The densities are compiled into the CUDA NUTS kernels
(``ops/densities.py``), so every transition runs on the chunk kernels;
the SIT fit of GBS runs its KDE sums on the KDE-cdf kernel. Run one with

    python -m bayesfast_tpu_torch.examples.funnel_gbs

``user_densities`` writes ``bench.py``'s banana and the four examples'
densities as a user writes them, in torch; they reach the kernels by
tracing (``ops/trace.py``).
"""

import os
import time

__all__ = ['run_anchor']


def run_anchor(density, extra, seed, fiducial):
    """Sample ``density`` (with the sampler options ``extra``) and take its
    evidence with GBS, as the JAX examples do; prints logz and the wall,
    returns the Recipe."""
    import torch
    import bayesfast_tpu_torch as bt
    bt.config.set_dtype(torch.float64)
    bt.utils.set_generator(seed)
    sample_trace = {
        'n_chain': int(os.environ.get('N_CHAIN', 64)),
        'n_iter': int(os.environ.get('N_ITER', 2500)),
        'n_warmup': int(os.environ.get('N_WARMUP', 1000)),
        **extra,
    }
    rec = bt.Recipe(density=density, sample={'sample_trace': sample_trace},
                    post={'evidence_method': 'GBS'})
    t0 = time.time()
    rec.run()
    res = rec.get()
    print(f'logz = {res.logz:.4f} +- {res.logz_err:.4f} '
          f'(fiducial: {fiducial}); {time.time() - t0:.1f} s')
    return rec
