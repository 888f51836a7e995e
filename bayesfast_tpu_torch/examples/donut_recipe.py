"""2-d donut with the full surrogate Recipe: the twin of
``examples/donut_recipe.py`` (the reference's ``2d-donut.ipynb``).

The 'expensive' module is m = |x| (``torch.linalg.vector_norm``, the true
model, which the sampler never sees), logp = -(m - 5)^2 / 0.5. A linear
surrogate in the OptimizeStep, a quadratic one in two SampleSteps, the
decay on, 200 importance draws; float64, 8 chains x 1000 iterations, 500
of them warmup, generator seed 2, as the JAX script. Both sampled plans
end in the user's ``f_1``, so they reach the CUDA NUTS kernels by tracing
(``Density.kernel_spec``: one generated unit for the linear plan and one
for the quadratic, reused across refits). The reference reports n_call ~
330; the posterior's E[r] is 5 + 0.25 / 5 = 5.05. Run it with

    python -m bayesfast_tpu_torch.examples.donut_recipe
"""

import time

import numpy as np
import torch

import bayesfast_tpu_torch as bt

A, B = 5.0, 0.5


def f_0(x):
    return torch.linalg.vector_norm(x, 2, -1)    # the 'expensive' model


def f_1(m):
    return -(m - A) ** 2 / B


def build():
    """The donut's Recipe, as the JAX script builds it (float64, seed 2)."""
    bt.config.set_dtype(torch.float64)
    module_0 = bt.Module(fun=f_0, input_vars='x', output_vars='m')
    module_1 = bt.Module(fun=f_1, input_vars='m', output_vars='logp')
    density = bt.Density(module_list=[module_0, module_1], input_shapes=[2],
                         input_vars='x', density_name='logp')
    density.set_decay_options(use_decay=True)

    surro_0 = bt.modules.PolyModel('linear', input_size=2, output_size=1,
                                   input_vars='x', output_vars='m')
    surro_1 = bt.modules.PolyModel('quadratic', input_size=2, output_size=1,
                                   input_vars='x', output_vars='m')
    surro_1.set_bound_options(use_bound=False)

    bt.utils.set_generator(2)
    x_0 = bt.utils.sobol.multivariate_normal([10, 10], np.eye(2), 20)
    sample_trace = {'n_chain': 8, 'n_iter': 1000, 'n_warmup': 500}

    opt = bt.recipe.OptimizeStep(surrogate_list=surro_0, x_0=x_0,
                                 sample_trace=dict(sample_trace))
    sam_0 = bt.recipe.SampleStep(surrogate_list=surro_1, alpha_n=5,
                                 reuse_samples=0,
                                 sample_trace=dict(sample_trace),
                                 logp_cutoff=False)
    sam_1 = bt.recipe.SampleStep(surrogate_list=surro_1, alpha_n=5,
                                 reuse_samples=1,
                                 sample_trace=dict(sample_trace),
                                 logp_cutoff=False)
    return bt.Recipe(density=density, optimize=opt, sample=[sam_0, sam_1],
                     post={'n_is': 200})


def mean_radius(res):
    """The importance-weighted E[r] of a Recipe result."""
    r = np.linalg.norm(res.samples, axis=-1)
    w = res.weights_trunc
    return float(np.sum(r * w) / np.sum(w))


def main():
    rec = build()
    t0 = time.time()
    rec.run()
    res = rec.get()
    print(f'E[r] = {mean_radius(res):.4f} (target ~{A}), '
          f'n_call = {res.n_call} (reference: ~330); '
          f'{time.time() - t0:.1f} s')
    return rec


if __name__ == '__main__':
    main()
