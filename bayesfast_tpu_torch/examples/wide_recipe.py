"""The DES-like surrogate Recipe at D = 100: the structure of the JAX
package's ``examples/des_like_pipeline.py`` (DES-Y1's: an expensive
external model of a 457-dim data vector, a Gaussian likelihood) with the
block of nuisance parameters widened from 18 to 91.

* 100 parameters: 9 with a quadratic response, 91 linear; the data vector
  is the model at 0.1 in every parameter; hard bounds [-5, 5] on each,
  the decay on;
* an OptimizeStep on a linear PolyModel;
* two SampleSteps on a PolyModel linear in every parameter plus
  quadratic in the nine (F = 101 + 45 = 146 features), the second with a
  pooled metric (one shared diagonal metric adapted over all chains);
* a PostStep with truncated importance sampling (500 draws, k_trunc
  0.25); 1024 chains, float32.

Past D = 64 the surrogate still takes the CUDA NUTS kernels: the
compiled-in ``PolyGaussian`` at NE = 4 dimensions a lane, from a unit of
its own (``samplers/nuts_cuda.py::poly_unit_source``), its coefficients
streamed through shared-memory tiles, its Hessians read from device
memory. The SampleSteps run on the chunk kernels; the pooled step's warmup
is one block-kernel launch a transition. Run it with

    python -m bayesfast_tpu_torch.examples.wide_recipe

(``bayesfast_tpu_torch.config.set_device('cpu')`` first for the CPU, where
the kernels' plain versions run: slow at this size.)
"""

import time

import numpy as np

__all__ = ['D', 'N_DATA', 'NONLINEAR', 'TRUTH', 'make_model',
           'make_density', 'make_surrogate', 'build', 'analytic_sigma',
           'weighted_mean', 'main']

D, N_DATA, TRUTH = 100, 457, 0.1
NONLINEAR = np.arange(9)      # parameters with a quadratic response
N_CHAIN, N_IS = 1024, 500
TRACES = ({'n_iter': 1000, 'n_warmup': 500},
          {'n_iter': 800, 'n_warmup': 400})


def make_model(dim=D, n_data=N_DATA, nonlinear=NONLINEAR, seed=0):
    """The true model, its data and its Jacobian at the truth, as
    ``examples/des_like_pipeline.py:_make_model`` builds them at ``dim``
    parameters: ``A x + quad(x[nonlinear])`` with ``A`` (n_data, dim) /
    sqrt(dim) and a symmetric quadratic form per output on the nonlinear
    parameters, / (2 len(nonlinear)); the data at TRUTH in every
    parameter. The model is host-only numpy of one point."""
    rng = np.random.default_rng(seed)
    n_nl = len(nonlinear)
    A = rng.normal(size=(n_data, dim)) / np.sqrt(dim)
    B = rng.normal(size=(n_data, n_nl, n_nl)) / (2.0 * n_nl)
    B = (B + np.swapaxes(B, 1, 2)) / 2

    def forward(x, *args, **kwargs):
        """The 'expensive' external model (host-only numpy)."""
        x = np.asarray(x)
        return A @ x + np.einsum('dij,i,j->d', B, x[nonlinear], x[nonlinear])

    truth = np.full(dim, TRUTH)
    jac = A.copy()
    jac[:, nonlinear] += 2 * np.einsum('dij,j->di', B, truth[nonlinear])
    return forward, forward(truth), jac


def make_density(forward, data, dim=D):
    """The Density: the external model, a diagonal Gaussian of variance
    0.05 per output, hard bounds [-5, 5], the decay on."""
    import bayesfast_tpu_torch as bt
    from bayesfast_tpu_torch.modules import Gaussian
    model = bt.Module(fun=forward, input_vars='x', output_vars='m',
                      input_shapes=[dim], output_shapes=[len(data)],
                      traceable=False)
    like = Gaussian(mean=data, cov=np.full(len(data), 0.05),
                    input_vars='m', output_vars='logp')
    return bt.Density(density_name='logp', module_list=[model, like],
                      input_vars='x', input_shapes=[dim],
                      input_scales=np.stack([np.full(dim, -5.0),
                                             np.full(dim, 5.0)]).T,
                      hard_bounds=True, decay_options={'use_decay': True})


def make_surrogate(dim=D, n_data=N_DATA, nonlinear=NONLINEAR):
    """The SampleSteps' PolyModel: linear in every parameter, quadratic in
    the nonlinear ones."""
    from bayesfast_tpu_torch.modules import PolyConfig, PolyModel
    return PolyModel([PolyConfig('linear'),
                      PolyConfig('quadratic', input_mask=nonlinear)],
                     input_size=dim, output_size=n_data, input_vars='x',
                     output_vars='m')


def build(dim=D, n_data=N_DATA, nonlinear=NONLINEAR, n_chain=N_CHAIN,
          traces=TRACES, n_is=N_IS, optimize_options=(), sample_options=()):
    """The Recipe; its second SampleStep pools its metric.
    ``optimize_options`` and ``sample_options`` are more keywords of the
    OptimizeStep and of both SampleSteps (for example ``max_iter`` and
    ``logp_cutoff=False``, as a test that counts n_call asks)."""
    import bayesfast_tpu_torch as bt
    from bayesfast_tpu_torch.modules import PolyModel
    forward, data, _ = make_model(dim, n_data, nonlinear)
    density = make_density(forward, data, dim)
    tr = [dict(n_chain=n_chain, **t) for t in traces]
    opt = bt.recipe.OptimizeStep(
        surrogate_list=PolyModel('linear', input_size=dim,
                                 output_size=n_data, input_vars='x',
                                 output_vars='m'),
        alpha_n=2, sample_trace=dict(tr[0]), **dict(optimize_options))
    sam = [bt.recipe.SampleStep(
        surrogate_list=make_surrogate(dim, n_data, nonlinear), alpha_n=2,
        reuse_samples=1, sample_trace=dict(t, pooled_metric=i == 1),
        **dict(sample_options)) for i, t in enumerate((tr[0], tr[1]))]
    post = bt.recipe.PostStep(n_is=n_is, k_trunc=0.25)
    return bt.Recipe(density=density, optimize=opt, sample=sam, post=post)


def analytic_sigma(dim=D, n_data=N_DATA, nonlinear=NONLINEAR):
    """The posterior's standard deviations at the truth in the Laplace
    approximation: the square roots of the diagonal of (J' S^-1 J)^-1,
    S = 0.05 I (n_data >= dim)."""
    jac = make_model(dim, n_data, nonlinear)[2]
    return np.sqrt(np.diag(np.linalg.inv(jac.T @ jac / 0.05)))


def weighted_mean(rec):
    """The IS-weighted posterior mean of a finished Recipe."""
    res = rec.get()
    w = res.weights_trunc
    return np.sum(res.samples * w[:, None], axis=0) / np.sum(w)


def main():
    import torch
    import bayesfast_tpu_torch as bt
    bt.config.set_dtype(torch.float32)
    bt.utils.set_generator(27)
    rec = build()
    t0 = time.time()
    rec.run()
    z = np.abs(weighted_mean(rec) - TRUTH) / analytic_sigma()
    print(f'n_call = {rec.get().n_call}; IS-weighted means within '
          f'{z.max():.3f} analytic sigma of the truth; '
          f'{time.time() - t0:.1f} s')
    return rec


if __name__ == '__main__':
    main()
