"""The port's surrogate Recipe against the JAX package's, on the CPU.

A tiny DES-like Recipe (D = 6 parameters, a 24-dim data vector, quadratic
response in 3 of them, 8 chains): an OptimizeStep with a linear PolyModel,
two SampleSteps with a linear + quadratic-on-3 PolyModel, and truncated
importance sampling, in both packages from the same generator seed. The
OptimizeStep's first fit points are Sobol draws, bitwise equal in both, so
its first coefficients agree to 1e-8; with ``logp_cutoff=False`` every
step takes its fixed number of fit points, so n_call is equal; the two
samplers draw different streams, so the IS-weighted posterior means agree
within their combined Monte Carlo error, measured over two of the port's
runs. The JAX side samples on its XLA
tree loop (a valid reference and the quickest on the CPU); the port on the
plain versions of its chunk kernels.
"""

import warnings

import numpy as np
import pytest

import bayesfast_tpu as bf
from bayesfast_tpu.modules import (Gaussian as JGaussian,
                                   PolyConfig as JConfig, PolyModel as JPoly)

import bayesfast_tpu_torch as bt
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.modules import Gaussian, PolyConfig, PolyModel


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


D, M, NL, TRUTH = 6, 24, np.arange(3), 0.1
TRACE = {'n_chain': 8, 'n_iter': 50, 'n_warmup': 25}
N_IS = 100
SEEDS = (27, 28)   # the port's runs (the JAX run takes the first)


def _forward():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(M, D)) / np.sqrt(D)
    B = rng.normal(size=(M, 3, 3)) / 6.0
    B = (B + np.swapaxes(B, 1, 2)) / 2

    def forward(x, *args, **kwargs):
        x = np.asarray(x)
        return A @ x + np.einsum('dij,i,j->d', B, x[NL], x[NL])

    return forward


def _recipe(pkg):
    """The tiny DES-like Recipe of one package (``bf`` or ``bt``)."""
    J = pkg is bf
    Gauss, Conf, Poly = ((JGaussian, JConfig, JPoly) if J
                         else (Gaussian, PolyConfig, PolyModel))
    forward = _forward()
    model = pkg.Module(fun=forward, input_vars='x', output_vars='m',
                       input_shapes=[D], output_shapes=[M], traceable=False)
    like = Gauss(mean=forward(np.full(D, TRUTH)), cov=np.full(M, 0.05),
                 input_vars='m', output_vars='logp')
    den = pkg.Density(density_name='logp', module_list=[model, like],
                      input_vars='x', input_shapes=[D],
                      input_scales=np.stack([np.full(D, -5.),
                                             np.full(D, 5.)]).T,
                      hard_bounds=True, decay_options={'use_decay': True})
    s0 = Poly('linear', input_size=D, output_size=M, input_vars='x',
              output_vars='m')
    s1 = Poly([Conf('linear'), Conf('quadratic', input_mask=NL)],
              input_size=D, output_size=M, input_vars='x', output_vars='m')
    opt = pkg.recipe.OptimizeStep(surrogate_list=s0, alpha_n=2, max_iter=2,
                                  sample_trace=dict(TRACE))
    sam = [pkg.recipe.SampleStep(surrogate_list=s1, alpha_n=2,
                                 reuse_samples=1, logp_cutoff=False,
                                 sample_trace=dict(TRACE))
           for _ in range(2)]
    post = pkg.recipe.PostStep(n_is=N_IS, k_trunc=0.25)
    return pkg.Recipe(density=den, optimize=opt, sample=sam, post=post)


def _weighted_mean(rec):
    """The IS-weighted posterior mean of a finished Recipe."""
    res = rec.get()
    w = res.weights_trunc
    return np.sum(res.samples * w[:, None], axis=0) / np.sum(w)


def _run_quiet(rec):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        rec.run()
    return rec


def test_recipe_matches_jax():
    old = bf.config.get_nuts_kernel()
    bf.config.set_nuts_kernel('xla')
    try:
        bf.utils.set_generator(27)
        rj = _run_quiet(_recipe(bf))
    finally:
        bf.config.set_nuts_kernel(old)
    runs = []
    for seed in SEEDS:
        bt.utils.set_generator(seed)
        runs.append(_run_quiet(_recipe(bt)))
    rt = runs[0]
    oj = rj.recipe_trace.results.optimize
    ot = rt.recipe_trace.results.optimize
    # pass #0 fits the linear surrogate on the same Sobol points
    for cj, ct in zip(oj[0].surrogate_list[0].configs,
                      ot[0].surrogate_list[0].configs):
        np.testing.assert_allclose(ct._a, np.asarray(cj._a), rtol=1e-8,
                                   atol=1e-10)
    np.testing.assert_allclose(ot[0].x_max.x_trans, oj[0].x_max.x_trans,
                               rtol=1e-6, atol=1e-6)
    assert len(ot) == len(oj)
    res_j, res_t = rj.get(), rt.get()
    assert res_t.n_call == res_j.n_call
    assert all(r.get().n_call == res_j.n_call for r in runs)
    assert rt.recipe_trace.finished == (True, True, True)
    assert res_t.samples.shape == res_j.samples.shape == (N_IS, D)
    assert np.all(np.isfinite(res_t.weights)) and np.all(res_t.weights > 0)
    # The Monte Carlo error of one run's weighted mean is that of the whole
    # run (its fit points, chains and IS draws), so it is measured over the
    # port's runs from SEEDS, pooled over the dimensions: the IS formula
    # within one run misses the fit points' share, which moves every chain.
    means = np.stack([_weighted_mean(r) for r in runs])
    err = np.sqrt(np.mean(means.var(axis=0, ddof=1)))
    m_j, m_t = _weighted_mean(rj), means[0]
    assert np.all(np.abs(m_t - m_j) < 4 * np.sqrt(2.0) * err), (m_t, m_j, err)
    assert np.all(np.abs(means.mean(0) - m_j)
                  < 4 * np.sqrt(1.0 + 1.0 / len(SEEDS)) * err)
