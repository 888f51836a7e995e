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

Each PostStep also runs ``evidence_method='GBS'`` after the importance
sampling (``_evidence_with_is``: GBS on the surrogate's trace, logz_q,
plus the IS term log E_q[p/q]). Its SIT fit (4 chains x 25 draws x 6
dims) takes the host route in both packages. The JAX package's GBS and
IS term run on each port run's own inputs (its surrogate trace, surrogate
logp and IS logp / logq): the IS term agrees to rtol 1e-10 and the port's
logz_q lies within 4 combined GBS errors of the JAX package's. The whole
runs' logz are compared too, but at this size one run's logz moves with
its surrogate and chains (mostly through the IS term of 100 draws) by
about twice its quoted error: each run's error is the JAX package's
run-to-run spread, ``JAX_LOGZ_SD``, measured over seeds with ``PYTHONPATH=.
python tests/test_torch_recipe.py 27 28 29 30 31 32``, which prints both
packages' logz and its two parts.
"""

import sys
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

import bayesfast_tpu as bf
from bayesfast_tpu import evidence as jev
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
# the standard deviation of the JAX package's whole-run logz over seeds 27
# and 29-32 at this configuration (float64; its seed 28 gives NaN), against
# quoted errors of 0.12-0.39
JAX_LOGZ_SD = 0.503


def _forward():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(M, D)) / np.sqrt(D)
    B = rng.normal(size=(M, 3, 3)) / 6.0
    B = (B + np.swapaxes(B, 1, 2)) / 2

    def forward(x, *args, **kwargs):
        x = np.asarray(x)
        return A @ x + np.einsum('dij,i,j->d', B, x[NL], x[NL])

    return forward


def _recipe(pkg, evidence_method=None):
    """The tiny DES-like Recipe of one package (``bf`` or ``bt``), its
    PostStep with ``evidence_method``."""
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
    post = pkg.recipe.PostStep(n_is=N_IS, k_trunc=0.25,
                               evidence_method=evidence_method)
    return pkg.Recipe(density=den, optimize=opt, sample=sam, post=post)


def _weighted_mean(rec):
    """The IS-weighted posterior mean of a finished Recipe."""
    res = rec.get()
    w = res.weights_trunc
    return np.sum(res.samples * w[:, None], axis=0) / np.sum(w)


def _recording(rec):
    """A Recipe (of either package) with its PostStep GBS keeping its own
    result, the surrogate evidence (logz_q, err_q), as
    ``surrogate_evidence``."""
    gbs = rec.recipe_trace._s_post.evidence_method
    run = gbs.run

    def recorded(*args, **kwargs):
        gbs.surrogate_evidence = run(*args, **kwargs)
        return gbs.surrogate_evidence
    gbs.run = recorded
    return rec


def _run_quiet(rec):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        rec.run()
    return rec


@pytest.fixture(scope='module')
def finished():
    """The JAX Recipe at the first seed and the port's at each of SEEDS,
    run to the end, each PostStep with GBS evidence."""
    old = bf.config.get_nuts_kernel()
    bf.config.set_nuts_kernel('xla')
    try:
        bf.utils.set_generator(SEEDS[0])
        rj = _run_quiet(_recipe(bf, 'GBS'))
    finally:
        bf.config.set_nuts_kernel(old)
    runs = []
    for seed in SEEDS:
        bt.utils.set_generator(seed)
        runs.append(_run_quiet(_recording(_recipe(bt, 'GBS'))))
    return rj, runs


def test_recipe_matches_jax(finished):
    rj, runs = finished
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


def test_post_step_gbs_matches_jax(finished):
    rj, runs = finished
    res_j = rj.get()
    assert np.isfinite(res_j.logz) and res_j.logz_err > 0
    for seed, rt in zip(SEEDS, runs):
        res = rt.get()
        gbs = rt.recipe_trace._s_post.evidence_method
        assert gbs.sit.last_routes == ['host'] * gbs.sit.i_iter
        logz_q, err_q = gbs.surrogate_evidence
        assert np.isfinite(logz_q) and err_q > 0

        def surrogate(x):
            return np.asarray(rt._surro_logp(np.asarray(x)), np.float64)

        # the JAX package's IS term on the port run's IS draws
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            is_term = bf.Recipe._evidence_with_is(
                SimpleNamespace(_surro_logp=surrogate),
                SimpleNamespace(evidence_method=SimpleNamespace(
                    run=lambda **kw: (0.0, 0.0))),
                res.x_q, res.logq_q, res.logp, res.logq)
        np.testing.assert_allclose(res.logz, logz_q + is_term[0], rtol=1e-10)
        np.testing.assert_allclose(res.logz_err, np.hypot(err_q, is_term[1]),
                                   rtol=1e-10)
        # the JAX package's GBS on the port run's surrogate trace, with the
        # port's proposal count
        n_q = gbs._proposal_count(res.x_q, res.trace_q.n_call)
        bf.utils.set_generator(seed)
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            jz_q, jerr_q = jev.GBS(n_q=n_q).run(res.x_q, surrogate,
                                                res.logq_q)
        assert abs(logz_q - jz_q) < 4 * np.hypot(err_q, jerr_q), (
            logz_q, err_q, jz_q, jerr_q)
        # the whole runs, each with the JAX package's spread over seeds
        assert abs(res.logz - res_j.logz) < 4 * np.sqrt(2.0) * JAX_LOGZ_SD, (
            res.logz, res_j.logz)


def _seed_scan(seeds, big):
    """Each package's whole-run logz +- error, and its two parts, over
    ``seeds``, at this file's configuration or (``big``) at 8 chains x 600
    (300 warmup) and n_is 1000."""
    global TRACE, N_IS
    if big:
        TRACE, N_IS = {'n_chain': 8, 'n_iter': 600, 'n_warmup': 300}, 1000
    bf.config.set_nuts_kernel('xla')
    tconfig.set_device('cpu')
    for pkg in (bf, bt):
        for seed in seeds:
            pkg.utils.set_generator(seed)
            rec = _run_quiet(_recording(_recipe(pkg, 'GBS')))
            res = rec.get()
            z_q, e_q = rec.recipe_trace._s_post.evidence_method \
                .surrogate_evidence
            print(f'{pkg.__name__} seed {seed}: logz {res.logz:.4f} +- '
                  f'{res.logz_err:.4f} = logz_q {z_q:.4f} +- {e_q:.4f} + IS '
                  f'term {res.logz - z_q:.4f}; n_call {res.n_call}',
                  flush=True)


if __name__ == '__main__':
    # PYTHONPATH=. python tests/test_torch_recipe.py [--big] [seed ...]
    # from the repo's root; the JAX settings of tests/conftest.py (x64, 8
    # CPU devices) first
    import os
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import conftest  # noqa: F401
    args = sys.argv[1:]
    _seed_scan([int(a) for a in args if a != '--big'] or list(range(27, 33)),
               '--big' in args)
