"""The compiled-in surrogate density with cubic PolyModel configs and the
surrogate's own input scales, on the CPU in float64, beside the parity
tests of ``test_torch_pipeline.py`` (whose DES-like pipeline, D = 6
parameters and a 24-dim data vector, and ``CONFIGS`` these reuse):

* the ``'cubic-3'`` string expands to index triples in the JAX
  ``PolyConfig``'s order, and each dimension's sparse row holds one entry
  for each place it takes in a triple;
* a small cubic Recipe samples on the chunk paths, no transition on the
  tree loop;
* a linear + quadratic spec gives the plain outputs of the formula before
  cubic configs and scales were compiled in (kept here as the reference)
  bit for bit.
"""

import warnings

import numpy as np
import pytest
import torch

import bayesfast_tpu_torch as bt
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.core import recipe as rmod
from bayesfast_tpu_torch.modules import PolyConfig, PolyModel
from bayesfast_tpu_torch.ops import densities as tdens

from test_torch_pipeline import (CONFIGS, D, SCALES, TRUTH, _density,  # noqa
                                 _fitted_pair, _model, _poly)


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


def test_sugar_expands_to_every_order():
    """``PolyModel('cubic-3')`` is linear + quadratic + cubic-2 + cubic-3
    on every input: 7 + 21 + 36 + 20 features, their index triples in the
    JAX ``PolyConfig``'s order; every dimension's sparse row holds one
    entry for each place it takes in a triple."""
    _, den_t, _ = _fitted_pair(case='sugar')
    spec = den_t.kernel_spec()
    trip = spec['index']['trip'].numpy().T
    assert trip.shape == (84, 3) and spec['scalars'][3] == 84
    assert trip[0].tolist() == [D, D, D]
    assert trip[1].tolist() == [0, D, D]
    assert trip[7].tolist() == [0, 0, D]            # quadratic (0, 0)
    assert trip[28].tolist() == [0, 0, 0]           # cubic-2 (0, 0)
    assert trip[29].tolist() == [0, 0, 1]           # cubic-2 (0, 1)
    assert trip[64].tolist() == [0, 1, 2]           # cubic-3 (0, 1, 2)
    assert trip[-1].tolist() == [3, 4, 5]
    NNZ = int(spec['scalars'][4])
    assert NNZ == int(np.sum(trip < D))
    fidx, p1, p2 = spec['index']['rows'].numpy()
    for d in range(D):
        ent = [(f, a, b) for f, a, b in zip(fidx[d], p1[d], p2[d])
               if f < 84]
        want = [(f, *(t[:i] + t[i + 1:])) for f, t in
                enumerate(trip.tolist()) for i in range(3) if t[i] == d]
        assert ent == want


def test_cubic_recipe_samples_on_the_chunk_paths():
    """A tiny DES-like Recipe whose sample steps fit a cubic surrogate with
    its own input scales: every transition on the chunk kernels' plain
    versions (none on the tree loop), the kernel spec live in each step,
    and a finite importance-sampled result."""
    forward, data = _model(cubic=True)
    den, _ = _density(bt, forward, data)
    s0 = _poly(PolyConfig, PolyModel, 'linear', None, True)
    s1 = _poly(PolyConfig, PolyModel, CONFIGS['mix'], SCALES, True)
    trace = {'n_chain': 8, 'n_iter': 40, 'n_warmup': 20}
    opt = bt.recipe.OptimizeStep(surrogate_list=s0, alpha_n=2, max_iter=2,
                                 sample_trace=dict(trace))
    sam = bt.recipe.SampleStep(surrogate_list=s1, alpha_n=2,
                               logp_cutoff=False, sample_trace=dict(trace))
    rec = bt.Recipe(density=den, optimize=opt, sample=sam,
                    post=bt.recipe.PostStep(n_is=50, k_trunc=0.25))
    specs = []
    sample = rmod.sample

    def spy(density, *a, **kw):
        specs.append(density.kernel_spec() if density.has_kernel_spec
                     else None)
        return sample(density, *a, **kw)

    bt.utils.set_generator(11)
    n0 = bt.samplers.nuts.nuts_transition_batched.transitions
    rmod.sample = spy
    try:
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            rec.run()
    finally:
        rmod.sample = sample
    assert bt.samplers.nuts.nuts_transition_batched.transitions == n0
    assert len(specs) >= 2 and all(sp is not None for sp in specs)
    # the sample step's spec: the cubic features and the scales
    assert specs[-1]['scalars'][3] == s1.n_param
    np.testing.assert_array_equal(specs[-1]['arrays']['sdiff'].numpy(),
                                  SCALES[:, 1] - SCALES[:, 0])
    res = rec.get()
    assert rec.recipe_trace.finished == (True, True, True)
    assert res.samples.shape == (50, D)
    assert np.all(np.isfinite(res.samples)) and np.all(res.weights > 0)
    assert res.n_call >= 2 * s1.n_param


# ---------------------------------------------------------------------------
# The formula before cubic configs and surrogate scales were compiled in
# (linear and quadratic configs, two indices a feature), the reference that
# the linear + quadratic outputs must still equal bit for bit.

def _pre_cubic_index(dim, configs):
    D = dim
    i1, i2 = [], []
    for order, im, _, _ in configs:
        im = np.asarray(im, int)
        if order == 'linear':
            i1 += [D] + list(im)
            i2 += [D] * (1 + im.size)
        else:
            k, l = np.triu_indices(im.size)
            i1 += list(im[k])
            i2 += list(im[l])
    F = len(i1)
    rows = [[] for _ in range(D)]
    for f in range(F):
        if i1[f] < D:
            rows[i1[f]].append((f, i2[f]))
        if i2[f] < D:
            rows[i2[f]].append((f, i1[f]))
    L = max(1, max(len(r) for r in rows))
    fidx = np.full((D, L), F)
    pidx = np.full((D, L), D)
    for d, r in enumerate(rows):
        for t, (f, p) in enumerate(r):
            fidx[d, t], pidx[d, t] = f, p
    return [torch.as_tensor(np.asarray(a, np.int64))
            for a in (i1, i2, fidx, pidx)]


def _pre_cubic_lpg(spec, index, x, ordered):
    mv, sm = tdens._ops(ordered)
    a = spec['arrays']
    i1, i2, fidx, pidx = index
    (nrm, gamma, M_, F, NNZ, bound_on, decay_on, alpha, alpha_2,
     full) = spec['scalars']
    C_ = x.shape[0]

    def sc(v):
        return (torch.as_tensor(v, dtype=x.dtype) if ordered else float(v))

    alpha, gamma, alpha_2 = sc(alpha), sc(gamma), sc(alpha_2)
    outside = torch.zeros(C_, dtype=torch.bool)
    x0 = x
    if bound_on:
        delta = x - a['mup']
        hdel = mv(a['Hp'], delta)
        b2 = torch.clamp(sm(delta * hdel), min=1e-30)
        beta = torch.sqrt(b2)
        outside = beta > alpha
        bc = beta[:, None]
        x0 = torch.where(outside[:, None],
                         (alpha * x + (bc - alpha) * a['mup']) / bc, x)
    xa = torch.cat([x0, torch.ones_like(x0[:, :1])], dim=-1)
    phi = xa[:, i1] * xa[:, i2]
    if ordered:
        m0 = torch.zeros((C_, M_), dtype=x.dtype)
        for f in range(F):
            m0 = m0 + a['WT'][f] * phi[:, f:f + 1]
    else:
        m0 = phi @ a['WT']
    m = m0
    if bound_on:
        m = torch.where(outside[:, None],
                        (bc * m0 - (bc - alpha) * a['fmu']) / alpha, m0)
    r = m - a['dat']
    if full:
        if ordered:
            pr = torch.zeros_like(r)
            for k in range(M_):
                pr = pr + a['P'][k] * r[:, k:k + 1]
        else:
            pr = r @ a['P']
        gm = -pr
        logp = -0.5 * sm(r * pr) + sc(nrm)
    else:
        rv = r * a['vinv']
        gm = -rv
        logp = -0.5 * sm(rv * r) + sc(nrm)
    gm0 = gm
    if bound_on:
        gm0 = torch.where(outside[:, None], gm * bc / alpha, gm)
    gphi = (tdens.warp_sum(a['WT'][None] * gm0[:, None, :]) if ordered
            else gm0 @ a['WT'].T)
    gphi = torch.cat([gphi, torch.zeros_like(gphi[:, :1])], dim=-1)
    g = torch.zeros_like(x)
    for t in range(fidx.shape[1]):
        g = g + gphi[:, fidx[:, t]] * xa[:, pidx[:, t]]
    if bound_on:
        s_beta = sm(gm * (m0 - a['fmu'])) / alpha
        dldb = s_beta + sm(g * (a['mup'] - x0)) / beta
        g = torch.where(outside[:, None],
                        g * alpha / bc + dldb[:, None] * hdel / bc, g)
    dec = torch.zeros_like(logp)
    if decay_on:
        dd = x - a['mud']
        hdd = mv(a['Hd'], dd)
        ex = sm(dd * hdd) - alpha_2
        pos = ex > 0
        dec = torch.where(pos, gamma * ex, dec)
        g = torch.where(pos[:, None], g - gamma * (2.0 * hdd), g)
    return logp - dec, g


@pytest.mark.parametrize('cov', ['diag', 'full'])
@pytest.mark.parametrize('bound', [False, True], ids=['nobound', 'bound'])
def test_quadratic_outputs_are_the_pre_cubic_formulas(bound, cov):
    """The linear + quadratic density of ``test_torch_pipeline.py``,
    fitted by the port: the spec's plain logp and gradient, in the
    kernels' order and in dense calls, equal the two-index formula's bit
    for bit, at points inside and beyond the bound and the decay."""
    forward, data = _model()
    den, su = _density(bt, forward, data, cov, bound=bound)
    rng = np.random.default_rng(3)
    den.fit(den.fun(TRUTH + rng.normal(size=(60, D)) * 0.3,
                    original_space=True, use_surrogate=False))
    den.use_surrogate = True
    spec = den.kernel_spec()
    index = _pre_cubic_index(D, den._kernel_sources()['configs'])
    xo = np.concatenate([TRUTH + rng.normal(size=(20, D)) * 0.2,
                         rng.uniform(-4.5, 4.5, size=(20, D))])
    x = torch.as_tensor(xo)
    for ordered in (True, False):
        lp, g = tdens._poly_gaussian_lpg(spec, x, ordered)
        lp0, g0 = _pre_cubic_lpg(spec, index, x, ordered)
        assert torch.equal(lp, lp0) and torch.equal(g, g0), ordered
    if bound:
        beta = np.sqrt(np.einsum('ij,jk,ik->i', xo - su._mu, su._hess,
                                 xo - su._mu))
        assert (beta <= su._alpha).any() and (beta > su._alpha).any()
