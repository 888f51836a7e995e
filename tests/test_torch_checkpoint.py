"""Checkpoint and resume (``utils/checkpoint.py``), and the sampler
dispatch of ``sample``.

(a) For every sampler: a run cut at iteration n (inside warmup), saved,
loaded and continued is bitwise equal to an uninterrupted run with the
same seed, draws and logp; the loaded carry's tensors are CPU tensors.
NUTS runs both on the plain versions of its chunk kernels (a density with
``kernel_spec()``) and on the tree loop; HMC both on that density's
analytic form and through autograd. (b) A Recipe saved and loaded
through ``checkpoint``, finished and mid-run. (c) ``sampler='X'`` and the
trace types name the same sampler, ``TraceTuple.sampler`` reads it back,
and an odd ensemble ``n_chain`` raises ``ValueError``, as in the JAX
package.
"""

import os
import pickle
import warnings

import numpy as np
import pytest
import torch

import bayesfast_tpu_torch as bt
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.modules import Gaussian, PolyConfig, PolyModel
from bayesfast_tpu_torch.utils import checkpoint


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


D = 3


def _std_normal_logp(x):
    # abs keeps the logp outside the CUDA kernels' op set, so that NUTS
    # takes the tree loop (a traceable logp takes the kernels' path)
    return -0.5 * torch.sum(torch.abs(x) ** 2, -1)


def _wide_logp(x):
    return -0.125 * torch.sum(x ** 2, -1)


def _density(kernel=False):
    if kernel:
        return bt.DensityLite(
            logp=bt.ops.DiagGaussian(np.zeros(D), np.ones(D),
                                     dtype=torch.float64), input_size=D)
    return bt.DensityLite(logp=_std_normal_logp, input_size=D)


# (sampler, kind): kind picks the density and the extra trace options
CASES = [('NUTS', 'kernel'), ('NUTS', 'tree'), ('HMC', None),
         ('HMC', 'kernel'), ('CHEES', None), ('TNUTS', None),
         ('THMC', None), ('Ensemble', None)]


def _config(sampler):
    cfg = {'n_chain': 8, 'n_iter': 160, 'n_warmup': 100}
    if sampler in ('TNUTS', 'THMC'):
        cfg['density_base'] = bt.DensityLite(logp=_wide_logp, input_size=D)
    if sampler in ('HMC', 'THMC'):
        cfg['n_int_step'] = 6
    return cfg


def _leaves(obj):
    if torch.is_tensor(obj):
        return [obj]
    if isinstance(obj, tuple):
        return [t for o in obj for t in _leaves(o)]
    return []


@pytest.mark.parametrize('sampler, kind', CASES)
def test_resume_is_bitwise(tmp_path, sampler, kind):
    den = _density(kind == 'kernel')
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        bt.utils.set_generator(42)
        tt_a = bt.sample(den, _config(sampler), sampler=sampler,
                         verbose=False)
        bt.utils.set_generator(42)
        tt_b = bt.sample(den, _config(sampler), sampler=sampler, n_run=70,
                         verbose=False, n_update=30)
        path = os.path.join(tmp_path, 'trace.pkl')
        # the trace and the TraceTuple save alike
        saved = tt_b.trace if sampler == 'HMC' else tt_b
        saved.save(path)
        tt_c = bt.TraceTuple.load(path)
        assert type(tt_c) is type(saved)
        carry = (tt_c if isinstance(tt_c, bt.SampleTrace)
                 else tt_c.trace)._carry
        assert all(t.device.type == 'cpu' for t in _leaves(carry))
        tt_c = bt.sample(den, tt_c, verbose=False, n_update=17)
    assert tt_c.i_iter == 160 and tt_c.sampler == sampler
    assert np.array_equal(tt_a.samples, tt_c.samples)
    assert np.array_equal(tt_a.logp, tt_c.logp)
    for k, v in tt_a.trace._stats_arrays.items():
        assert np.array_equal(v, tt_c.trace._stats_arrays[k]), k
    if kind == 'kernel' and sampler == 'NUTS':
        assert tt_a.trace._stats_arrays['tree_size'].max() > 1


def test_pickle_lowers_tensors(tmp_path):
    """Every tensor a checkpoint holds is a CPU tensor, at any depth; the
    trace's driver cache is left out."""
    den = _density()
    bt.utils.set_generator(3)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        tt = bt.sample(den, {'n_chain': 4, 'n_iter': 40, 'n_warmup': 20},
                       sampler='CHEES', verbose=False)
    assert tt.trace._driver_cache is not None
    path = os.path.join(tmp_path, 'c.pkl')
    checkpoint.save({'nested': [tt, (torch.ones(2),)]}, path)
    with open(path, 'rb') as f:
        obj = pickle.load(f)
    tr = obj['nested'][0].trace
    assert not hasattr(tr, '_driver_cache')
    assert isinstance(tr._carry.step, bt.samplers.chees.CheesAdaptState)
    assert torch.equal(obj['nested'][1][0], torch.ones(2))


# ---- a Recipe through checkpoint (module-level callables pickle) ----

RD, RM, RNL = 4, 12, np.arange(2)
_RNG = np.random.default_rng(0)
_A = _RNG.normal(size=(RM, RD)) / 2
_B = _RNG.normal(size=(RM, 2, 2)) / 6


def _forward(x, *args, **kwargs):
    x = np.asarray(x)
    return _A @ x + np.einsum('dij,i,j->d', _B, x[RNL], x[RNL])


def _recipe():
    trace = {'n_chain': 8, 'n_iter': 40, 'n_warmup': 20}
    model = bt.Module(fun=_forward, input_vars='x', output_vars='m',
                      input_shapes=[RD], output_shapes=[RM], traceable=False)
    like = Gaussian(mean=_forward(np.full(RD, 0.1)), cov=np.full(RM, 0.05),
                    input_vars='m', output_vars='logp')
    den = bt.Density(density_name='logp', module_list=[model, like],
                     input_vars='x', input_shapes=[RD],
                     input_scales=np.stack([np.full(RD, -5.),
                                            np.full(RD, 5.)]).T,
                     hard_bounds=True, decay_options={'use_decay': True})
    s0 = PolyModel('linear', input_size=RD, output_size=RM, input_vars='x',
                   output_vars='m')
    s1 = PolyModel([PolyConfig('linear'),
                    PolyConfig('quadratic', input_mask=RNL)],
                   input_size=RD, output_size=RM, input_vars='x',
                   output_vars='m')
    return bt.Recipe(
        density=den,
        optimize=bt.recipe.OptimizeStep(surrogate_list=s0, alpha_n=2,
                                        max_iter=2, sample_trace=trace),
        sample=bt.recipe.SampleStep(surrogate_list=s1, alpha_n=2,
                                    logp_cutoff=False,
                                    sample_trace=dict(trace)),
        post=bt.recipe.PostStep(n_is=50, k_trunc=0.25))


def test_recipe_checkpoint(tmp_path):
    path = os.path.join(tmp_path, 'recipe.pkl')
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        bt.utils.set_generator(5)
        rec = _recipe()
        rec.recipe_trace  # noqa: B018 (built before the first phase)
        rec._opt_step()
        rec.save(path)
        loaded = bt.Recipe.load(path)
        assert loaded.recipe_trace.finished.optimize
        assert not loaded.recipe_trace.finished.sample
        loaded.run()
        res = loaded.get()
        assert np.isfinite(res.samples).all()
        assert res.samples.shape[-1] == RD
        # a finished Recipe comes back with the same result
        loaded.save(path)
        again = bt.Recipe.load(path)
    assert again.recipe_trace.finished.post
    assert np.array_equal(again.get().samples, res.samples)
    assert np.array_equal(again.get().weights, res.weights)
    tr = again.recipe_trace.results.sample[-1].sample_trace.trace
    assert all(t.device.type == 'cpu' for t in _leaves(tr._carry))


# ---- dispatch ----

TRACE_TYPES = {'NUTS': bt.NTrace, 'HMC': bt.HTrace, 'TNUTS': bt.TNTrace,
               'THMC': bt.THTrace, 'CHEES': bt.CTrace, 'Ensemble': bt.ETrace}


@pytest.mark.parametrize('sampler', list(TRACE_TYPES))
def test_sampler_dispatch(sampler):
    den = _density()
    cfg = dict(_config(sampler), n_iter=30, n_warmup=15)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        bt.utils.set_generator(1)
        by_name = bt.sample(den, dict(cfg), sampler=sampler, verbose=False)
        # a trace of the type: its type names the sampler
        bt.utils.set_generator(1)
        by_type = bt.sample(den, TRACE_TYPES[sampler](**cfg), verbose=False)
    assert type(by_name.trace) is TRACE_TYPES[sampler]
    assert by_name.sampler == by_type.sampler == sampler
    assert np.array_equal(by_name.samples, by_type.samples)
    items = set(by_name.trace._stats_items)
    assert set(by_name.trace._stats_arrays) == items
    assert by_name.samples.shape == (8, 30, D)


def test_unknown_sampler_raises():
    with pytest.raises(ValueError):
        bt.sample(_density(), {'n_chain': 4}, sampler='MALA', verbose=False)


def test_odd_ensemble_raises():
    with pytest.raises(ValueError, match='even'):
        bt.sample(_density(), {'n_chain': 7, 'n_iter': 20, 'n_warmup': 10},
                  sampler='Ensemble', verbose=False)
