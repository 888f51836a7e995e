"""The JAX package's ``DensityLite`` signature on the port
(``bayesfast_tpu_torch/core/density.py``), and the rest of the reference's
public signatures that the port had lacked, on the CPU.

* Every branch of ``DensityLite``'s evaluation against the JAX package's
  ``logp``, ``grad`` and ``logp_and_grad`` (``bayesfast_tpu/core/
  density.py:183-250``), rtol 1e-12 in float64: a logp alone (autograd),
  ``logp`` with ``grad``, ``logp_and_grad`` alone and with ``logp``; in
  the original and the transformed space; without bounds and with a mix
  of two-sided, lower and upper ones; the port's batched form and
  ``vectorized=False`` (the JAX package's form); ``logp_args`` and
  ``logp_kwargs``.
* ``traceable=False``: an external numpy logp, its rows over the host
  pool. Each combination with or without the user's gradient does what
  the JAX package does: without one a gradient raises, and ``sample()``
  raises before any device work; with ``grad`` the kernels cannot run it,
  so 'auto' warns once and samples on the tree loop, and 'cuda' raises;
  with ``logp_and_grad`` the pair traces and the kernels run it. Twins of
  ``tests/test_external.py``'s ``DensityLite`` checks (the concurrency
  bound at 0.6 of the serial time: 0.5 failed once on a loaded machine).
* A deliberately wrong gradient (the true one times 2) is the one the
  kernels' plain version, the tree loop and the start-up use: nothing
  swaps in autograd.
* The trace of the user's pair: its interpreter against the user's eager
  functions, its key following ``logp_args`` tensors changed in place, and
  the routing of a pair that does not trace.
* ``nuts_transition`` and ``tnuts_transition`` against the batched forms
  on a batch of one, bit for bit; ``ParallelBackend.map_async`` and
  ``gather``; ``config.set_matmul_precision``, ``asarray`` and
  ``default_int``; the new keyword arguments; ``fit_spline_columns(
  speculative=False)``.
"""

import importlib
import operator
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesfast_tpu as bf
import bayesfast_tpu_torch as bt
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.examples.user_densities import (bench_banana,
                                                         bench_banana_user)
from bayesfast_tpu_torch.ops.trace import trace_density
from bayesfast_tpu_torch.samplers import nuts as ttree
from bayesfast_tpu_torch.samplers import nuts_cuda as tnc
from bayesfast_tpu_torch.samplers import tempered as ttemp
from bayesfast_tpu_torch.samplers.metrics import init_diag_metric
from bayesfast_tpu_torch.utils import parallel
from bayesfast_tpu_torch.utils.random import generator_from_seed

# the module, which the package's ``sample`` function shadows
tsample = importlib.import_module('bayesfast_tpu_torch.core.sample')

D = 4
RTOL = 1e-12


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU,
    in float64, with the kernels' mode as it was."""
    old = tconfig.set_device('cpu')
    old_dtype, old_mode = tconfig.get_dtype(), tconfig.get_nuts_kernel()
    tconfig.set_dtype(torch.float64)
    yield
    tconfig.set_device(old)
    tconfig.set_dtype(old_dtype)
    tconfig.set_nuts_kernel(old_mode)


# ---------------------------------------------------------------------------
# One density in both packages: a coupled quartic with an offset and a
# scale passed as logp_args / logp_kwargs,
#   logp(x) = -sum((x - mu)^2 / (2 s^2)) - c sum(x_i x_{i+1}) - q sum(x^4),
# x_{D} = x_0. The gradient closes over mu and s.

MU = np.array([0.3, -0.2, 0.5, 0.1])
S, C_COUP, Q4 = 1.3, 0.2, 0.05


def _jax_fns():
    mu = jnp.asarray(MU)

    def logp(x, mu, s=1.0):
        return (-jnp.sum((x - mu) ** 2) / (2 * s ** 2)
                - C_COUP * jnp.sum(x * jnp.roll(x, -1))
                - Q4 * jnp.sum(x ** 4))

    def grad(x):
        return (-(x - mu) / S ** 2
                - C_COUP * (jnp.roll(x, -1) + jnp.roll(x, 1))
                - 4 * Q4 * x ** 3)

    def lpg(x):
        return logp(x, mu, s=S), grad(x)

    return logp, grad, lpg


def _torch_fns(vectorized):
    mu = torch.as_tensor(MU)
    dim = -1 if vectorized else 0

    def logp(x, mu, s=1.0):
        return (-torch.sum((x - mu) ** 2, dim=-1) / (2 * s ** 2)
                - C_COUP * torch.sum(x * torch.roll(x, -1, dims=dim),
                                     dim=-1)
                - Q4 * torch.sum(x ** 4, dim=-1))

    def grad(x):
        return (-(x - mu) / S ** 2
                - C_COUP * (torch.roll(x, -1, dims=dim)
                            + torch.roll(x, 1, dims=dim))
                - 4 * Q4 * x ** 3)

    def lpg(x):
        return logp(x, mu, s=S), grad(x)

    return logp, grad, lpg


FORMS = ('logp', 'logp_grad', 'logp_and_grad', 'logp_logp_and_grad')
BOUNDS = {
    'none': dict(),
    'mixed': dict(input_scales=np.array([[-2., 3.], [-4., 2.], [-1., 4.],
                                         [-3., 3.]]),
                  hard_bounds=np.array([[True, True], [True, False],
                                        [False, True], [False, False]])),
}


def _kwargs(form, fns, package):
    logp, grad, lpg = fns
    mu = jnp.asarray(MU) if package == 'jax' else torch.as_tensor(MU)
    args = dict(logp_args=(mu,), logp_kwargs={'s': S})
    if form == 'logp':
        return dict(logp=logp, **args)
    if form == 'logp_grad':
        return dict(logp=logp, grad=grad, **args)
    if form == 'logp_and_grad':
        return dict(logp_and_grad=lpg)
    return dict(logp=logp, logp_and_grad=lpg, **args)


_JAX = {}


def _jax_density(form, bounds):
    if (form, bounds) not in _JAX:
        _JAX[form, bounds] = bf.DensityLite(
            input_size=D, **_kwargs(form, _jax_fns(), 'jax'),
            **BOUNDS[bounds])
    return _JAX[form, bounds]


def _points(n=7, seed=0):
    """Points inside every bound (original space)."""
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(size=(n, D)), -0.9, 0.9)


@pytest.mark.parametrize('vectorized', [True, False],
                         ids=['batched', 'one_point'])
@pytest.mark.parametrize('bounds', list(BOUNDS))
@pytest.mark.parametrize('form', FORMS)
def test_branches_match_jax(form, bounds, vectorized):
    den_j = _jax_density(form, bounds)
    den_t = bt.DensityLite(input_size=D, vectorized=vectorized,
                           **_kwargs(form, _torch_fns(vectorized), 'torch'),
                           **BOUNDS[bounds])
    assert den_t.has_grad == den_j.has_grad
    assert den_t.has_logp == den_j.has_logp
    assert den_t.has_logp_and_grad == den_j.has_logp_and_grad
    x_o = _points()
    for os_, x in ((True, x_o), (False, den_t.from_original(x_o))):
        np.testing.assert_allclose(den_t.logp(x, original_space=os_),
                                   den_j.logp(x, original_space=os_),
                                   rtol=RTOL)
        lp_t, g_t = den_t.logp_and_grad(x, original_space=os_)
        lp_j, g_j = den_j.logp_and_grad(x, original_space=os_)
        np.testing.assert_allclose(lp_t, lp_j, rtol=RTOL)
        np.testing.assert_allclose(g_t, g_j, rtol=RTOL,
                                   atol=RTOL * np.abs(g_j).max())
        np.testing.assert_allclose(den_t.grad(x, original_space=os_),
                                   g_j, rtol=RTOL,
                                   atol=RTOL * np.abs(g_j).max())
        # one point: a scalar and a (D,) gradient, as the JAX package
        lp1, g1 = den_t.logp_and_grad(x[0], original_space=os_)
        assert np.shape(lp1) == () and g1.shape == (D,)
        np.testing.assert_allclose(lp1, lp_j[0], rtol=RTOL)


def test_use_surrogate_is_accepted():
    den = bt.DensityLite(input_size=D, **_kwargs('logp', _torch_fns(True),
                                                 'torch'))
    x = torch.as_tensor(_points())
    lp = den.device_logp(True, use_surrogate=False)(x)
    lp2, _ = den.device_logp_and_grad(True, use_surrogate=None)((), x)
    assert torch.equal(lp, lp2)


def test_batched_shape_check_names_vectorized():
    """A logp of one point in the batched default: the shape check names
    ``vectorized=False``, which takes that form."""
    logp = lambda x: -0.5 * (x * x).sum()  # noqa: E731
    with pytest.raises(ValueError, match='vectorized=False'):
        bt.DensityLite(logp=logp, input_size=2).logp(np.ones((3, 2)))
    lp = bt.DensityLite(logp=logp, input_size=2,
                        vectorized=False).logp(np.ones((3, 2)))
    np.testing.assert_array_equal(lp, [-1.0, -1.0, -1.0])


# ---------------------------------------------------------------------------
# The trace of the user's pair

@pytest.mark.parametrize('dtype', [torch.float32, torch.float64],
                         ids=['f32', 'f64'])
@pytest.mark.parametrize('form', ['grad', 'logp_and_grad'])
def test_user_gradient_program_matches_eager(form, dtype):
    """The program traced from the user's pair (no adjoint) against the
    user's own functions, eager; the two forms trace to one program."""
    den, _ = bench_banana_user(form)
    ref, _ = bench_banana_user('grad')
    prog = den.kernel_spec()['program']
    assert prog.source(dtype) == ref.kernel_spec()['program'].source(dtype)
    assert den.has_traced_spec and den.kernel_trace_error() is None
    rng = np.random.default_rng(3)
    x = torch.as_tensor(np.clip(rng.normal(size=(9, 32)) * 1.5, -13, 13),
                        dtype=dtype)
    lp, g = prog.logp_and_grad(x, prog.pack(dtype))
    lp_e, g_e = den.device_logp_and_grad(True)((), x)
    rtol = {torch.float32: 1e-6, torch.float64: 1e-12}[dtype]
    np.testing.assert_allclose(lp.numpy(), lp_e.numpy(), rtol=rtol)
    np.testing.assert_allclose(g.numpy(), g_e.numpy(), rtol=rtol,
                               atol=rtol * g_e.abs().max().item())
    # the user's gradient is the true one: the tracer's adjoint of the
    # logp alone agrees with it
    adj = trace_density(bench_banana()[0]._logp, 32, dtype)
    assert adj.n_ops > prog.n_ops
    _, g_a = adj.logp_and_grad(x, adj.pack(dtype))
    np.testing.assert_allclose(g.numpy(), g_a.numpy(), rtol=rtol,
                               atol=10 * rtol * g_a.abs().max().item())


def test_trace_key_follows_logp_args_in_place():
    """A tensor among ``logp_args`` changed in place gives a new key and new
    packed constants, as a closed-over tensor does."""
    mu = torch.as_tensor(MU.copy())
    den = bt.DensityLite(logp=_torch_fns(True)[0], logp_args=(mu,),
                         logp_kwargs={'s': S}, input_size=D)
    like = torch.zeros(3, D, dtype=torch.float64)
    key_1, par_1 = den.kernel_spec_key(), tnc._spec_for(den, like)[2].clone()
    with torch.no_grad():
        mu.add_(1.0)
    key_2, par_2 = den.kernel_spec_key(), tnc._spec_for(den, like)[2]
    assert key_1 != key_2 and not torch.equal(par_1, par_2)
    x = torch.as_tensor(_points(3))
    lp, _ = tnc.plain_lpg(den)(x)
    np.testing.assert_allclose(
        lp.numpy(), _torch_fns(True)[0](x, mu, s=S).numpy(), rtol=RTOL)


# ---------------------------------------------------------------------------
# A wrong gradient: the user's, everywhere

def _wrong(traceable_grad=True):
    """The quartic with its gradient times 2 (and, for the tree loop, an
    op the kernels do not take, which changes no value); counts the
    gradient's calls."""
    logp, grad, _ = _torch_fns(True)
    calls = []

    def wrong_grad(x):
        calls.append(tuple(x.shape))
        g = 2.0 * grad(x)
        return g if traceable_grad else g + 0.0 * torch.abs(x)

    den = bt.DensityLite(logp=logp, grad=wrong_grad, logp_args=(
        torch.as_tensor(MU),), logp_kwargs={'s': S}, input_size=D,
        **BOUNDS['mixed'])
    auto = bt.DensityLite(logp=logp, logp_args=(torch.as_tensor(MU),),
                          logp_kwargs={'s': S}, input_size=D,
                          **BOUNDS['mixed'])
    return den, auto, calls


def _expected(den, auto, x_t):
    """The wrong gradient in the transformed space: 2 g_o tog + tog2 /
    tog, from the true one's parts."""
    sc, hb = den.input_scales, den.hard_bounds
    from bayesfast_tpu_torch.ops import constraint as con
    x_o = con.to_original(x_t, sc, hb)
    _, g_o = auto.device_logp_and_grad(True)((), x_o)
    tog = con.to_original_grad(x_t, sc, hb)
    return 2.0 * g_o * tog + con.to_original_grad2(x_t, sc, hb) / tog


def test_wrong_gradient_reaches_the_plain_kernels_and_start_up():
    den, auto, calls = _wrong()
    x_t = torch.as_tensor(den.from_original(_points(6, 1)))
    want = _expected(den, auto, x_t)
    _, g_true = auto.device_logp_and_grad(False)((), x_t)
    assert not torch.allclose(want, g_true)
    # the kernels' plain version: the traced pair's interpreter
    assert den.has_traced_spec
    _, g_k = tnc.plain_lpg(den)(x_t)
    np.testing.assert_allclose(g_k.numpy(), want.numpy(), rtol=1e-10,
                               atol=1e-12)
    # a plain frozen chunk: its first leapfrog reads the user's gradient
    var = torch.ones(6, D, dtype=torch.float64)
    eps = torch.full((6,), 0.1, dtype=torch.float64)
    o_u = tnc.nuts_chunk_plain(3, x_t, var, eps, 1, 3, 1000.,
                               tnc.plain_lpg(den), 0)
    o_a = tnc.nuts_chunk_plain(3, x_t, var, eps, 1, 3, 1000.,
                               tnc.plain_lpg(auto), 0)
    assert not torch.equal(o_u['q'], o_a['q'])
    # the start-up: descent and step probe call the user's gradient
    trace = bt.NTrace(n_chain=6, n_iter=4, n_warmup=2, random_generator=1)
    n0 = len(calls)
    tsample._descend_x0(den, x_t.numpy(), trace, torch.float64)
    tsample._find_reasonable_step(den, x_t.numpy(), trace, torch.float64,
                                  0.5)
    assert len(calls) > n0 and all(c == (6, D) for c in calls[n0:])
    lpg = den.device_logp_and_grad(False)
    np.testing.assert_allclose(lpg((), x_t)[1].numpy(), want.numpy(),
                               rtol=1e-12, atol=1e-14)


def test_wrong_gradient_reaches_the_tree_loop():
    """A pair that does not trace (``aten.abs`` in the gradient): 'auto'
    warns once, naming the op, and the tree loop runs the user's
    gradient."""
    den, auto, calls = _wrong(traceable_grad=False)
    assert not den.has_kernel_spec
    assert 'aten.abs' in den.kernel_trace_error()
    tconfig.set_nuts_kernel('auto')
    n0 = ttree.nuts_transition_batched.transitions
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter('always')
        tt = bt.sample(den, bt.NTrace(n_chain=4, n_iter=6, n_warmup=3,
                                      random_generator=5),
                       verbose=False, n_update=3)
    mine = [w for w in rec if 'does not trace' in str(w.message)]
    assert len(mine) == 1 and 'aten.abs' in str(mine[0].message)
    assert ttree.nuts_transition_batched.transitions - n0 == 6
    assert np.isfinite(tt.get()).all()
    # the tree loop's gradient is the user's
    lpg = tt.trace._driver_cache[1]._lpg
    x_t = torch.as_tensor(den.from_original(_points(5, 2)))
    n1 = len(calls)
    np.testing.assert_allclose(lpg(x_t)[1].numpy(),
                               _expected(den, auto, x_t).numpy(),
                               rtol=1e-12, atol=1e-14)
    assert len(calls) == n1 + 1


def test_untraceable_pair_raises_under_cuda():
    """Before any device work: the gradient was called only by the trace,
    at one point, never on the chains."""
    den, _, calls = _wrong(traceable_grad=False)
    tconfig.set_nuts_kernel('cuda')
    try:
        with pytest.raises(NotImplementedError, match='aten.abs'):
            bt.sample(den, bt.NTrace(n_chain=4, n_iter=6, n_warmup=3),
                      verbose=False)
    finally:
        tconfig.set_nuts_kernel('auto')
    assert calls and all(c == (D,) for c in calls)


def test_traced_pair_samples_on_the_kernels_path():
    den, _ = bench_banana_user('grad')
    tconfig.set_nuts_kernel('auto')
    n0 = ttree.nuts_transition_batched.transitions
    with warnings.catch_warnings():
        warnings.simplefilter('error', RuntimeWarning)
        warnings.filterwarnings('ignore', message='.*diverg')
        warnings.filterwarnings('ignore', message='for chain #')
        warnings.filterwarnings('ignore', message='.*tree depth')
        warnings.filterwarnings('ignore', message='.*max_treedepth')
        tt = bt.sample(den, bt.NTrace(n_chain=4, n_iter=8, n_warmup=4,
                                      random_generator=3), verbose=False)
    assert ttree.nuts_transition_batched.transitions == n0
    assert np.isfinite(tt.get()).all()


# ---------------------------------------------------------------------------
# traceable=False

def _ext_logp(x, mu, s=1.0):
    """The quartic of one point in numpy: an external likelihood."""
    x = np.asarray(x)
    return float(-np.sum((x - mu) ** 2) / (2 * s ** 2)
                 - C_COUP * np.sum(x * np.roll(x, -1))
                 - Q4 * np.sum(x ** 4))


def _external(package, grad=None, lpg=None):
    mod = bf if package == 'jax' else bt
    return mod.DensityLite(logp=_ext_logp, grad=grad, logp_and_grad=lpg,
                           input_size=D, traceable=False,
                           logp_args=(MU,), logp_kwargs={'s': S},
                           **BOUNDS['mixed'])


def test_external_densitylite_logp():
    """``tests/test_external.py::test_external_densitylite_logp``'s twin."""
    def ext_logp(x):
        return -0.5 * float(np.sum(np.asarray(x) ** 2))

    den = bt.DensityLite(logp=ext_logp, input_size=2, traceable=False)
    x = np.array([[1.0, 2.0], [0.5, -0.5]])
    lp = den.logp(x, original_space=True)
    assert np.allclose(lp, [-2.5, -0.25])


@pytest.mark.parametrize('os_', [True, False], ids=['original',
                                                    'transformed'])
def test_external_logp_matches_jax(os_):
    den_t, den_j = _external('torch'), _external('jax')
    x = _points(6, 4)
    x = x if os_ else den_t.from_original(x)
    np.testing.assert_allclose(den_t.logp(x, original_space=os_),
                               den_j.logp(x, original_space=os_),
                               rtol=RTOL)


def test_external_without_gradient_raises_as_jax_does(monkeypatch):
    """No gradient through a host logp: the JAX package's callback has no
    JVP, the port raises ValueError naming a surrogate; ``sample()``
    raises before any device work (no launch, no tree-loop transition,
    no descent)."""
    den_t, den_j = _external('torch'), _external('jax')
    x = _points(3)
    with pytest.raises(Exception):
        den_j.logp_and_grad(x)
    with pytest.raises(ValueError, match='surrogate'):
        den_t.logp_and_grad(x)
    with pytest.raises(ValueError, match='surrogate'):
        den_t.device_logp_and_grad(False)((), torch.as_tensor(x))
    assert not den_t.has_kernel_spec
    assert 'traceable=False' in den_t.kernel_trace_error()
    calls = []
    monkeypatch.setattr(tsample, '_descend_x0',
                        lambda *a, **k: calls.append(a))
    monkeypatch.setattr(tsample, '_init_carry',
                        lambda *a, **k: calls.append(a))
    n0 = ttree.nuts_transition_batched.transitions
    for mode in ('auto', 'cuda'):
        tconfig.set_nuts_kernel(mode)
        try:
            for sampler in ('NUTS', 'HMC'):
                with pytest.raises(ValueError, match='surrogate'):
                    bt.sample(den_t, {'n_chain': 4, 'n_iter': 6,
                                      'n_warmup': 3}, sampler=sampler,
                              verbose=False)
        finally:
            tconfig.set_nuts_kernel('auto')
    assert not calls and ttree.nuts_transition_batched.transitions == n0
    monkeypatch.undo()
    # the gradient-free ensemble samples it, as in the JAX package
    tt = bt.sample(den_t, bt.ETrace(n_chain=8, n_iter=6, n_warmup=3,
                                    random_generator=2), sampler='Ensemble',
                   verbose=False)
    assert np.isfinite(tt.get()).all()


def _torch_grad(x):
    return _torch_fns(True)[1](x)


def _torch_lpg(x):
    return _torch_fns(True)[2](x)


@pytest.mark.parametrize('os_', [True, False], ids=['original',
                                                    'transformed'])
@pytest.mark.parametrize('kind', ['grad', 'logp_and_grad'])
def test_external_with_gradient_matches_jax(kind, os_):
    """With the user's gradient, the JAX package evaluates the external
    logp on the host and the gradient as given (``logp_and_grad`` alone
    where it is given); so does the port."""
    jf = _jax_fns()
    if kind == 'grad':
        den_t, den_j = _external('torch', grad=_torch_grad), \
            _external('jax', grad=jf[1])
    else:
        den_t, den_j = _external('torch', lpg=_torch_lpg), \
            _external('jax', lpg=jf[2])
    x = _points(5, 6)
    x = x if os_ else den_t.from_original(x)
    lp_t, g_t = den_t.logp_and_grad(x, original_space=os_)
    lp_j, g_j = den_j.logp_and_grad(x, original_space=os_)
    np.testing.assert_allclose(lp_t, lp_j, rtol=RTOL)
    np.testing.assert_allclose(g_t, g_j, rtol=RTOL,
                               atol=RTOL * np.abs(g_j).max())


def test_external_with_grad_takes_the_tree_loop():
    """``grad`` with an external logp: the kernels cannot run the host
    call, so 'auto' warns once and samples on the tree loop (the JAX
    package's kernel fails to lower its callback and falls back to XLA),
    and 'cuda' raises before any device work."""
    den = _external('torch', grad=_torch_grad)
    assert not den.has_kernel_spec
    tconfig.set_nuts_kernel('auto')
    n0 = ttree.nuts_transition_batched.transitions
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter('always')
        tt = bt.sample(den, bt.NTrace(n_chain=4, n_iter=6, n_warmup=3,
                                      random_generator=7),
                       verbose=False, n_update=3)
    mine = [w for w in rec if 'does not trace' in str(w.message)]
    assert len(mine) == 1 and 'traceable=False' in str(mine[0].message)
    assert ttree.nuts_transition_batched.transitions - n0 == 6
    assert np.isfinite(tt.get()).all()
    tconfig.set_nuts_kernel('cuda')
    try:
        with pytest.raises(NotImplementedError, match='traceable=False'):
            bt.sample(den, bt.NTrace(n_chain=4, n_iter=6, n_warmup=3),
                      verbose=False)
    finally:
        tconfig.set_nuts_kernel('auto')


def test_external_with_logp_and_grad_takes_the_kernels():
    """``logp_and_grad`` with an external logp: the gradient path never
    calls the host logp (as in the JAX package), so the pair traces and
    the kernels' path runs it; host ``logp()`` still goes to the host."""
    den = _external('torch', lpg=_torch_lpg)
    assert den.has_traced_spec
    tconfig.set_nuts_kernel('auto')
    n0 = ttree.nuts_transition_batched.transitions
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        tt = bt.sample(den, bt.NTrace(n_chain=4, n_iter=6, n_warmup=3,
                                      random_generator=8), verbose=False)
    assert ttree.nuts_transition_batched.transitions == n0
    assert np.isfinite(tt.get()).all()


def test_external_evaluations_run_concurrently():
    """The ``DensityLite`` half of ``tests/test_external.py::
    test_external_evaluations_run_concurrently``: N slow external calls
    overlap on the host pool (at most 0.6 of the serial time)."""
    n, delay = 8, 0.25

    def slow_logp(x):
        time.sleep(delay)
        return -0.5 * float(np.sum(np.asarray(x) ** 2))

    lite = bt.DensityLite(logp=slow_logp, input_size=3, traceable=False)
    x = np.arange(3 * n, dtype=float).reshape(n, 3) * 0.1
    t0 = time.perf_counter()
    lp = lite.logp(x, original_space=True)
    dt = time.perf_counter() - t0
    assert np.allclose(lp, -0.5 * np.sum(x ** 2, axis=-1), rtol=1e-12)
    assert dt < n * delay * 0.6, \
        f'DensityLite external eval not concurrent: {dt:.2f}s'


# ---------------------------------------------------------------------------
# The single-chain wrappers

def _metric(q, seed):
    rng = np.random.default_rng(seed)
    var = torch.as_tensor(np.exp(rng.normal(size=q.shape) * 0.2))
    return init_diag_metric(q, var)


def test_nuts_transition_is_a_batch_of_one():
    """The single-chain wrapper against the batched form on a batch of one
    with the one-point function vmapped (as the JAX wrapper vmaps it),
    from one generator state; and against the batched function to
    rounding."""
    lpg_1 = _torch_fns(False)[2]
    lpg_b = torch.func.vmap(lpg_1)
    q0 = torch.as_tensor(_points(1, 9)[0])
    metric = _metric(q0, 1)
    out_1 = ttree.nuts_transition(generator_from_seed(5), q0, metric, 0.3,
                                  lpg_1, 6, 1000.)
    metric_b = ttree._leading(metric)
    q_b, st_b = ttree.nuts_transition_batched(
        generator_from_seed(5), q0[None], metric_b,
        torch.tensor([0.3], dtype=torch.float64), lpg_b, 6, 1000.)
    assert torch.equal(out_1[0], q_b[0]) and out_1[0].shape == (D,)
    for a, b in zip(out_1[1], st_b):
        assert torch.equal(a, b[0]) and a.dim() == 0
    q_r, _ = ttree.nuts_transition_batched(
        generator_from_seed(5), q0[None], metric_b,
        torch.tensor([0.3], dtype=torch.float64), _torch_fns(True)[2], 6,
        1000.)
    np.testing.assert_allclose(q_r[0].numpy(), out_1[0].numpy(), rtol=1e-12)


def test_tnuts_transition_is_a_batch_of_one():
    lpg_1 = _torch_fns(False)[2]
    lpg_b = torch.func.vmap(lpg_1)

    def base_1(x):
        return -0.125 * torch.sum(x * x), -0.25 * x

    base_b = torch.func.vmap(base_1)

    q0 = torch.as_tensor(_points(1, 10)[0])
    u0 = torch.tensor(0.4, dtype=torch.float64)
    metric = _metric(q0, 2)
    q1, u1, st1 = ttemp.tnuts_transition(generator_from_seed(6), q0, u0,
                                         metric, 0.2, lpg_1, base_1, 5,
                                         1000.)
    qb, ub, stb = ttemp.tnuts_transition_batched(
        generator_from_seed(6), q0[None], u0.reshape(1),
        ttree._leading(metric), torch.tensor([0.2], dtype=torch.float64),
        lpg_b, base_b, 5, 1000.)
    assert torch.equal(q1, qb[0]) and torch.equal(u1, ub[0])
    for a, b in zip(st1, stb):
        assert torch.equal(a, b[0])


def test_single_chain_wrappers_are_exported():
    assert bt.nuts_transition is ttree.nuts_transition
    assert bt.nuts_transition_batched is ttree.nuts_transition_batched
    assert bt.samplers.nuts_transition_batched is \
        ttree.nuts_transition_batched


# ---------------------------------------------------------------------------
# map_async and gather

@pytest.mark.parametrize('backend', [
    bt.utils.parallel.ParallelBackend(serial=True),
    bt.utils.parallel.ParallelBackend(3),
    bt.utils.parallel.ParallelBackend(None),
    bt.utils.parallel.ParallelBackend((2, 'processes'),
                                      mp_context='spawn'),
], ids=['serial', 'threads', 'transient_threads', 'processes'])
def test_map_async_and_gather(backend):
    """The results in order, on each kind of pool (a builtin as the mapped
    callable: a process pool pickles it by name)."""
    xs = list(range(7))
    res = backend.map_async(operator.mul, xs, xs)
    assert backend.gather(res) == [x * x for x in xs]
    if backend.kind == 'threads' and backend.backend is None:
        # a transient pool lives until gather, then shuts down
        assert isinstance(res, parallel._OwnedFutures)
        assert res.pool._shutdown
    assert backend.gather(backend.map_async(operator.mul, [3], [3])) == [9]


# ---------------------------------------------------------------------------
# config

def test_matmul_precision_sets_and_restores():
    cuda0 = torch.backends.cuda.matmul.allow_tf32
    cudnn0 = torch.backends.cudnn.allow_tf32
    assert not cuda0 and not cudnn0  # the import pins TF32 off
    try:
        tconfig.set_matmul_precision('high')
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        tconfig.set_matmul_precision()
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        tconfig.set_matmul_precision(None)
        prior = tconfig._prior_matmul
        assert torch.backends.cuda.matmul.allow_tf32 == prior[0]
        assert torch.backends.cudnn.allow_tf32 == prior[1]
        with pytest.raises(ValueError):
            tconfig.set_matmul_precision('bfloat16')
    finally:
        tconfig.set_matmul_precision('highest')
    assert not torch.backends.cuda.matmul.allow_tf32


def test_asarray_and_default_int():
    a = tconfig.asarray([1, 2])
    assert a.dtype == tconfig.get_dtype() and a.device.type == 'cpu'
    assert tconfig.default_int() is torch.int32


# ---------------------------------------------------------------------------
# The new keyword arguments

def test_new_keywords_are_accepted():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 400, 2))
    logp = lambda z: -0.5 * np.sum(z ** 2, axis=-1)  # noqa: E731
    for cls in (bt.evidence.GBS, bt.evidence.GIS):
        est = cls(sit={'n_iter': 1, 'random_generator': 0},
                  parallel_backend=None, n_q=200)
        assert np.isfinite(est(x, logp)[0])
    ghm = bt.evidence.GHM(sit={'n_iter': 1, 'random_generator': 0},
                          parallel_backend=4)
    assert np.isfinite(ghm(x, logp)[0])
    draws = []

    def mvn(mean, cov, n):
        draws.append(n)
        return np.random.default_rng(1).multivariate_normal(mean, cov, n)

    sit = bt.transforms.SIT(n_iter=1, parallel_backend=None,
                            mvn_generator=mvn, random_generator=0)
    sit.fit(x.reshape(-1, 2))
    xs, log_j, y = sit.sample(5, use_parallel=True)
    assert draws == [5] and xs.shape == (5, 2)
    y2, lj2 = sit.forward_transform(xs, use_parallel=True)
    np.testing.assert_allclose(y2, y, atol=1e-8)
    x2, _ = sit.backward_transform(y, use_parallel=False)
    np.testing.assert_allclose(x2, xs, atol=1e-12)
    assert sit.logq(xs, use_parallel=True).shape == (5,)
    den = bt.DensityLite(logp=lambda z: -0.5 * torch.sum(z * z, -1),
                         input_size=2)
    tt = bt.sample(den, bt.NTrace(n_chain=2, n_iter=4, n_warmup=2,
                                  random_generator=0),
                   parallel_backend=None, verbose=False)
    chain = tt[0]
    assert chain.input_size == 2
    np.testing.assert_array_equal(chain.get(flatten=False), chain.get())
    assert bt.core.density.Density is bt.Density


def test_unspeculative_spline_fit_gives_the_same_splines():
    from bayesfast_tpu_torch.utils.cubic import fit_spline_columns
    rng = np.random.default_rng(4)
    cols = [rng.standard_t(3, size=3000), rng.gamma(2.0, size=3000),
            rng.normal(size=3000) ** 3]
    n_calls = {True: 0, False: 0}

    def fun_batch(spec):
        def f(queries):
            n_calls[spec] += 1
            return [np.tanh(0.3 * q) + 0.1 * q + 0.02 * np.sin(7 * q)
                    for q in queries]
        return f

    a = fit_spline_columns(cols, fun_batch(True), bins=30)
    b = fit_spline_columns(cols, fun_batch(False), bins=30,
                           speculative=False)
    for sa, sb in zip(a, b):
        np.testing.assert_array_equal(sa._x, sb._x)
        np.testing.assert_array_equal(sa._y, sb._y)
        np.testing.assert_array_equal(sa._c, sb._c)
    assert n_calls[False] > n_calls[True]
