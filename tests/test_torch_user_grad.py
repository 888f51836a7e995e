"""The user's own gradient in the NUTS kernels' plain versions against the
JAX Pallas kernels in interpret mode, on the CPU.

The JAX package samples a ``DensityLite(logp, grad=...)`` by tracing its
``device_logp_and_grad(False)`` (the user's gradient with the transform's
corrections, ``bayesfast_tpu/core/density.py:232-250``) into the Pallas
kernels (``_trace_density``, ``nuts_pallas.py:576-607``). The port traces
the user's pair into a program with no adjoint (``ops/trace.py``) whose
interpreter is the kernels' plain version. Here ``bench.py``'s banana-32
written with its gradient by hand (``examples/user_densities.py::
bench_banana_user``) goes through the plain frozen chunk, warmup chunk and
block transition and through the Pallas kernels over the same function in
jnp, at ``tests/test_torch_nuts_kernel.py``'s tolerances and with
``tests/test_torch_trace.py``'s allowances (starts near the ridge, steps
around the adapted scale, two 400 times as long that diverge). A wrong
gradient (the true one times 2) given to both packages gives the same
trajectories again: both kernels run the gradient as given.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesfast_tpu as bf
from bayesfast_tpu.samplers import nuts_pallas as jnpl
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.core.density import DensityLite
from bayesfast_tpu_torch.examples.user_densities import bench_banana_user
from bayesfast_tpu_torch.samplers import nuts_cuda as tnc
from test_torch_nuts_kernel import (_compare, _to_port_layout, momenta,  # noqa
                                    use_rounded_momenta)

D, C, K, MAXDEPTH, MAX_CHANGE = 32, 8, 2, 5, 1000.


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU,
    in float64."""
    old = tconfig.set_device('cpu')
    old_dtype = tconfig.get_dtype()
    tconfig.set_dtype(torch.float64)
    yield
    tconfig.set_device(old)
    tconfig.set_dtype(old_dtype)


def _pair(scale=1.0):
    """bench.py's banana with its gradient by hand in both packages, as a
    JAX user writes it (``logp`` and ``grad`` of one point), the gradient
    times ``scale``; starts, metrics and steps as
    ``test_torch_trace.py::_bench_pair``."""
    den_t, info = bench_banana_user('grad')
    A = jnp.asarray(info['A'], dtype=jnp.float32)
    even = jnp.asarray((np.arange(D) % 2) == 0, jnp.float32)
    Q, const = info['Q'], info['const']

    def logp(x):
        z = A @ x
        r = z * z - jnp.roll(z, -1)
        return -jnp.sum((r ** 2 / Q + (z - 1.0) ** 2) * even) - const

    def grad(x):
        z = A @ x
        er = even * (z * z - jnp.roll(z, -1))
        dz = ((2.0 / Q) * (jnp.roll(er, 1) - 2.0 * z * er)
              - 2.0 * even * (z - 1.0))
        return scale * (A.T @ dz)

    den_j = bf.DensityLite(logp=logp, grad=grad, input_size=D,
                           input_scales=den_t.input_scales,
                           hard_bounds=True)
    if scale != 1.0:
        g_t = den_t._grad
        den_t = DensityLite(logp=den_t._logp,
                            grad=lambda x: scale * g_t(x), vectorized=False,
                            input_size=D, input_scales=den_t.input_scales,
                            hard_bounds=True)
    assert den_t.has_traced_spec
    rng = np.random.default_rng(11)
    xo = (info['A'].T @ np.ones(D))[None] + rng.normal(size=(C, D)) * 0.05
    q0 = np.asarray(den_t.from_original(xo))
    var = np.exp(rng.normal(size=(C, D)) * 0.2) * 1e-3
    eps = np.exp(rng.normal(size=C) * 0.3) * 0.03
    eps[:2] *= 400.0
    return den_j, den_t, q0, var, eps


def _frozen(den_j, den_t, q0, var, eps):
    seed, i0, chain_start = 123456789, 7, 5
    run = jnpl.make_nuts_pallas_multi(
        den_j.device_logp_and_grad(False), (), D, C, K, MAXDEPTH,
        MAX_CHANGE, jnp.float64, interpret=True)
    o = run(jnp.int32(seed), jnp.int32(i0), jnp.int32(chain_start),
            jnp.asarray(q0.T), jnp.asarray(var.T), jnp.asarray(eps)[None],
            [])
    want = {k: _to_port_layout(k, v) for k, v in o.items()}
    got = tnc.nuts_chunk_plain(
        seed, torch.as_tensor(q0), torch.as_tensor(var),
        torch.as_tensor(eps), K, MAXDEPTH, MAX_CHANGE, tnc.plain_lpg(den_t),
        i0, chain_start)
    return got, want


def test_user_grad_frozen_chunk_matches_pallas(momenta):
    got, want = _frozen(*_pair())
    _compare(got, want, *momenta)
    assert want['diverging'].any() and (want['tree_depth'] > 1).any()


def test_user_grad_warmup_chunk_matches_pallas(monkeypatch):
    tol = use_rounded_momenta(monkeypatch)
    den_j, den_t, q0, var, eps = _pair()
    eps[:2] /= 400.0
    rng = np.random.default_rng(5)
    log_step = np.log(eps)
    step = (log_step, log_step + 0.1, rng.normal(size=C) * 0.01,
            np.full(C, 5.0), np.log(10 * eps))
    metric = (var, q0 + rng.normal(size=(C, D)) * 0.01, var * 10.0,
              np.full(C, 10.0), q0, var * 3.0, np.full(C, 3.0))
    wsched, _ = jnpl._window_schedule(4, 0, 5, K, 1, True)
    seed, i0, args = 987654321, 33, (0.8, 0.05, 0.75, 10.)
    run = jnpl.make_nuts_pallas_warmup(
        den_j.device_logp_and_grad(False), (), D, C, K, MAXDEPTH,
        MAX_CHANGE, jnp.float64, wsched, *args, True, True, interpret=True)
    row = lambda a: jnp.asarray(a).reshape(1, C)  # noqa: E731
    mat = lambda a: jnp.asarray(a).T  # noqa: E731
    o = run(jnp.int32(seed), jnp.int32(i0), jnp.int32(0), jnp.asarray(q0.T),
            tuple(row(a) for a in step),
            (mat(metric[0]), mat(metric[1]), mat(metric[2]), row(metric[3]),
             mat(metric[4]), mat(metric[5]), row(metric[6])), [], wsched)
    want = {k: _to_port_layout(k, v) for k, v in o.items()}
    got = tnc.nuts_warmup_chunk_plain(
        seed, torch.as_tensor(q0), [torch.as_tensor(a) for a in step],
        [torch.as_tensor(a) for a in metric], K, MAXDEPTH, MAX_CHANGE,
        *args, True, True, wsched, tnc.plain_lpg(den_t), i0)
    assert set(got) == set(want)
    _compare(got, want, *tol)


def test_user_grad_block_matches_pallas(momenta):
    den_j, den_t, q0, var, eps = _pair()
    seed, chain_start = 2 ** 31 - 2, 1000
    run = jnpl.make_nuts_pallas(den_j.device_logp_and_grad(False), (), D, C,
                                MAXDEPTH, MAX_CHANGE, jnp.float64,
                                interpret=True)
    o = run(jnp.int32(seed), jnp.int32(chain_start), jnp.asarray(q0.T),
            jnp.asarray(var.T), jnp.asarray(eps), [])
    want = {k: _to_port_layout(k, v) for k, v in o.items()}
    got = tnc.nuts_block_plain(seed, torch.as_tensor(q0),
                               torch.as_tensor(var), torch.as_tensor(eps),
                               MAXDEPTH, MAX_CHANGE, tnc.plain_lpg(den_t),
                               chain_start)
    assert set(got) == set(want)
    _compare(got, want, *momenta)
    assert want['diverging'].any()


def test_wrong_gradient_in_both_kernels(monkeypatch):
    """The true gradient times 2 in both packages: the plain frozen chunk
    follows the Pallas kernel's trajectories again, and they differ from
    the true gradient's."""
    tol = use_rounded_momenta(monkeypatch)
    got, want = _frozen(*_pair(2.0))
    _compare(got, want, *tol)
    got_1, _ = _frozen(*_pair())
    assert not np.allclose(got['q'].numpy(), got_1['q'].numpy())
