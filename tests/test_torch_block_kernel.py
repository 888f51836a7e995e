"""The port's block transition against the JAX Pallas block kernel.

``nuts_block_plain`` (the plain torch version of ``nuts_block_kernel`` in
``bayesfast_tpu_torch/csrc/nuts.cu``) is held against
``make_nuts_pallas(...)``'s ``run`` in interpret mode, on a bounded rotated
banana with per-chain metric and step size, the same int32 seed and a
``chain_start``. ``run`` is called directly because the JAX wrapper draws
its seed from a jax key.

Tolerances, as in ``test_torch_nuts_kernel.py``: the tree statistics
(depth, size, divergence) exactly equal; floats to rtol 1e-6 with each
package's own float32 Box-Muller momenta (XLA's float32 ``log``/``cos``
differ from torch's by an ulp in some elements), and to rtol 1e-9 with the
same correctly rounded Box-Muller patched into both sides (what is left is
summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesfast_tpu.samplers import nuts_pallas as jnpl
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.samplers import nuts_cuda as tnc
from bayesfast_tpu_torch.samplers.metrics import init_diag_metric
from test_torch_nuts_kernel import (MAX_CHANGE, MAXDEPTH, _compare, _lpg,
                                    _setup, _to_port_layout, momenta)  # noqa


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


@pytest.mark.parametrize('D,seed,chain_start', [(4, 123456789, 0),
                                                (4, 2 ** 31 - 2, 1000),
                                                (8, 424242, 77)])
def test_block_matches_pallas(D, seed, chain_start, momenta):
    den_j, den_t, q0, var, eps = _setup(D)
    C = q0.shape[0]
    run = jnpl.make_nuts_pallas(den_j.device_logp_and_grad(False), (), D, C,
                                MAXDEPTH, MAX_CHANGE, jnp.float64,
                                interpret=True)
    o = run(jnp.int32(seed), jnp.int32(chain_start), jnp.asarray(q0.T),
            jnp.asarray(var.T), jnp.asarray(eps), [])
    want = {k: _to_port_layout(k, v) for k, v in o.items()}
    got = tnc.nuts_block_plain(seed, torch.as_tensor(q0),
                               torch.as_tensor(var), torch.as_tensor(eps),
                               MAXDEPTH, MAX_CHANGE, _lpg(den_t), chain_start)
    assert set(got) == set(want)
    _compare(got, want, *momenta)
    # the case covers divergence and ordinary trees
    assert want['diverging'].any() and (want['tree_depth'] > 1).sum() > C // 2


def test_block_launches_with_folded_seeds_are_the_chunk():
    """K block transitions, transition t under ``_transition_seed(seed, i0,
    t)``, give bitwise the rows of one chunk of K from the same start: the
    property that lets the per-transition path and the chunk kernels share
    one stream."""
    _, den_t, q0, var, eps = _setup()
    q, var, eps = (torch.as_tensor(a) for a in (q0, var, eps))
    seed, i0, K, cs = 97531, 250, 3, 5
    chunk = tnc.nuts_chunk_plain(seed, q, var, eps, K, MAXDEPTH, MAX_CHANGE,
                                 _lpg(den_t), i0, cs)
    for t in range(K):
        o = tnc.nuts_block_plain(tnc._transition_seed(seed, i0, t), q, var,
                                 eps, MAXDEPTH, MAX_CHANGE, _lpg(den_t), cs)
        for k, v in o.items():
            assert torch.equal(v, chunk[k][t]), (t, k)
        q = o['q']
    assert torch.equal(q, chunk['q_final'])


def test_block_wrapper_on_cpu():
    """On CPU tensors the wrapper runs the plain version and counts no
    launch; a shared (D,) var is broadcast over the chains; kernel='cuda'
    raises instead of falling back."""
    _, den_t, q0, var, eps = _setup()
    q0t = torch.as_tensor(q0)
    var1 = torch.as_tensor(var[0])
    n0 = tnc.nuts_transition_batched.launches
    q, stats = tnc.nuts_transition_batched(
        11, q0t, init_diag_metric(q0t.mean(0), var1), torch.as_tensor(eps),
        MAXDEPTH, MAX_CHANGE, density=den_t, chain_start=3)
    ref = tnc.nuts_block_plain(11, q0t, var1.expand_as(q0t),
                               torch.as_tensor(eps), MAXDEPTH, MAX_CHANGE,
                               tnc.plain_lpg(den_t), 3)
    assert torch.equal(q, ref['q'])
    assert torch.equal(stats.tree_size, ref['tree_size'])
    assert torch.equal(stats.mean_tree_accept,
                       ref['accept_sum'] / ref['tree_size'].clamp(min=1))
    assert stats.diverging.dtype == torch.bool
    assert tnc.nuts_transition_batched.launches == n0
    with pytest.raises(RuntimeError, match='CUDA'):
        tnc.nuts_transition_batched(11, q0t, init_diag_metric(q0t, var1),
                                    torch.as_tensor(eps), MAXDEPTH,
                                    MAX_CHANGE, density=den_t, kernel='cuda')


def test_launch_spec_is_built_once_per_transform():
    """The wrappers keep a density's launch spec per (dtype, device), so a
    launch copies nothing from the host; setting the transform, changing a
    parameter tensor in place or a scalar of the density builds it again."""
    _, den_t, q0, _, _ = _setup()
    like = torch.as_tensor(q0)
    first = tnc._spec_for(den_t, like)
    assert tnc._spec_for(den_t, like) is first
    f32 = tnc._spec_for(den_t, like.float())
    assert f32 is not first and f32[1].dtype == torch.float32
    assert tnc._spec_for(den_t, like.float()) is f32
    den_t.input_scales = den_t.input_scales * 2.0
    again = tnc._spec_for(den_t, like)
    assert again is not first
    np.testing.assert_allclose(again[1][1].numpy(),
                               2.0 * first[1][1].numpy())
    inner = den_t._logp
    params = again[2].clone()
    inner.A.mul_(-1.0)
    flipped = tnc._spec_for(den_t, like)
    assert flipped is not again
    torch.testing.assert_close(flipped[2], -params, rtol=0, atol=0)
    inner.Q = inner.Q * 3.0
    rescaled = tnc._spec_for(den_t, like)
    assert rescaled is not flipped and rescaled[4][0] == inner.Q
    assert tnc._spec_for(den_t, like) is rescaled
