"""The funnel twin end to end on the CPU: ``bayesfast_tpu_torch.examples.
funnel_gbs.main()`` at the configuration of the JAX example's recorded run
(``examples/results.jsonl:1``: 16 chains, 800 iterations of which 400
warmup; logz -63.5195 +- 0.024 there), its NUTS transitions on the chunk
kernels' plain versions and GBS's SIT fit on the host. Its logz must lie
within max(5 quoted errors, 0.15) of the fiducial -63.4988, with every
transition in a chunk (no tree-loop transition). About a minute alone.
"""

import numpy as np
import pytest

from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.samplers import nuts as ttree


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: this test asks for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


def test_funnel_twin_end_to_end(monkeypatch):
    from bayesfast_tpu_torch.examples import funnel_gbs
    for k, v in (('N_CHAIN', 16), ('N_ITER', 800), ('N_WARMUP', 400)):
        monkeypatch.setenv(k, str(v))
    t0 = ttree.nuts_transition_batched.transitions
    rec = funnel_gbs.main()
    res = rec.get()
    assert ttree.nuts_transition_batched.transitions == t0
    tt = rec.recipe_trace.results.sample[-1].sample_trace
    assert tt.get(flatten=False).shape == (16, 400, 16)
    assert np.isfinite(res.logz) and 0 < res.logz_err < 0.1
    tol = max(5 * res.logz_err, 0.15)
    assert abs(res.logz - funnel_gbs.FIDUCIAL) <= tol, (res.logz,
                                                       res.logz_err)
