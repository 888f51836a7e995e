"""The port's evidence estimators against the JAX package's.

* ``bridge``, ``importance``, ``harmonic`` (numpy on both sides) on
  identical inputs: abs 1e-12.
* GBS, GIS, GHM end to end on the correlated 4-d Gaussian of
  ``tests/test_sit_evidence.py``: each logz within that file's bound of the
  analytic value. GBS also against JAX's GBS with the same SIT options and
  the same ICA draws: within max(logz_err, 0.02). The two SIT fits do not
  agree to rounding here: on near-Gaussian data FastICA's fixed point is
  ill-defined and rounding differences steer the two iterations to other
  rotations (``test_torch_sit.py``), so the flows, and the estimates, agree
  to the estimates' own error.
* The slice as a whole on the port alone: ``bt.sample`` then
  ``bt.evidence.GBS(...)(tt, den.logp)``.
* The device default: CUDA, and without CUDA the entry points raise.
"""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bayesfast_tpu_torch as bt
from bayesfast_tpu import evidence as jev
from bayesfast_tpu.transforms import sit as jsit
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch import evidence as tev
from bayesfast_tpu_torch.ops.densities import DiagGaussian
from test_torch_sit import _inject_draws, _record_jax_draws


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


def _logs(shape_p, shape_q, seed):
    rng = np.random.default_rng(seed)
    zp = rng.normal(size=shape_p)
    zq = rng.normal(size=shape_q)
    # p: unnormalized N(0, 1) with logz = 0.5 log 2 pi; q: N(0.1, 1.2^2)
    lq = lambda z: (-0.5 * ((z - 0.1) / 1.2) ** 2 - np.log(1.2)
                    - 0.5 * np.log(2 * np.pi))
    return -0.5 * zp ** 2, -0.5 * zq ** 2, lq(zp), lq(zq)


@pytest.mark.parametrize('shape_p', [(4000,), (8, 500)])
def test_estimators_match_jax(shape_p):
    lpp, lpq, lqp, lqq = _logs(shape_p, (3000,), 7)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        pairs = [(tev.bridge(lpp, lpq, lqp, lqq),
                  jev.bridge(lpp, lpq, lqp, lqq)),
                 (tev.importance(lpq, lqq), jev.importance(lpq, lqq)),
                 (tev.harmonic(lpp, lqp), jev.harmonic(lpp, lqp))]
    for got, want in pairs:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def _corr_gauss_samples(n, seed=4):
    """``tests/test_sit_evidence.py``'s correlated 4-d Gaussian."""
    rng = np.random.default_rng(seed)
    cov = np.array([[2.0, 0.6, 0.2, 0.0], [0.6, 1.0, 0.3, 0.1],
                    [0.2, 0.3, 1.5, 0.2], [0.0, 0.1, 0.2, 0.8]])
    x = rng.multivariate_normal(np.zeros(4), cov, n)
    prec = np.linalg.inv(cov)
    logp = lambda v: -0.5 * np.einsum('...i,ij,...j->...', v, prec, v)
    logz = 0.5 * np.linalg.slogdet(2 * np.pi * cov)[1]
    return x, logp, logz


def test_gbs_matches_jax_and_the_truth(monkeypatch):
    x, logp, logz_true = _corr_gauss_samples(8000)
    x_chains = x.reshape(8, 1000, 4)
    opts = {'n_iter': 6, 'random_generator': 0}
    draws = _record_jax_draws(monkeypatch)
    lz_j, err_j = jev.GBS(sit=dict(opts), n_q=2000).run(x_chains, logp)
    _inject_draws(monkeypatch, draws)
    gbs = tev.GBS(sit=dict(opts, flow_dtype=torch.float64), n_q=2000)
    lz_t, err_t = gbs.run(x_p=x_chains, logp=logp)
    assert err_t < 0.25
    assert abs(lz_t - logz_true) < max(5 * err_t, 0.1)
    assert abs(lz_t - lz_j) < max(err_t, 0.02)
    assert set(gbs.last_profile) == {'sit_fit_s', 'flow_sample_s',
                                     'logp_batches_s', 'flow_logq_s',
                                     'bridge_s'}


def test_gis_ghm_match_the_truth():
    x, logp, logz_true = _corr_gauss_samples(8000, seed=5)
    x_chains = x.reshape(8, 1000, 4)
    gis = tev.GIS(sit={'n_iter': 6, 'random_generator': 1}, n_q=4000)
    logz, logz_err = gis.run(x_p=x_chains, logp=logp)
    assert abs(logz - logz_true) < max(5 * logz_err, 0.15)
    ghm = tev.GHM(sit={'n_iter': 6, 'random_generator': 2})
    logz2, logz_err2 = ghm.run(x_p=x_chains, logp=logp)
    assert abs(logz2 - logz_true) < max(5 * logz_err2, 0.3)


class _TorchCorrGauss(torch.nn.Module):
    def __init__(self, prec):
        super().__init__()
        self.register_buffer('prec', torch.as_tensor(prec))

    def forward(self, x):
        return -0.5 * torch.einsum('...i,ij,...j->...', x, self.prec.to(x), x)


def test_torch_logp_gives_the_numpy_result():
    x, logp, _ = _corr_gauss_samples(4000, seed=6)
    prec = np.linalg.inv(np.cov(x, rowvar=False, bias=True))
    x_chains = x.reshape(4, 1000, 4)
    outs = []
    for lp in (lambda v: -0.5 * np.einsum('...i,ij,...j->...', v, prec, v),
               _TorchCorrGauss(prec)):
        outs.append(tev.GBS(sit={'n_iter': 3, 'random_generator': 4},
                            n_q=1000).run(x_chains, lp))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-10)


def test_sample_then_gbs_on_the_port():
    """The slice as a whole: NUTS on a bounded diag Gaussian, then GBS with
    the trace's call count sizing the proposal."""
    mean, var = np.array([1.5, -0.5, 0.3, 2.0]), np.array([0.5, 2., 1., .3])
    den = bt.DensityLite(logp=DiagGaussian(mean, var), input_size=4,
                         input_scales=np.tile([-10., 10.], (4, 1)),
                         hard_bounds=True)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        tt = bt.sample(den, bt.NTrace(n_chain=16, n_iter=400, n_warmup=200,
                                      random_generator=3), verbose=False)
        gbs = tev.GBS(sit={'n_iter': 4, 'random_generator': 5},
                      f_call=0.05, n_q_max=3000)
        logz, err = gbs(tt, den.logp)
    truth = 0.5 * np.sum(np.log(2 * np.pi * var))
    assert np.isfinite(logz) and 0 < err < 0.1
    assert abs(logz - truth) < max(5 * err, 0.1)


def test_default_device_is_cuda_and_nothing_runs_on_the_cpu_unasked(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    x, logp, _ = _corr_gauss_samples(2000, seed=8)
    den = bt.DensityLite(logp=DiagGaussian(np.zeros(4), np.ones(4)),
                         input_size=4)
    old = tconfig.set_device(None)
    try:
        assert tconfig._device.type == 'cuda'
        with pytest.raises(RuntimeError, match="set_device\\('cpu'\\)"):
            tconfig.get_device()
        with pytest.raises(RuntimeError, match='no CUDA device'):
            bt.sample(den, bt.NTrace(n_chain=4, n_iter=20, n_warmup=10,
                                     random_generator=1), verbose=False)
        with pytest.raises(RuntimeError, match='no CUDA device'):
            tev.GBS(n_q=100).run(x.reshape(2, 1000, 4),
                                 _TorchCorrGauss(np.eye(4)))
        with pytest.raises(RuntimeError, match='no CUDA device'):
            den.logp(x[:5])
    finally:
        tconfig.set_device(old)
    assert tconfig.get_device().type == 'cpu'
