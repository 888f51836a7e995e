"""FastICA in torch.

Counterpart of ``bayesfast_tpu/ops/ica.py``: whitening through ``eigh``,
the symmetric fixed-point iteration with the logcosh nonlinearity and
symmetric decorrelation, on the device of the data. The JAX package's
``lax.while_loop`` is a Python loop here; its random initial matrix comes
from an explicit ``torch.Generator``, or is handed in as ``w_init``.
"""

import torch

__all__ = ['fast_ica']


def _sym_decorrelation(W):
    """W <- (W W^T)^{-1/2} W."""
    s, u = torch.linalg.eigh(W @ W.T)
    s = torch.clamp(s, min=1e-12)
    return (u * (1.0 / torch.sqrt(s))) @ u.T @ W


def fast_ica(x, generator=None, max_iter=100, tol=1e-4, w_init=None):
    """Fit FastICA to ``x`` (n, d); returns ``(components, mean)`` with
    ``sources = (x - mean) @ components.T``.

    ``w_init`` (d, d) is the decorrelated initial unmixing matrix; without
    it, one is drawn from ``generator`` (a CPU ``torch.Generator``).
    """
    x = torch.as_tensor(x)
    n, d = x.shape
    mean = torch.mean(x, dim=0)
    xc = x - mean
    # whitening: cov = V diag(s) V^T ; K = diag(1/sqrt(s)) V^T
    cov = xc.T @ xc / n
    s, V = torch.linalg.eigh(cov)
    s = torch.clamp(s, min=1e-18)
    K = (V / torch.sqrt(s)).T
    xw = xc @ K.T            # whitened, unit covariance

    if w_init is None:
        W = _sym_decorrelation(torch.randn(
            (d, d), generator=generator, dtype=x.dtype).to(x.device))
    else:
        W = torch.as_tensor(w_init, dtype=x.dtype, device=x.device)
    for _ in range(int(max_iter)):
        wx = xw @ W.T                       # (n, d)
        g = torch.tanh(wx)
        g_prime = 1.0 - g * g
        W_new = (g.T @ xw) / n - torch.mean(g_prime, dim=0)[:, None] * W
        W_new = _sym_decorrelation(W_new)
        lim = torch.max(torch.abs(torch.abs(torch.sum(W_new * W, dim=1))
                                  - 1.0))
        W = W_new
        if not bool(lim > tol):
            break
    return W @ K, mean
