"""The long-trial workload, NumPy only: the data of the JAX package's
long-trial benchmark (``scripts/bench_longt.py:problem``) made by the same
calls on the same ``numpy.random.Generator`` in the same order, so a seed
gives the same spike counts in both packages.

16 trials x 30 neurons, xdim 2, 10 ms bins, timescales (0.05, 0.08) s,
latents drawn from the GP prior; the banded path runs it with time blocks
of 50 bins (500 ms >= 6 x 80 ms).
"""

from __future__ import annotations

import numpy as np

XDIM, YDIM, TRIALS, BIN_MS = 2, 30, 16, 10.0
TAU = np.array([0.05, 0.08])
BLOCK = 50


def rbf_block(tau_sec: float, T: int, bin_ms: float, eps: float = 0.001) -> np.ndarray:
    """One ``T x T`` squared-exponential kernel block with diagonal jitter
    (the expression of ``pgpfa/oracle/oracle_np.py:rbf_block``)."""
    idx = np.arange(T, dtype=float) * bin_ms
    sq = (idx[:, None] - idx[None, :]) ** 2
    return (1.0 - eps) * np.exp(-0.5 * sq / (tau_sec * 1000.0) ** 2) + eps * np.eye(T)


def long_trial_problem(T: int, seed: int = 0):
    """``(C, d, tau, Y)`` of the long-trial workload at ``T`` bins: the true
    parameters and Poisson counts ``(16, 30, T)`` of latents drawn from the
    GP prior (one Cholesky factor per latent, reused across trials)."""
    import scipy.linalg as sla

    rng = np.random.default_rng(seed)
    C = rng.uniform(-0.4, 0.4, (YDIM, XDIM))
    d = rng.uniform(-1.0, -0.2, YDIM)
    Ls = [sla.cholesky(rbf_block(TAU[k], T, BIN_MS), lower=True) for k in range(XDIM)]
    X = np.stack([np.stack([Ls[k] @ rng.standard_normal(T) for k in range(XDIM)])
                  for _ in range(TRIALS)])
    Y = rng.poisson(np.exp(np.einsum("nk,rkt->rnt", C, X) + d[None, :, None])).astype(float)
    return C, d, TAU.copy(), Y
