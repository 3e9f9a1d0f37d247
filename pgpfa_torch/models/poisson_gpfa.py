"""Poisson-GPFA log-densities in structured (Kronecker-free) form (PyTorch).

Port of ``pgpfa/models/poisson_gpfa.py``. Every function takes an optional
leading trial axis on ``X``/``Y``/``expA``; ``C``, ``d`` and ``Kinv`` are
shared by all trials.
"""

from __future__ import annotations

import torch

from pgpfa_torch.ops.blockmat import assemble_hessian


def linear_predictor(C: torch.Tensor, d: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``A = C X + d``, shape ``(..., ydim, T)``."""
    return C @ X + d[:, None]


def prior_quad(X: torch.Tensor, Kinv: torch.Tensor) -> torch.Tensor:
    """``sum_k x_k^T Kinv_k x_k`` per trial: ``X (..., xdim, T)`` -> ``(...)``."""
    return torch.einsum("...kt,ktu,...ku->...", X, Kinv, X)


def neg_log_posterior(X, Y, C, d, Kinv) -> torch.Tensor:
    """``1^T exp(A) - <Y, A> + 0.5 x^T K^{-1} x`` per trial."""
    A = linear_predictor(C, d, X)
    return torch.exp(A).sum((-2, -1)) - (Y * A).sum((-2, -1)) + 0.5 * prior_quad(X, Kinv)


def hessian_weights(C: torch.Tensor, expA: torch.Tensor) -> torch.Tensor:
    """Time-local observation curvature
    ``W[..., t, k, l] = sum_n C[n,k] C[n,l] expA[..., n, t]``, computed as one
    ``(T, ydim) @ (ydim, xdim^2)`` matmul per trial."""
    ydim, xdim = C.shape
    CC = (C[:, :, None] * C[:, None, :]).reshape(ydim, xdim * xdim)
    W = expA.transpose(-1, -2) @ CC
    return W.reshape(*W.shape[:-1], xdim, xdim)


def neg_log_posterior_grad(X, Y, C, d, Kinv) -> torch.Tensor:
    """Gradient of :func:`neg_log_posterior` in ``X``, shape ``(..., xdim, T)``:
    ``C^T (exp(A) - Y) + K^{-1} x``."""
    resid = torch.exp(linear_predictor(C, d, X)) - Y
    return C.T @ resid + torch.einsum("ktu,...ku->...kt", Kinv, X)


def neg_log_posterior_hess(X, Y, C, d, Kinv) -> torch.Tensor:
    """Dense Hessian of :func:`neg_log_posterior` in the latent-major
    flattened ``X``, shape ``(..., xdim*T, xdim*T)``."""
    W = hessian_weights(C, torch.exp(linear_predictor(C, d, X)))
    return assemble_hessian(W, Kinv)
