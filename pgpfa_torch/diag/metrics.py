"""Fit-quality metrics (host-side NumPy; diagnostics, not a hot path).

Twin of ``pgpfa/diag/metrics.py`` (the NumPy functions are copies, kept
here so that nothing in the port imports the JAX package).
:func:`cd_error_bars` takes the port's exact (C, d) Hessian on a device.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import torch

from pgpfa_torch.convert import to_numpy
from pgpfa_torch.learn.mstep_obs import cd_hessian
from pgpfa_torch.models.params import pack_cd


def subspace_angle(F: np.ndarray, G: np.ndarray) -> float:
    """Largest principal angle between the column spaces of F and G, the
    columns max-normalized first (the reference's preprocessing)."""
    F = np.asarray(F, dtype=float).copy()
    G = np.asarray(G, dtype=float).copy()
    F = F / F.max(axis=0, keepdims=True)
    G = G / G.max(axis=0, keepdims=True)
    qf = sla.orth(F)
    qg = sla.orth(G)
    s = sla.svd(qf.T @ qg, compute_uv=False)
    s = np.minimum(s, 1.0)
    return float(np.max(np.maximum(np.arccos(s), 0.0)))


def js_logdet_div(X: np.ndarray, Y: np.ndarray) -> float:
    """Jensen-Shannon-style log-determinant divergence between SPD matrices,
    through ``slogdet`` (raw determinants overflow past ydim ~ 90)."""
    _, ld_mid = np.linalg.slogdet((X + Y) / 2.0)
    _, ld_x = np.linalg.slogdet(X)
    _, ld_y = np.linalg.slogdet(Y)
    return float(ld_mid - 0.5 * (ld_x + ld_y))


def mean_cov_y_from_params(params) -> tuple:
    """Model-implied per-bin spike-count mean and second moment.

    Log-normal-Poisson moments with ``Lambda = C C^T``::

        E[y_n]     = exp(Lambda_nn / 2 + d_n)
        E[y_n y_m] = E[y_n] E[y_m] exp(Lambda_nm / 2)   (n != m)
        E[y_n^2]   = E[y_n] + exp(Lambda_nn / 2) E[y_n]^2
    """
    C = np.asarray(params["C"])
    d = np.asarray(params["d"]).reshape(-1)
    lam = C @ C.T
    ey = np.exp(0.5 * np.diag(lam) + d)
    eyy = np.outer(ey, ey) * np.exp(0.5 * lam)
    np.fill_diagonal(eyy, ey + np.exp(0.5 * np.diag(lam)) * ey**2)
    return ey, eyy


def cd_error_bars(params, Y, means, vsms, device="cuda", dtype=torch.float64) -> np.ndarray:
    """Inverse-Hessian standard errors ``sqrt(diag(H^{-1}))`` of the packed
    (C, d) estimate (:func:`pgpfa_torch.models.params.pack_cd` order).

    ``H`` is the exact Hessian of the M-step cost
    (:func:`pgpfa_torch.learn.mstep_obs.cd_hessian`) on ``device`` (the card
    unless the caller passes ``device="cpu"``), inverted through its
    Cholesky factor.

    Args:
        params: ``{'C', 'd', ...}`` arrays; Y: counts ``(R, ydim, T)``;
            means ``(R, xdim, T)`` and vsms ``(R, T, xdim, xdim)``: the
            posterior moments (arrays or tensors).
    """
    C, d, Y, means, vsms = (torch.as_tensor(a, dtype=dtype, device=device)
                            for a in (params["C"], params["d"], Y, means, vsms))
    H = cd_hessian(pack_cd(C, d.reshape(-1)), Y, means, vsms)
    Hinv = torch.cholesky_inverse(torch.linalg.cholesky(H))
    return to_numpy(torch.sqrt(torch.diagonal(Hinv)))


def mvnpdf(x, mean, cov) -> float:
    """Multivariate normal density, in log space through ``slogdet`` (the
    raw ``det(cov) ** -0.5`` under/overflows past ~350 dimensions)."""
    x = np.ravel(np.asarray(x, dtype=float))
    mean = np.ravel(np.asarray(mean, dtype=float))
    k = x.shape[0]
    resid = x - mean
    _, logdet = np.linalg.slogdet(cov)
    log_p = -0.5 * (
        k * np.log(2 * np.pi) + logdet + resid @ np.linalg.solve(cov, resid)
    )
    return float(np.exp(log_p))


def mvnpdf_use_inv_cov(x, mean, inv_cov) -> float:
    """Multivariate normal density from the precision matrix, in the log
    space of :func:`mvnpdf`."""
    x = np.ravel(np.asarray(x, dtype=float))
    mean = np.ravel(np.asarray(mean, dtype=float))
    k = x.shape[0]
    resid = x - mean
    _, logdet_inv = np.linalg.slogdet(inv_cov)
    log_p = -0.5 * (k * np.log(2 * np.pi) - logdet_inv + resid @ (inv_cov @ resid))
    return float(np.exp(log_p))


def orthonormalized_trajectories(C: np.ndarray, means: np.ndarray) -> np.ndarray:
    """SVD-orthonormalized latent trajectories ``diag(D) V^T m`` of the
    posterior means ``(R, xdim, T)``."""
    _, D, Vt = sla.svd(np.asarray(C), full_matrices=False)
    M = np.diag(D) @ Vt
    return np.einsum("kl,rlt->rkt", M, np.asarray(means))
