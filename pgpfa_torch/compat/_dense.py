"""Dense NumPy objectives of the reference's public surface: the port's own
copies of ``nlp``, ``nlp_grad``, ``nlp_hess``, ``cd_cost``,
``cd_cost_grad``, ``tau_cost``, ``vi_dual_cost`` and
``tau_cost_with_prior`` of ``pgpfa/oracle/oracle_np.py``, unchanged.

They serve the compat shims that take the reference's dense ``C_big`` /
``K_big`` arguments (:mod:`pgpfa_torch.compat.inference`,
:mod:`pgpfa_torch.compat.learning`); no fit runs through them.
"""

from __future__ import annotations

import numpy as np


def _pack_cd(C, d):
    return np.concatenate([C.T.reshape(-1), np.ravel(d)])


def _unpack_cd(vec, xdim, ydim):
    return vec[: xdim * ydim].reshape(xdim, ydim).T, vec[xdim * ydim :]


# ---------------------------------------------------- laplace objective

def nlp(x, ybar, Cb, db, Kinv):
    """Negative unnormalized log posterior over flattened latents."""
    act = Cb.T @ x + db
    return np.sum(np.exp(act)) - ybar @ act + 0.5 * x @ (Kinv @ x)


def nlp_grad(x, ybar, Cb, db, Kinv):
    act = Cb.T @ x + db
    return Cb @ (np.exp(act) - ybar) + Kinv @ x


def nlp_hess(x, ybar, Cb, db, Kinv):
    act = Cb.T @ x + db
    return (Cb * np.exp(act)[None, :]) @ Cb.T + Kinv


# ------------------------------------------------------ M-step: C and d

def cd_cost(vec, Y, means, vsms):
    """Expected-complete-data Poisson cost for (C, d), averaged over trials.

    cost = -(1/R) * sum_{r,n,t} [ y*hh - exp(hh + rho/2) ],
    hh = C m + d,  rho[n,t] = C[n] @ vsm[t] @ C[n].
    """
    R, ydim, T = Y.shape
    xdim = means.shape[1]
    C, d = _unpack_cd(vec, xdim, ydim)
    quad = np.einsum("nk,rtkl,nl->rnt", C, vsms, C)
    hh = np.einsum("nk,rkt->rnt", C, means) + d[None, :, None]
    rate = np.exp(hh + 0.5 * quad)
    return -float(np.sum(Y * hh - rate)) / R


def cd_cost_grad(vec, Y, means, vsms):
    R, ydim, T = Y.shape
    xdim = means.shape[1]
    C, d = _unpack_cd(vec, xdim, ydim)
    quad = np.einsum("nk,rtkl,nl->rnt", C, vsms, C)
    hh = np.einsum("nk,rkt->rnt", C, means) + d[None, :, None]
    rate = np.exp(hh + 0.5 * quad)
    resid = Y - rate
    gC = np.einsum("rnt,rkt->nk", resid, means) - np.einsum("rnt,rtkl,nl->nk", rate, vsms, C)
    gd = np.sum(resid, axis=(0, 2))
    return -_pack_cd(gC, gd) / R


# -------------------------------------------------------- M-step: tau

def tau_cost(p, pauto_k, R, T, eps: float = 0.001):
    """Negative GP marginal-likelihood term in p = log(gamma) space."""
    idx = np.arange(T, dtype=float)
    sq = (idx[:, None] - idx[None, :]) ** 2
    K = (1.0 - eps) * np.exp(-0.5 * np.exp(p) * sq) + eps * np.eye(T)
    sign, logdet = np.linalg.slogdet(K)
    Kinv = np.linalg.inv(K)
    f = -0.5 * R * sign * logdet - 0.5 * np.sum(Kinv * pauto_k)
    return -f


def tau_cost_with_prior(p, pauto_k, R, T, bin_ms, old_tau_sec, stepsize, eps: float = 0.001):
    """Tau cost plus the online proximal penalty, in seconds
    (reference ``funs/learning.py:681-724``: regularizer
    ``0.5 (tau - oldTau)^2 / s^2`` with ``tau = binSize/1000 * exp(-p/2)``)."""
    tau_sec = np.exp(-0.5 * float(np.ravel(p)[0])) * bin_ms / 1000.0
    reg = 0.5 * (tau_sec - old_tau_sec) ** 2 / stepsize**2
    return tau_cost(p, pauto_k, R, T, eps) + reg


# --------------------------------------------------- variational dual

def vi_dual_cost(rho, ybar, Cb, db, Kb, Kinv):
    """Dual VI objective in rho = log(lambda) space, one trial.

    Matches the bounded-lambda dual of the reference
    (``funs/inference.py:196-213``), including the 1e-6 relative diagonal
    ridge inside the posterior covariance.
    """
    lam = np.exp(rho)
    lmy = lam - ybar
    u = Cb @ lmy
    prec = Kinv + (Cb * lam[None, :]) @ Cb.T
    cov = np.linalg.inv(prec + 1e-6 * np.diag(np.diag(prec)))
    _, ld = np.linalg.slogdet(cov)
    a = 0.5 * u @ (Kb @ u)
    b = -db @ lmy
    c = 0.5 * ld
    e = lam @ (rho - 1.0)
    return a + b + c + e
