"""M-step for the observation parameters (C, d) (PyTorch port of
``pgpfa/learn/mstep_obs.py``).

Expected-complete-data Poisson cost::

    cost(C, d) = -(1/R) sum_{r,n,t} [ Y*hh - exp(hh + rho/2) ]
    hh[n, t]  = (C m_r)[n, t] + d[n]
    rho[n, t] = C[n] @ vsm_r[t] @ C[n]

The cost separates per neuron, so the M-step is ``ydim`` independent
``(xdim+1)``-parameter Newton problems solved together with a fixed number of
guarded steps; their ``(ydim, q, q)`` systems go through the f32 ``chol32``
factorization with f64 refinement.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from pgpfa_torch.models.params import unpack_cd
from pgpfa_torch.ops.blockmat import solve_psd_mixed


class CdResult(NamedTuple):
    C: torch.Tensor
    d: torch.Tensor
    cost: torch.Tensor
    grad_norm: torch.Tensor
    niter: torch.Tensor


def cd_cost(vec: torch.Tensor, Y: torch.Tensor, means: torch.Tensor,
            vsms: torch.Tensor) -> torch.Tensor:
    """Negative expected complete-data log-likelihood of packed (C, d), / R.

    ``Y (R, ydim, T)``, ``means (R, xdim, T)``, ``vsms (R, T, xdim, xdim)``.
    """
    R, ydim, _ = Y.shape
    xdim = means.shape[1]
    C, d = unpack_cd(vec, xdim, ydim)
    hh = torch.einsum("nk,rkt->rnt", C, means) + d[None, :, None]
    quad = torch.einsum("nk,rtkl,nl->rnt", C, vsms, C)
    rate = torch.exp(hh + 0.5 * quad)
    return -(Y * hh - rate).sum() / R


def learn_cd_newton(Y, means, vsms, C0, d0, n_iter: int = 10) -> CdResult:
    """All-neurons batched Newton for the (C, d) M-step, in f64 or f32.

    Moment tensors over the flattened sample axis ``s = R*T`` (``m``, ``V``,
    ``m (x) m``, ``m (x) V``, ``V (x) V``) are formed once, so every
    per-iteration statistic is one ``(ydim, s) @ (s, x^k)`` matmul against the
    current rates. Above xdim 8 the ``x^4`` tensor is never formed: the
    Hessian's second-moment block is the weighted outer-product sum of
    ``u = m + V c`` per (neuron, sample). A rejected step shrinks that
    neuron's damping 4x for the retry; an accepted one resets it. In f32 a
    candidate within ``2e-6 (1 + |f|)`` of the cost is accepted (the cost
    cannot resolve smaller gains), and the carried cost stays the minimum.
    ``niter`` counts the iterations in which at least one neuron accepted.
    """
    R, ydim, T = Y.shape
    xdim = C0.shape[1]
    q = xdim + 1
    s = R * T
    contraction = xdim > 8

    M2 = means.transpose(1, 2).reshape(s, xdim)  # (s, x)
    Vf = vsms.reshape(s, xdim * xdim)  # (s, x^2)
    if contraction:
        V3 = vsms.reshape(s, xdim, xdim)
    else:
        P2 = (M2[:, :, None] * M2[:, None, :]).reshape(s, xdim * xdim)  # m (x) m
        MV = (M2[:, :, None] * Vf[:, None, :]).reshape(s, xdim**3)  # m (x) V
        VV = (Vf[:, :, None] * Vf[:, None, :]).reshape(s, xdim**4)  # V (x) V
    Yf = Y.transpose(0, 1).reshape(ydim, s)  # (ydim, s)
    Ym = Yf @ M2  # (ydim, x): sum_s y m
    Ysum = Yf.sum(1)  # (ydim,)

    theta0 = torch.cat([C0, d0[:, None]], dim=1)  # (ydim, q)

    def rates(theta):
        C, dn = theta[:, :-1], theta[:, -1]
        O = (C[:, :, None] * C[:, None, :]).reshape(ydim, xdim * xdim)
        eta = C @ M2.T + 0.5 * (O @ Vf.T) + dn[:, None]  # (ydim, s)
        return torch.exp(eta)

    def cost_from(theta, rate):
        """Per-neuron costs ``(ydim,)``; the ``y hh`` sum is linear in theta."""
        C, dn = theta[:, :-1], theta[:, -1]
        y_hh = (C * Ym).sum(1) + dn * Ysum
        return -(y_hh - rate.sum(1)) / R

    def grad_hess(theta, rate):
        C = theta[:, :-1]
        W = (rate @ Vf).reshape(ydim, xdim, xdim)  # sum rate * V
        rsum = rate.sum(1)
        if contraction:
            # U (ydim, s, x): ~50 MB f64 at the Stevenson shape
            U = M2 + torch.einsum("skl,nl->nsk", V3, C)
            RU = rate[:, :, None] * U
            A1Wc = RU.sum(1)  # sum rate * u
            H_cc = (RU.transpose(1, 2) @ U + W) / R  # (sum rate * u u^T + W) / R
        else:
            A1 = rate @ M2  # sum rate * m
            Wc = torch.einsum("nkl,nl->nk", W, C)  # sum rate * (V c)
            A1Wc = A1 + Wc
            S_mm = (rate @ P2).reshape(ydim, xdim, xdim)
            S_mv = (rate @ MV).reshape(ydim, xdim, xdim, xdim)  # [n,k,l,j]: m_k V_lj
            T2 = torch.einsum("nklj,nj->nkl", S_mv, C)  # sum rate * m (Vc)^T
            S_vv = (rate @ VV).reshape(ydim, xdim, xdim, xdim, xdim)  # [n,k,i,l,j]
            T4 = torch.einsum("nkilj,ni,nj->nkl", S_vv, C, C)
            H_cc = (S_mm + T2 + T2.transpose(1, 2) + T4 + W) / R

        g_c = -(Ym - A1Wc) / R
        g_d = -(Ysum - rsum) / R
        g = torch.cat([g_c, g_d[:, None]], dim=1)  # (ydim, q)
        H_cd = A1Wc / R
        H_dd = rsum / R
        top = torch.cat([H_cc, H_cd[:, :, None]], dim=2)
        bot = torch.cat([H_cd, H_dd[:, None]], dim=1)[:, None, :]
        return g, torch.cat([top, bot], dim=1)  # (ydim, q, q)

    slack_coef = 0.0 if C0.dtype == torch.float64 else 2e-6
    eye_q = torch.eye(q, dtype=C0.dtype, device=C0.device)
    th = theta0
    rate = rates(th)
    f = cost_from(th, rate)
    tdamp = torch.ones(ydim, dtype=C0.dtype, device=C0.device)
    acc = torch.zeros((), dtype=torch.int32, device=C0.device)
    for _ in range(n_iter):
        g, H = grad_hess(th, rate)
        step = solve_psd_mixed(H + 1e-10 * eye_q, g)
        cand = th - tdamp[:, None] * step
        rate_c = rates(cand)
        f_c = cost_from(cand, rate_c)
        f_c = torch.where(torch.isfinite(f_c), f_c, torch.inf)
        better = f_c < f + slack_coef * (1.0 + f.abs())
        th = torch.where(better[:, None], cand, th)
        f = torch.where(better, torch.minimum(f_c, f), f)
        rate = torch.where(better[:, None], rate_c, rate)
        tdamp = torch.where(better, torch.ones_like(tdamp), 0.25 * tdamp)
        acc = acc + better.any().to(torch.int32)
    g, _ = grad_hess(th, rate)
    return CdResult(C=th[:, :-1], d=th[:, -1], cost=f.sum(), grad_norm=g.abs().amax(),
                    niter=acc)


def learn_cd(Y, means, vsms, C0, d0,
             prior: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
             maxiter: int = 500, method: str = "newton") -> CdResult:
    """Optimize (C, d) from the current posterior moments: the per-neuron
    batched Newton with ``min(maxiter, 10)`` steps."""
    if method != "newton" or prior is not None:
        raise NotImplementedError(
            "learn_cd: only the unregularized Newton path is ported "
            "(L-BFGS and the online-EM prior come later)")
    return learn_cd_newton(Y, means, vsms, C0, d0, n_iter=min(maxiter, 10))
