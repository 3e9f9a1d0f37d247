"""M-step for the observation parameters (C, d) (PyTorch port of
``pgpfa/learn/mstep_obs.py``).

Expected-complete-data Poisson cost::

    cost(C, d) = -(1/R) sum_{r,n,t} [ Y*hh - exp(hh + rho/2) ]
    hh[n, t]  = (C m_r)[n, t] + d[n]
    rho[n, t] = C[n] @ vsm_r[t] @ C[n]

The cost separates per neuron, so the M-step is ``ydim`` independent
``(xdim+1)``-parameter Newton problems solved together with a fixed number of
guarded steps; their ``(ydim, q, q)`` systems go through the f32 ``chol32``
factorization with f64 refinement. Online EM adds a proximal penalty centered
at the old parameters: per-neuron blocks on the Newton path, a dense matrix
over the packed vector on the L-BFGS path, and the C-only update with a
closed-form ``d``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from pgpfa_torch.models.params import pack_cd, unpack_cd
from pgpfa_torch.ops.blockmat import solve_psd_mixed
from pgpfa_torch.utils.optim import minimize_lbfgs
from pgpfa_torch.utils.reduce import Reduce, trial_count


class CdResult(NamedTuple):
    C: torch.Tensor
    d: torch.Tensor
    cost: torch.Tensor
    grad_norm: torch.Tensor
    niter: torch.Tensor


def cd_cost_sum(vec: torch.Tensor, Y: torch.Tensor, means: torch.Tensor,
                vsms: torch.Tensor) -> torch.Tensor:
    """Negative expected complete-data log-likelihood of packed (C, d),
    summed over the trials of ``Y (R, ydim, T)``; ``means (R, xdim, T)``,
    ``vsms (R, T, xdim, xdim)``."""
    ydim = Y.shape[1]
    xdim = means.shape[1]
    C, d = unpack_cd(vec, xdim, ydim)
    hh = torch.einsum("nk,rkt->rnt", C, means) + d[None, :, None]
    quad = torch.einsum("nk,rtkl,nl->rnt", C, vsms, C)
    rate = torch.exp(hh + 0.5 * quad)
    return -(Y * hh - rate).sum()


def cd_cost(vec: torch.Tensor, Y: torch.Tensor, means: torch.Tensor,
            vsms: torch.Tensor, reduce: Reduce = None) -> torch.Tensor:
    """:func:`cd_cost_sum` / R: the mean over trials, over the trials of all
    ranks with ``reduce`` (the sum and the count in one collective; not
    differentiable then)."""
    s = cd_cost_sum(vec, Y, means, vsms)
    if reduce is None:
        return s / Y.shape[0]
    tot = reduce(torch.stack([s, s.new_full((), Y.shape[0])]))
    return tot[0] / tot[1]


def cd_cost_with_prior(vec, Y, means, vsms, center, inv_prior_cov) -> torch.Tensor:
    """:func:`cd_cost` plus the proximal penalty ``0.5 (v - v0)^T P (v - v0)``
    centered at the old packed parameters, ``P`` positive semidefinite."""
    dv = vec - center
    return cd_cost(vec, Y, means, vsms) + 0.5 * dv @ (inv_prior_cov @ dv)


class _CdMoments:
    """Posterior-moment tensors of one E-step over the flattened sample axis
    ``s = R*T`` (``m``, ``V``, ``m (x) m``, ``m (x) V``, ``V (x) V``), formed
    once, so every per-neuron statistic of the (C, d) cost is one
    ``(ydim, s) @ (s, x^k)`` matmul against the current rates. Above xdim 8
    the ``x^4`` tensor is never formed: the Hessian's second-moment block is
    the weighted outer-product sum of ``u = m + V c`` per (neuron, sample).
    ``theta (ydim, q)`` holds each neuron's ``[c, d]``, ``q = xdim + 1``.
    Every statistic is divided by ``R``, the local trial count, or by
    ``num_trials`` where given (the count over all ranks)."""

    def __init__(self, Y, means, vsms, num_trials=None):
        R, self.ydim, T = Y.shape
        self.R = R if num_trials is None else num_trials
        self.xdim = xdim = means.shape[1]
        s = R * T
        self.contraction = xdim > 8
        self.M2 = means.transpose(1, 2).reshape(s, xdim)  # (s, x)
        self.Vf = vsms.reshape(s, xdim * xdim)  # (s, x^2)
        if self.contraction:
            self.V3 = vsms.reshape(s, xdim, xdim)
        else:
            M2, Vf = self.M2, self.Vf
            self.P2 = (M2[:, :, None] * M2[:, None, :]).reshape(s, xdim * xdim)  # m (x) m
            self.MV = (M2[:, :, None] * Vf[:, None, :]).reshape(s, xdim**3)  # m (x) V
            self.VV = (Vf[:, :, None] * Vf[:, None, :]).reshape(s, xdim**4)  # V (x) V
        Yf = Y.transpose(0, 1).reshape(self.ydim, s)  # (ydim, s)
        self.Ym = Yf @ self.M2  # (ydim, x): sum_s y m
        self.Ysum = Yf.sum(1)  # (ydim,)

    def rates(self, theta):
        C, dn = theta[:, :-1], theta[:, -1]
        O = (C[:, :, None] * C[:, None, :]).reshape(self.ydim, self.xdim**2)
        eta = C @ self.M2.T + 0.5 * (O @ self.Vf.T) + dn[:, None]  # (ydim, s)
        return torch.exp(eta)

    def cost(self, theta, rate):
        """Per-neuron costs ``(ydim,)``; the ``y hh`` sum is linear in theta."""
        C, dn = theta[:, :-1], theta[:, -1]
        y_hh = (C * self.Ym).sum(1) + dn * self.Ysum
        return -(y_hh - rate.sum(1)) / self.R

    def grad_hess(self, theta, rate):
        """Per-neuron gradients ``(ydim, q)`` and Hessians ``(ydim, q, q)``."""
        R, ydim, xdim = self.R, self.ydim, self.xdim
        C = theta[:, :-1]
        W = (rate @ self.Vf).reshape(ydim, xdim, xdim)  # sum rate * V
        rsum = rate.sum(1)
        if self.contraction:
            # U (ydim, s, x): ~50 MB f64 at the Stevenson shape
            U = self.M2 + torch.einsum("skl,nl->nsk", self.V3, C)
            RU = rate[:, :, None] * U
            A1Wc = RU.sum(1)  # sum rate * u
            H_cc = (RU.transpose(1, 2) @ U + W) / R  # (sum rate * u u^T + W) / R
        else:
            A1 = rate @ self.M2  # sum rate * m
            Wc = torch.einsum("nkl,nl->nk", W, C)  # sum rate * (V c)
            A1Wc = A1 + Wc
            S_mm = (rate @ self.P2).reshape(ydim, xdim, xdim)
            S_mv = (rate @ self.MV).reshape(ydim, xdim, xdim, xdim)  # [n,k,l,j]: m_k V_lj
            T2 = torch.einsum("nklj,nj->nkl", S_mv, C)  # sum rate * m (Vc)^T
            S_vv = (rate @ self.VV).reshape(ydim, xdim, xdim, xdim, xdim)  # [n,k,i,l,j]
            T4 = torch.einsum("nkilj,ni,nj->nkl", S_vv, C, C)
            H_cc = (S_mm + T2 + T2.transpose(1, 2) + T4 + W) / R

        g_c = -(self.Ym - A1Wc) / R
        g_d = -(self.Ysum - rsum) / R
        g = torch.cat([g_c, g_d[:, None]], dim=1)  # (ydim, q)
        H_cd = A1Wc / R
        H_dd = rsum / R
        top = torch.cat([H_cc, H_cd[:, :, None]], dim=2)
        bot = torch.cat([H_cd, H_dd[:, None]], dim=1)[:, None, :]
        return g, torch.cat([top, bot], dim=1)


def neuron_grad_hess(theta, Y, means, vsms, reduce: Reduce = None):
    """Analytic gradients ``(ydim, q)`` and Hessians ``(ydim, q, q)`` of every
    neuron's share of :func:`cd_cost` at ``theta (ydim, q)``, rows
    ``[C[n], d[n]]``: the exact Hessian of the cost is block-diagonal per
    neuron. ``reduce`` (sums over ranks) makes them those of the mean over
    the trials of all ranks: the count, then both packed in one tensor, are
    summed over ranks."""
    if reduce is None:
        mom = _CdMoments(Y, means, vsms)
        return mom.grad_hess(theta, mom.rates(theta))
    mom = _CdMoments(Y, means, vsms, trial_count(Y.shape[0], theta, reduce))
    g, H = mom.grad_hess(theta, mom.rates(theta))
    ydim, q = g.shape
    gH = reduce(torch.cat([g, H.reshape(ydim, q * q)], 1))
    return gH[:, :q], gH[:, q:].reshape(ydim, q, q)


def _scatter_blocks(Hb: torch.Tensor) -> torch.Tensor:
    """Per-neuron blocks ``(ydim, q, q)`` as the dense ``(q*ydim, q*ydim)``
    matrix over a vector whose entry ``i*ydim + n`` is neuron ``n``'s
    ``i``-th parameter: ``H[i*ydim + n, j*ydim + n] = Hb[n, i, j]``."""
    ydim, q = Hb.shape[0], Hb.shape[1]
    blocks = torch.diag_embed(Hb.permute(1, 2, 0))  # [i, j, n, n]
    return blocks.permute(0, 2, 1, 3).reshape(q * ydim, q * ydim)


def cd_hessian(vec, Y, means, vsms) -> torch.Tensor:
    """Exact dense Hessian of :func:`cd_cost` over the packed vector ``vec``
    (:func:`pack_cd` order: entry ``i*ydim + n`` is ``C[n, i]``, or ``d[n]``
    at ``i = xdim``). The cost is a sum of per-neuron costs, so the Hessian
    is the per-neuron blocks of :func:`neuron_grad_hess` scattered into that
    layout, zero elsewhere."""
    C, d = unpack_cd(vec, means.shape[1], Y.shape[1])
    _, H = neuron_grad_hess(torch.cat([C, d[:, None]], dim=1), Y, means, vsms)
    return _scatter_blocks(H)


def learn_cd_newton(Y, means, vsms, C0, d0,
                    prior_blocks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    n_iter: int = 10, reduce: Reduce = None) -> CdResult:
    """All-neurons batched Newton for the (C, d) M-step, in f64 or f32, on
    the moment tensors of :class:`_CdMoments`.

    A rejected step shrinks that neuron's damping 4x for the retry; an
    accepted one resets it. In f32 a candidate within ``2e-6 (1 + |f|)`` of
    the cost is accepted (the cost cannot resolve smaller gains), and the
    carried cost stays the minimum. ``niter`` counts the iterations in which
    at least one neuron accepted.

    ``prior_blocks`` is an optional ``(P (ydim, q, q), center (ydim, q))``
    per-neuron penalty ``0.5 (th - c)^T P_n (th - c)`` (online EM); it enters
    the cost, the gradient and the Hessian, and the reported cost includes
    it.

    ``reduce`` (sums over ranks, :mod:`pgpfa_torch.utils.reduce`) makes the
    cost the mean over the trials of all ranks: the per-neuron costs, and
    the gradients and Hessians packed in one tensor, are summed over ranks
    each time they are computed, so every rank takes the same steps.
    """
    ydim, xdim = C0.shape
    q = xdim + 1
    num_trials = None if reduce is None else trial_count(Y.shape[0], C0, reduce)
    mom = _CdMoments(Y, means, vsms, num_trials)

    def cost_from(theta, rate):
        f = mom.cost(theta, rate)
        if reduce is not None:
            f = reduce(f)
        if prior_blocks is not None:
            Pb, center = prior_blocks
            dv = theta - center
            f = f + 0.5 * torch.einsum("nq,nqp,np->n", dv, Pb, dv)
        return f

    def grad_hess(theta, rate):
        g, H = mom.grad_hess(theta, rate)
        if reduce is not None:
            gH = reduce(torch.cat([g, H.reshape(ydim, q * q)], 1))
            g, H = gH[:, :q], gH[:, q:].reshape(ydim, q, q)
        if prior_blocks is not None:
            Pb, center = prior_blocks
            g = g + torch.einsum("nqp,np->nq", Pb, theta - center)
            H = H + Pb
        return g, H

    slack_coef = 0.0 if C0.dtype == torch.float64 else 2e-6
    eye_q = torch.eye(q, dtype=C0.dtype, device=C0.device)
    th = torch.cat([C0, d0[:, None]], dim=1)  # (ydim, q)
    rate = mom.rates(th)
    f = cost_from(th, rate)
    tdamp = torch.ones(ydim, dtype=C0.dtype, device=C0.device)
    acc = torch.zeros((), dtype=torch.int32, device=C0.device)
    for _ in range(n_iter):
        g, H = grad_hess(th, rate)
        step = solve_psd_mixed(H + 1e-10 * eye_q, g)
        cand = th - tdamp[:, None] * step
        rate_c = mom.rates(cand)
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
             maxiter: int = 500, tol: float = 1e-9, method: str = "newton",
             reduce: Reduce = None) -> CdResult:
    """Optimize (C, d) from the current posterior moments.

    Without a prior, ``method='newton'`` runs the per-neuron batched Newton
    with ``min(maxiter, 10)`` steps. ``method='lbfgs'`` or a dense ``prior``
    ``(inv_prior_cov, center_vec)`` over the packed vector (:func:`pack_cd`
    order) runs :func:`minimize_lbfgs` to gradient ``tol`` over that vector.
    ``reduce`` (sums over ranks) is taken by the Newton path only.
    """
    if method not in ("newton", "lbfgs"):
        raise ValueError(f"unknown method {method!r}")
    if method == "newton" and prior is None:
        return learn_cd_newton(Y, means, vsms, C0, d0, n_iter=min(maxiter, 10), reduce=reduce)
    if reduce is not None:
        raise NotImplementedError("the L-BFGS (C, d) M-step runs on one process")
    if prior is None:
        def fun(v):
            return cd_cost(v, Y, means, vsms)
    else:
        P, center = prior

        def fun(v):
            return cd_cost_with_prior(v, Y, means, vsms, center, P)
    res = minimize_lbfgs(fun, pack_cd(C0, d0), maxiter=maxiter, tol=tol)
    C, d = unpack_cd(res.x, C0.shape[1], C0.shape[0])
    return CdResult(C=C, d=d, cost=res.fun, grad_norm=res.grad_norm, niter=res.niter)


def update_d_closed_form(Y, means, vsms, C, reduce: Reduce = None) -> torch.Tensor:
    """Closed-form ``d`` given ``C`` and the posterior moments: the mean rate
    matched to the mean count, ``d = log(mean Y + 1e-5) - log(mean exp(Cm +
    q/2))``. This is the JAX package's consistent form (the original
    reference applies the log and the normalization in another order).
    ``reduce`` (sums over ranks) takes both means over the trials of all
    ranks: the count sums, the rate sums and the trial count in one
    collective."""
    hh = torch.einsum("nk,rkt->rnt", C, means)
    quad = torch.einsum("nk,rtkl,nl->rnt", C, vsms, C)
    rate = torch.exp(hh + 0.5 * quad)
    if reduce is None:
        mean_y = Y.mean((0, 2)) + 1e-5
        mean_rate = rate.mean((0, 2))
    else:
        ydim, T = Y.shape[1], Y.shape[2]
        tot = reduce(torch.cat([Y.sum((0, 2)), rate.sum((0, 2)), Y.new_full((1,), Y.shape[0])]))
        n = tot[-1] * T
        mean_y = tot[:ydim] / n + 1e-5
        mean_rate = tot[ydim:2 * ydim] / n
    return torch.log(mean_y) - torch.log(mean_rate)


def c_only_cost(vC, d, Y, means, vsms, reduce: Reduce = None) -> torch.Tensor:
    """:func:`cd_cost` as a function of ``vC = C.T.reshape(-1)``
    (latent-major) with ``d`` fixed."""
    return cd_cost(torch.cat([vC, d]), Y, means, vsms, reduce)


def c_only_grad_hess(vC, d, Y, means, vsms, reduce: Reduce = None):
    """Gradient ``(xdim*ydim,)`` and dense Hessian ``(xdim*ydim, xdim*ydim)``
    of :func:`c_only_cost` in ``vC`` order. With ``d`` fixed the cost
    separates per neuron, so the Hessian is the per-neuron ``H_cc`` blocks
    scattered by :func:`_scatter_blocks`, zero elsewhere. ``reduce`` as in
    :func:`neuron_grad_hess`."""
    ydim = d.shape[0]
    xdim = vC.shape[0] // ydim
    theta = torch.cat([vC.reshape(xdim, ydim).T, d[:, None]], dim=1)
    g, H = neuron_grad_hess(theta, Y, means, vsms, reduce)
    return g[:, :xdim].T.reshape(-1), _scatter_blocks(H[:, :xdim, :xdim])
