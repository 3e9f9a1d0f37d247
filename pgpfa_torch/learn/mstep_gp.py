"""M-step for the GP timescales (tau) (PyTorch port of ``pgpfa/learn/mstep_gp.py``).

Per-latent GP marginal-likelihood objective in ``p = log gamma`` space::

    f(p)  = 0.5 R logdet K(p) + 0.5 <K(p)^{-1}, PautoSum_k>
    K(p)  = (1 - eps) exp(-exp(p)/2 difSq) + eps I
    PautoSum_k = sum_r [ vsmGP_{r,k} + m_{r,k} m_{r,k}^T ]

minimized by a fixed number of guarded Newton steps on analytic derivatives.
The latents (and the two candidates per step) form one batch of ``(T, T)``
matrices, so every factorization and Newton-Schulz step is one batched call.

The banded (long-trial) M-step, :func:`learn_tau_banded`, evaluates the same
cost on block-tridiagonal algebra in O(T s^2) (:func:`tau_cost_banded`) and
minimizes it by a guarded secant Newton on its exact autograd gradient.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pgpfa_torch.models.params import (
    log_gamma_to_tau,
    rbf_kernel_from_gamma,
    tau_to_log_gamma,
    time_sqdist,
)
from pgpfa_torch.ops.blockmat import inv_psd_mixed, logdet_psd_mixed, solve_psd_mixed, trace
from pgpfa_torch.ops.blocktridiag import btd_factor, btd_selected_inverse, btd_solve


class TauResult(NamedTuple):
    tau: torch.Tensor  # (xdim,) seconds
    cost: torch.Tensor  # (xdim,)
    niter: torch.Tensor  # (xdim,)


def pauto_sum(means: torch.Tensor, vsm_gps: torch.Tensor) -> torch.Tensor:
    """Per-latent posterior second moments summed over trials: ``(xdim, T, T)``."""
    return torch.einsum("rkt,rku->ktu", means, means) + vsm_gps.sum(0)


def tau_cost(p, pauto_k, num_trials, dif_sq, eps: float = 0.001) -> torch.Tensor:
    """Negative per-latent GP marginal-likelihood term, batched:
    ``p (n,)``, ``pauto_k (n, T, T)`` -> ``(n,)``."""
    K = rbf_kernel_from_gamma(p, dif_sq, eps)
    logdet = logdet_psd_mixed(K)
    Kinv_ps = solve_psd_mixed(K, pauto_k)
    return 0.5 * num_trials * logdet + 0.5 * trace(Kinv_ps)


def tau_cost_with_prior(p, pauto_k, num_trials, dif_sq, bin_size_ms, old_tau, stepsize,
                        eps: float = 0.001) -> torch.Tensor:
    """:func:`tau_cost` plus the online-EM proximal penalty
    ``0.5 (tau - old_tau)^2 / stepsize^2``, with tau in seconds."""
    tau = log_gamma_to_tau(p, bin_size_ms)
    reg = 0.5 * (tau - old_tau) ** 2 / stepsize**2
    return tau_cost(p, pauto_k, num_trials, dif_sq, eps) + reg


def _tau_derivatives(p, pauto_k, num_trials, dif_sq, eps):
    """Analytic ``(grad, curvature)`` of :func:`tau_cost`, batched over ``p``.

    With ``a = exp(p)``, ``S = (1-eps) exp(-a/2 difSq)``, ``K = S + eps I``,
    ``K' = S B``, ``K'' = S (B^2 + B)``, ``B = -a difSq / 2``,
    ``M = Kinv K'``, ``N = M Kinv``::

        g = 0.5 R tr M - 0.5 <N, P>
        h = 0.5 R (tr(Kinv K'') - tr(M M)) - 0.5 <Kinv K'' Kinv - 2 M N, P>
    """
    a = torch.exp(p)[..., None, None]
    T = dif_sq.shape[-1]
    S = (1.0 - eps) * torch.exp(-0.5 * a * dif_sq)
    K = S + eps * torch.eye(T, dtype=dif_sq.dtype, device=dif_sq.device)
    B = -0.5 * a * dif_sq
    Kp = S * B
    Kpp = S * (B * B + B)

    Kinv = inv_psd_mixed(K)
    M = Kinv @ Kp
    N = M @ Kinv
    g = 0.5 * num_trials * trace(M) - 0.5 * (N * pauto_k).sum((-2, -1))

    KinvKpp = Kinv @ Kpp
    tr_MM = (M * M.transpose(-1, -2)).sum((-2, -1))
    dN = KinvKpp @ Kinv - 2.0 * (M @ N)
    h = 0.5 * num_trials * (trace(KinvKpp) - tr_MM) - 0.5 * (dN * pauto_k).sum((-2, -1))
    return g, h


def learn_tau(
    means: torch.Tensor,
    vsm_gps: torch.Tensor,
    tau0: torch.Tensor,
    bin_size_ms: float,
    prior: Optional[tuple] = None,
    eps: float = 0.001,
    maxiter: int = 12,
) -> TauResult:
    """Optimize every latent's timescale with ``maxiter`` guarded Newton steps.

    ``prior`` is an optional ``(old_tau (xdim,), stepsize)`` proximal penalty
    (online EM, :func:`tau_cost_with_prior`); its gradient and curvature in
    ``p`` are added analytically (``dtau/dp = -tau/2``).
    """
    precomp = pauto_sum(means, vsm_gps)
    num_trials = float(means.shape[0])
    T = precomp.shape[-1]
    dif_sq = time_sqdist(T, dtype=precomp.dtype, device=precomp.device)
    p0 = tau_to_log_gamma(tau0.reshape(-1), bin_size_ms)
    xdim = p0.shape[0]
    lane = torch.arange(xdim, device=p0.device)

    if prior is None:
        def cost_fn(k, p):
            return tau_cost(p, precomp[k], num_trials, dif_sq, eps)

        def gh_fn(k, p):
            return _tau_derivatives(p, precomp[k], num_trials, dif_sq, eps)
    else:
        old_tau, stepsize = prior
        old = old_tau.reshape(-1)

        def cost_fn(k, p):
            return tau_cost_with_prior(p, precomp[k], num_trials, dif_sq, bin_size_ms, old[k],
                                       stepsize, eps)

        def gh_fn(k, p):
            g, h = _tau_derivatives(p, precomp[k], num_trials, dif_sq, eps)
            tau = log_gamma_to_tau(p, bin_size_ms)
            g_reg = (tau - old[k]) / stepsize**2 * (-0.5 * tau)
            h_reg = (0.25 * tau**2 + (tau - old[k]) * 0.25 * tau) / stepsize**2
            return g + g_reg, h + h_reg

    x, f, acc = _run_tau_newton(p0, lane, cost_fn, gh_fn, maxiter)
    return TauResult(tau=log_gamma_to_tau(x, bin_size_ms), cost=f, niter=acc)


def _run_tau_newton(p0, lane, cost_fn, gh_fn, n_iter):
    """Fixed-iteration guarded Newton over latents: each step tries the
    Newton step and a 4x-damped one (one batched cost evaluation of both)
    and keeps the best objective seen."""
    lane2 = torch.cat([lane, lane])
    x = p0
    f = cost_fn(lane, p0)
    acc = torch.zeros(lane.shape, dtype=torch.int32, device=lane.device)
    for _ in range(n_iter):
        g, h = gh_fn(lane, x)
        newton = g / torch.clamp(h, min=1e-12)
        step = torch.where(h > 1e-12, newton, torch.clamp(g, -1.0, 1.0))
        step = torch.clamp(step, -3.0, 3.0)
        cand1 = x - step
        cand2 = x - 0.25 * step
        f1, f2 = cost_fn(lane2, torch.cat([cand1, cand2])).chunk(2)
        f1 = torch.where(torch.isfinite(f1), f1, torch.inf)
        f2 = torch.where(torch.isfinite(f2), f2, torch.inf)
        use2 = f2 < f1
        f_new = torch.where(use2, f2, f1)
        x_new = torch.where(use2, cand2, cand1)
        better = f_new < f
        x = torch.where(better, x_new, x)
        f = torch.where(better, f_new, f)
        acc = acc + better.to(torch.int32)
    return x, f, acc


# --------------------------------------------------------------------------
# banded (long-trial) tau M-step: linear in T
# --------------------------------------------------------------------------


def _btd_kernel_blocks_p(p: torch.Tensor, nb: int, s: int, eps: float):
    """Banded RBF prior blocks in the M-step's ``p = log gamma`` space,
    batched over ``p (...)``: ``(Kd (..., nb, s, s), Kb (..., nb-1, s, s))``.
    The entries of :func:`rbf_kernel_from_gamma` up to one block off the
    diagonal, the banding the long-trial E-step applies to the prior."""
    t = torch.arange(s, dtype=p.dtype, device=p.device)
    d0 = t[:, None] - t[None, :]
    d1 = (t[:, None] + s) - t[None, :]
    a = torch.exp(p)[..., None, None]
    eye = torch.eye(s, dtype=p.dtype, device=p.device)
    Kd = (1.0 - eps) * torch.exp(-0.5 * a * (d0 * d0)) + eps * eye
    Kb = (1.0 - eps) * torch.exp(-0.5 * a * (d1 * d1))
    return (Kd[..., None, :, :].expand(*p.shape, nb, s, s),
            Kb[..., None, :, :].expand(*p.shape, max(nb - 1, 0), s, s))


def tau_cost_banded(p, means_blk, Vd, Vo, num_trials, eps: float = 0.001) -> torch.Tensor:
    """Per-latent banded GP marginal-likelihood term, O(T s^2), batched over
    lanes ``p (L,)``. With ``P = sum_r m_r m_r^T + V`` and ``V`` banded::

        f(p) = 0.5 R logdet K + 0.5 sum_r m_r^T K^{-1} m_r
             + 0.5 [<Sel(K^{-1}).diag, Vd> + 2 <Sel(K^{-1}).off1, Vo>]

    The trace term is exact for the banded covariance (its off-band blocks
    are zero), so only the selected blocks of ``K^{-1}`` are formed.
    Differentiable in ``p`` by autograd, the block inverses by their exact
    rules.

    Args:
        p: ``(L,)`` log gamma.
        means_blk: ``(L, R, nb, s)`` posterior means of each lane's latent.
        Vd: ``(L, nb, s, s)`` banded covariance diagonal blocks summed over
            trials.
        Vo: ``(L, nb-1, s, s)`` first off-diagonal blocks, block ``(i+1, i)``.
    """
    nb, s = Vd.shape[-3], Vd.shape[-1]
    fac = btd_factor(*_btd_kernel_blocks_p(p, nb, s, eps))
    rhs = means_blk.movedim(-3, -1)  # (L, nb, s, R): R right-hand sides
    quad = (rhs * btd_solve(fac, rhs)).sum((-3, -2, -1))
    sel = btd_selected_inverse(fac)
    trv = (sel.diag * Vd).sum((-3, -2, -1)) + 2.0 * (sel.off1 * Vo).sum((-3, -2, -1))
    return 0.5 * num_trials * fac.logdet + 0.5 * (quad + trv)


def learn_tau_banded(
    means: torch.Tensor,
    vsm_gp_diag: torch.Tensor,
    vsm_gp_off: torch.Tensor,
    tau0: torch.Tensor,
    bin_size_ms: float,
    num_trials=None,
    prior: Optional[tuple] = None,
    eps: float = 0.001,
    maxiter: int = 16,
) -> TauResult:
    """Timescale M-step from banded posterior moments, O(T s^2).

    The optimum of :func:`learn_tau` up to the banding; the optimizer is
    :func:`_run_tau_secant` on the exact gradient of :func:`tau_cost_banded`
    (``torch.autograd.grad`` of the cost summed over the lanes, which are
    independent); the second derivative is never formed.

    Args:
        means: ``(R, xdim, T)`` posterior means.
        vsm_gp_diag: ``(R, xdim, nb, s, s)`` banded covariance diagonal blocks.
        vsm_gp_off: ``(R, xdim, nb-1, s, s)`` first off-diagonal blocks.
        prior: optional ``(old_tau (xdim,), stepsize)`` proximal penalty
            ``0.5 (tau - old_tau)^2 / stepsize^2`` (online EM), as in
            :func:`learn_tau`.
    """
    R, xdim, nb, s, _ = vsm_gp_diag.shape
    num_trials = float(R if num_trials is None else num_trials)
    means_blk = means.reshape(R, xdim, nb, s).transpose(0, 1)  # (xdim, R, nb, s)
    Vd = vsm_gp_diag.sum(0)
    Vo = vsm_gp_off.sum(0)
    p0 = tau_to_log_gamma(tau0.reshape(-1), bin_size_ms)

    def vg(p, k):
        """Cost and gradient of the lanes ``p`` on the latents ``k``."""
        with torch.enable_grad():
            p = p.detach().requires_grad_(True)
            f = tau_cost_banded(p, means_blk[k], Vd[k], Vo[k], num_trials, eps)
            if prior is not None:
                old_tau, stepsize = prior
                tau = log_gamma_to_tau(p, bin_size_ms)
                f = f + 0.5 * (tau - old_tau.reshape(-1)[k]) ** 2 / stepsize**2
            (g,) = torch.autograd.grad(f.sum(), p)
        return f.detach(), g

    x, f, acc = _run_tau_secant(p0, torch.arange(xdim, device=p0.device), vg, maxiter)
    return TauResult(tau=log_gamma_to_tau(x, bin_size_ms), cost=f, niter=acc)


def _run_tau_secant(p0, lane, vg, n_iter):
    """Fixed-iteration guarded secant Newton over latents: each step takes
    its curvature from the secant of consecutive exact gradients, tries the
    step and a 4x-damped one (one batched evaluation of both) and keeps the
    best objective seen. A rejected step keeps the best point but refreshes
    the secant pair with the probe, so the next curvature uses it."""
    lane2 = torch.cat([lane, lane])
    f, g = vg(p0, lane)
    xp = p0 + 0.05  # the secant pair starts from a small probe
    _, gp = vg(xp, lane)
    x = p0
    acc = torch.zeros(lane.shape, dtype=torch.int32, device=lane.device)
    for _ in range(n_iter):
        dx = x - xp
        h = torch.where(dx.abs() > 1e-14, (g - gp) / torch.where(dx == 0, 1.0, dx), 0.0)
        ok = torch.isfinite(h) & (h > 1e-10)
        step = torch.where(ok, g / torch.where(ok, h, 1.0), g.clamp(-0.5, 0.5)).clamp(-2.0, 2.0)
        cand1, cand2 = x - step, x - 0.25 * step
        f12, g12 = vg(torch.cat([cand1, cand2]), lane2)
        f1, f2 = f12.chunk(2)
        g1, g2 = g12.chunk(2)
        f1 = torch.where(torch.isfinite(f1), f1, torch.inf)
        f2 = torch.where(torch.isfinite(f2), f2, torch.inf)
        use2 = f2 < f1
        f_new = torch.where(use2, f2, f1)
        x_new = torch.where(use2, cand2, cand1)
        g_new = torch.where(use2, g2, g1)
        better = f_new < f
        x, f, g, xp, gp = (torch.where(better, x_new, x), torch.where(better, f_new, f),
                           torch.where(better, g_new, g), torch.where(better, x, x_new),
                           torch.where(better, g, g_new))
        acc = acc + better.to(torch.int32)
    return x, f, acc
