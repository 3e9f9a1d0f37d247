"""M-step for the GP timescales (tau) (PyTorch port of ``pgpfa/learn/mstep_gp.py``).

Per-latent GP marginal-likelihood objective in ``p = log gamma`` space::

    f(p)  = 0.5 R logdet K(p) + 0.5 <K(p)^{-1}, PautoSum_k>
    K(p)  = (1 - eps) exp(-exp(p)/2 difSq) + eps I
    PautoSum_k = sum_r [ vsmGP_{r,k} + m_{r,k} m_{r,k}^T ]

minimized by a fixed number of guarded Newton steps on analytic derivatives.
The latents (and the two candidates per step) form one batch of ``(T, T)``
matrices, so every factorization and Newton-Schulz step is one batched call.
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
