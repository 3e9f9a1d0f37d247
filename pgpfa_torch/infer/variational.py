"""Dual variational E-step, batched over trials (PyTorch port of
``pgpfa/infer/variational.py``).

Per trial, the dual variable ``lambda = exp(rho)`` of the variational
Gaussian posterior minimizes the dual cost in the unconstrained ``rho``; the
posterior mean is ``-K C_big (lambda - y)`` and the precision
``K^{-1} + C_big diag(lambda) C_big^T`` plus a 1e-6 relative diagonal ridge.
Every cost evaluation factors the ``(R, xdim*T, xdim*T)`` precision of all
trials at once in f32 (the ``chol32`` kernel on CUDA) and refines in f64
(the ``ns_step`` kernel for the f32 Newton-Schulz steps); the f32 fast mode
takes the f32 factor's inverse as it is.

Two solvers, chosen by the caller: ``'newton'``, a damped dual-Newton whose
direction comes by the Woodbury identity from the same factorization as the
cost (:func:`_dual_eval`), and ``'lbfgs'``, the fixed-iteration L-BFGS of
:mod:`pgpfa_torch.utils.optim` with gradients by autograd through
:func:`pgpfa_torch.ops.blockmat.logdet_psd_mixed`'s exact rule. Both run in
chunks under :func:`pgpfa_torch.utils.optim.lbfgs_chunked_driver`, one host
readback per chunk. Parity with the JAX package is on converged values:
the accept tests tie on rounding near the optimum, so iterates may differ.
"""

from __future__ import annotations

import torch

from pgpfa_torch.infer.laplace import InfRes, _where
from pgpfa_torch.models.params import rbf_kernel
from pgpfa_torch.models.poisson_gpfa import hessian_weights, neg_log_posterior
from pgpfa_torch.ops.blockmat import (
    assemble_hessian,
    blocks_inv,
    cov_views,
    inv_logdet_psd_mixed,
    inv_psd_mixed,
    logdet_psd_mixed,
)
from pgpfa_torch.utils.optim import lbfgs_chunked_driver, lbfgs_fixed_init, lbfgs_fixed_steps
from pgpfa_torch.utils.reduce import Reduce, trial_mean

SOLVERS = ("newton", "lbfgs")
# Iterations per chunk of the chunked driver (one host readback each).
NEWTON_CHUNK, LBFGS_CHUNK = 5, 25


def _posterior_precision(lam, C, Kinv, ridge=1e-6):
    """Posterior precision ``(..., D, D)`` for ``lam (..., ydim, T)`` plus the
    relative diagonal ridge."""
    prec = assemble_hessian(hessian_weights(C, lam), Kinv)
    return prec + ridge * torch.diag_embed(prec.diagonal(dim1=-2, dim2=-1))


def _prior_terms(rho, Y, C, d, K):
    """``(lam, a + b + e, Ku)`` of the dual cost: every term but the logdet."""
    lam = torch.exp(rho)
    lmy = lam - Y
    u = C.T @ lmy  # (..., xdim, T)
    Ku = torch.einsum("ktu,...ku->...kt", K, u)
    a = 0.5 * (u * Ku).sum((-2, -1))
    b = -(d * lmy.sum(-1)).sum(-1)
    e = (lam * (rho - 1.0)).sum((-2, -1))
    return lam, a + b + e, Ku


def dual_cost(rho, Y, C, d, K, Kinv, ridge=1e-6):
    """Dual cost per trial, ``(...)``, for ``rho, Y (..., ydim, T)``:
    ``0.5 u^T K u - d^T sum_t (lam - y) + 0.5 logdet(cov) + lam^T (rho - 1)``
    with ``u = C_big (lam - y)``. Differentiable in ``rho``."""
    lam, abe, _ = _prior_terms(rho, Y, C, d, K)
    return abe - 0.5 * logdet_psd_mixed(_posterior_precision(lam, C, Kinv, ridge))


def _posterior_sandwich_diag(Sig, C, ridge, xdim, T):
    """``diag(C_big^T Sigma C_big)`` as ``(..., ydim, T)`` plus the ridge
    correction that makes it the exact derivative of the ridged logdet."""
    ydim = C.shape[0]
    vsm, _ = cov_views(Sig, xdim, T)  # (..., T, xdim, xdim)
    CC = (C[:, :, None] * C[:, None, :]).reshape(ydim, xdim * xdim)
    s = CC @ vsm.reshape(*vsm.shape[:-2], xdim * xdim).transpose(-1, -2)
    return s + ridge * ((C * C) @ vsm.diagonal(dim1=-2, dim2=-1).transpose(-1, -2))


def _dual_eval(rho, Y, C, d, K, Kinv, ridge):
    """Dual cost, rho-space gradient and damped-Newton direction of every
    trial from ONE factorization of the posterior precision.

    The lambda-space dual Hessian is ``G + diag(1/lam) + 0.5 M o M`` with
    ``G = C_big^T K C_big`` and ``M = C_big^T Sigma C_big``. Without the
    Hadamard term, the Woodbury identity inverts ``G + diag(1/lam)`` through
    the capacitance ``K^{-1} + C_big diag(lam) C_big^T``, the precision the
    logdet already factors.
    """
    xdim, T = K.shape[0], K.shape[1]
    lam, abe, Ku = _prior_terms(rho, Y, C, d, K)
    Sig, ld = inv_logdet_psd_mixed(_posterior_precision(lam, C, Kinv, ridge))
    f = abe - 0.5 * ld
    h = d[:, None] - C @ Ku  # linear predictor at the posterior mean
    g = rho - h - 0.5 * _posterior_sandwich_diag(Sig, C, ridge, xdim, T)
    w = lam * g
    z = Sig @ (C.T @ w).reshape(*w.shape[:-2], xdim * T, 1)
    drho = C @ z.reshape(*w.shape[:-2], xdim, T) - g
    return f, w, drho


def _newton_vi_init(rho0):
    """Initial carry ``(rho_b, f_b, g_b, dr_b, rho_try, t)`` of
    :func:`_newton_vi_steps` for ``rho0 (R, ydim, T)``."""
    lane = rho0.new_ones(rho0.shape[0])
    return (rho0, torch.inf * lane, torch.zeros_like(rho0), torch.zeros_like(rho0), rho0, lane)


def _newton_vi_steps(carry, Y, C, d, K, Kinv, ridge, n_iter, clip_step=15.0):
    """``n_iter`` damped dual-Newton iterations on every trial.

    Deferred accept, one :func:`_dual_eval` per iteration: evaluate the trial
    point; where it improves on the incumbent accept it and double the step
    scale (at most 1), else halve the scale and propose again from the
    incumbent. ``clip_step`` bounds the move in log space so ``exp`` cannot
    overflow on a wild cold-start direction.
    """
    rho_b, f_b, g_b, dr_b, rho_try, t = carry
    for _ in range(n_iter):
        f_try, g_try, dr_try = _dual_eval(rho_try, Y, C, d, K, Kinv, ridge)
        f_try = torch.where(torch.isfinite(f_try), f_try, torch.inf)
        ok = f_try < f_b
        rho_b = _where(ok, rho_try, rho_b)
        f_b = torch.where(ok, f_try, f_b)
        g_b = _where(ok, g_try, g_b)
        dr_b = _where(ok, dr_try, dr_b)
        t = torch.where(ok, torch.clamp(2.0 * t, max=1.0), 0.5 * t)
        rho_try = rho_b + t[:, None, None] * dr_b.clamp(-clip_step, clip_step)
    return rho_b, f_b, g_b, dr_b, rho_try, t


def vi_posterior_mean(rho, Y, C, K):
    """``-K C_big (lam - y)`` in block form, ``(..., xdim, T)``."""
    u = C.T @ (torch.exp(rho) - Y)
    return -torch.einsum("ktu,...ku->...kt", K, u)


def _solve_dual(C, d, K, Kinv, Y, rho_init, maxiter, gtol, ridge, solver):
    """Minimize every trial's dual; returns ``(rho, bound)`` per trial."""
    if solver not in SOLVERS:
        raise ValueError(f"unknown VI solver {solver!r}; choose 'newton' or 'lbfgs'")
    slack_coef = 1e-13 if C.dtype == torch.float64 else 1e-6
    if solver == "newton":
        def make_step(n):
            return lambda c: _newton_vi_steps(c, Y, C, d, K, Kinv, ridge, n)

        carry = lbfgs_chunked_driver(make_step, _newton_vi_init(rho_init), maxiter,
                                     chunk=NEWTON_CHUNK, slack_coef=slack_coef, gtol=gtol)
        return carry[0], carry[1]

    def dual(r):
        return dual_cost(r, Y, C, d, K, Kinv, ridge)

    shape = rho_init.shape[1:]
    carry = lbfgs_chunked_driver(lambda n: lambda c: lbfgs_fixed_steps(dual, c, n, shape),
                                 lbfgs_fixed_init(dual, rho_init), maxiter,
                                 chunk=LBFGS_CHUNK, slack_coef=slack_coef, gtol=gtol)
    return carry[0].reshape(rho_init.shape), carry[1]


def _posterior_cov(rho, C, Kinv, ridge):
    """Posterior covariance at the dual solution: the inverse of the
    precision, factored anew."""
    return inv_psd_mixed(_posterior_precision(torch.exp(rho), C, Kinv, ridge))


def vi_estep_from_arrays(
    C,
    d,
    tau,
    Y,
    T: int,
    bin_size_ms: float,
    rho_init=None,
    gtol: float = 1e-8,
    maxiter: int = 150,
    compute_cov: bool = True,
    eps_noise: float = 0.001,
    ridge: float = 1e-6,
    solver: str = "lbfgs",
    reduce: Reduce = None,
):
    """Batched dual variational inference over all trials (f64, or the f32
    fast mode).

    Args:
        C, d, tau: model parameters (tensors on one device, f64 or f32).
        Y: spike counts ``(R, ydim, T)``.
        rho_init: warm start ``(R, ydim, T)`` (zeros if None).
        maxiter: iteration budget of the dual solve.
        solver: ``'lbfgs'`` or ``'newton'``; both drive the same dual
            gradient to ``gtol``.
        reduce: sums over ranks (:mod:`pgpfa_torch.utils.reduce`); then
            both means run over the trials of all ranks.

    Returns:
        ``(InfRes, post_loglik, var_lower_bound, rho)``: ``post_loglik`` is
        minus the mean Laplace objective at the posterior means,
        ``var_lower_bound`` the mean converged dual cost; ``newton_iters``
        are zeros.
    """
    R, ydim, _ = Y.shape
    xdim = C.shape[1]
    K = rbf_kernel(tau, T, bin_size_ms, eps_noise)
    Kinv = blocks_inv(K)
    if rho_init is None:
        rho_init = torch.zeros((R, ydim, T), dtype=C.dtype, device=C.device)

    rho, bound = _solve_dual(C, d, K, Kinv, Y, rho_init, maxiter, gtol, ridge, solver)
    means = vi_posterior_mean(rho, Y, C, K)
    cov = _posterior_cov(rho, C, Kinv, ridge)
    vsm, vsm_gp = cov_views(cov, xdim, T)
    obj = neg_log_posterior(means, Y, C, d, Kinv)
    res = InfRes(
        post_mean=means,
        post_vsm=vsm,
        post_vsm_gp=vsm_gp,
        post_cov=cov if compute_cov else None,
        trial_obj=obj,
        newton_iters=torch.zeros((R,), dtype=torch.int32, device=C.device),
    )
    if reduce is None:
        return res, -obj.mean(), bound.mean(), rho
    means = trial_mean(torch.stack([obj, bound], 1), reduce)
    return res, -means[0], means[1], rho


def vi_estep(params, Y, T: int, bin_size_ms: float, **kw):
    """:func:`vi_estep_from_arrays` taking a :class:`Params`."""
    return vi_estep_from_arrays(params.C, params.d, params.tau, Y, T, bin_size_ms, **kw)
