"""Laplace E-step: trial-batched damped Newton on the latent posterior (PyTorch).

Port of ``pgpfa/infer/laplace.py``. The JAX package ``vmap``s a per-trial
``while_loop``; here all R trials run as one batch in a Python loop with the
same per-lane semantics: a lane that is done keeps its state, the outer loop
runs while any lane is active and fewer than ``maxiter`` iterations ran, and
the backtracking loop halves ``t`` only on the lanes whose Armijo test still
fails. Each loop test is one host readback (``.any()``).

Each Newton body factors the ``(R, xdim*T, xdim*T)`` Hessian in f32 (the
``chol32`` kernel on CUDA) and, in f64, refines the direction once through
the structured product; the final ``(W, L32)`` are reused for the posterior
covariance. The f32 fast mode has no refinement, looser tolerances and a
stall cutoff, as the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pgpfa_torch.convert import to_numpy
from pgpfa_torch.models.params import Params, rbf_kernel
from pgpfa_torch.models.poisson_gpfa import hessian_weights, linear_predictor
from pgpfa_torch.ops.blockmat import (
    assemble_hessian,
    blocks_inv,
    chol32,
    cov_views,
    inv_psd_structured,
    solve_psd_structured,
)
from pgpfa_torch.utils.reduce import Reduce, trial_mean


class InfRes(NamedTuple):
    """Posterior inference results, batched over trials."""

    post_mean: torch.Tensor  # (R, xdim, T)
    post_vsm: torch.Tensor  # (R, T, xdim, xdim)
    post_vsm_gp: torch.Tensor  # (R, xdim, T, T)
    post_cov: Optional[torch.Tensor]  # (R, xdim*T, xdim*T) or None
    trial_obj: torch.Tensor  # (R,) converged objective values
    newton_iters: torch.Tensor  # (R,) iterations used per trial

    def to_reference_dict(self) -> dict:
        """The reference's ``infRes`` layout: per-trial lists of NumPy
        arrays, ``post_vsmGP`` as ``(T, T, xdim)``."""
        return {
            "post_mean": list(to_numpy(self.post_mean)),
            "post_vsm": list(to_numpy(self.post_vsm)),
            "post_vsmGP": [v.transpose(1, 2, 0) for v in to_numpy(self.post_vsm_gp)],
            "post_cov": None if self.post_cov is None else list(to_numpy(self.post_cov)),
        }


def _where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.where`` with a per-trial ``(R,)`` mask broadcast over ``a``'s
    trailing axes."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _newton_solve(Y, X0, C, d, Kinv, weights, gtol, maxiter, max_backtracks=30):
    """Damped Newton for all trials at once. ``Y (R, ydim, T)``,
    ``X0 (R, xdim, T)``, per-neuron likelihood ``weights`` ``(ydim,)`` shared
    by all lanes or ``(R, ydim)``, one row per lane. Returns
    ``(X, f, it, W, L32)`` per trial.

    Termination per trial: gradient inf-norm <= gtol, or Newton decrement
    ``g^T H^{-1} g <= dec_tol``, or a rejected step; in f32 also an accepted
    step that gains no more than the rounding slack (the stall cutoff: the
    f32 objective cannot resolve progress there, and the decrement test can
    sit just above ``dec_tol`` on f32 gradient noise).
    """
    R, xdim, T = X0.shape
    D = xdim * T
    w = weights[..., None]
    t_min = 0.5**max_backtracks
    f64 = X0.dtype == torch.float64
    # the f64 values are out of f32's reach
    dec_tol = 1e-12 if f64 else 3e-6
    slack_coef = 1e-13 if f64 else 5e-7
    Kinv32 = Kinv.to(torch.float32)
    wY = w * Y

    def ls_eval(X, t, dX):
        """Objective at ``X - t dX`` per trial; returns ``(expA, f)``."""
        Xt = X - t[:, None, None] * dX
        A = linear_predictor(C, d, Xt)
        expA = torch.exp(A)
        f = ((w * expA).sum((1, 2)) - (wY * A).sum((1, 2))
             + 0.5 * torch.einsum("rkt,ktu,rku->r", Xt, Kinv, Xt))
        return expA, f

    def grad_hess_from(X, expA):
        """Gradient, the Hessian's time-local part, and the f32 factor of
        the f32-assembled Hessian."""
        G = C.T @ (w * (expA - Y)) + torch.einsum("ktu,rku->rkt", Kinv, X)
        W = hessian_weights(C, w * expA)
        L32 = chol32(assemble_hessian(W.to(torch.float32), Kinv32))
        return G, W, L32

    zero = torch.zeros(R, dtype=X0.dtype, device=X0.device)
    expA, f = ls_eval(X0, zero, X0)
    X = X0
    G, W, L32 = grad_hess_from(X, expA)
    it = torch.zeros(R, dtype=torch.int64, device=X0.device)
    done = G.abs().amax((1, 2)) <= gtol
    n = 0
    while n < maxiter and not bool(done.all()):
        dX = solve_psd_structured(W, Kinv, G.reshape(R, D), L32,
                                  ir_steps=1 if f64 else 0).reshape(R, xdim, T)
        slope = (G * dX).sum((1, 2))
        converged = slope <= dec_tol
        slack = slack_coef * (1.0 + f.abs())

        # backtracking line search, per lane
        t = torch.ones_like(f)
        expA_t, f_try = ls_eval(X, t, dX)
        while True:
            bad = ~torch.isfinite(f_try) | (f_try > f - 1e-4 * t * slope + slack)
            shrink = bad & (t > t_min) & ~done
            if not bool(shrink.any()):
                break
            t = torch.where(shrink, 0.5 * t, t)
            expA_s, f_s = ls_eval(X, t, dX)
            expA_t = _where(shrink, expA_s, expA_t)
            f_try = torch.where(shrink, f_s, f_try)

        accept = torch.isfinite(f_try) & (f_try <= f + slack) & ~converged
        X_new = _where(accept, X - t[:, None, None] * dX, X)
        f_new = torch.where(accept, torch.minimum(f_try, f), f)
        expA_new = _where(accept, expA_t, expA)
        G_new, W_new, L32_new = grad_hess_from(X_new, expA_new)
        done_new = converged | (G_new.abs().amax((1, 2)) <= gtol) | ~accept
        if not f64:
            done_new = done_new | (accept & (f - f_try <= slack))
        # lanes done in an earlier iteration keep their state
        X = _where(done, X, X_new)
        f = torch.where(done, f, f_new)
        G = _where(done, G, G_new)
        W = _where(done, W, W_new)
        L32 = _where(done, L32, L32_new)
        expA = _where(done, expA, expA_new)
        it = torch.where(done, it, it + 1)
        done = done | done_new
        n += 1
    # (W, L32) are evaluated at the returned mode X of every lane.
    return X, f, it, W, L32


def laplace_estep_from_arrays(
    C,
    d,
    tau,
    Y,
    T: int,
    bin_size_ms: float,
    x_init=None,
    weights=None,
    gtol: float = 1e-8,
    maxiter: int = 100,
    compute_cov: bool = True,
    eps_noise: float = 0.001,
    reduce: Reduce = None,
):
    """Batched Laplace inference over all trials.

    Args:
        C, d, tau: model parameters (tensors on one device, f64 or f32).
        Y: spike counts ``(R, ydim, T)``.
        x_init: warm-start modes ``(R, xdim, T)`` (zeros if None).
        weights: optional per-neuron weights ``(ydim,)``, or ``(R, ydim)``
            one row per trial (1 = keep).
        compute_cov: keep the full ``(R, xdim*T, xdim*T)`` posterior covariance.
        reduce: sums over ranks (:mod:`pgpfa_torch.utils.reduce`); then
            ``post_loglik`` is the mean over the trials of all ranks.

    Returns:
        ``(InfRes, post_loglik)`` with ``post_loglik = -mean(trial objectives)``.
    """
    R, ydim, _ = Y.shape
    xdim = C.shape[1]
    K = rbf_kernel(tau, T, bin_size_ms, eps_noise)
    Kinv = blocks_inv(K)

    if x_init is None:
        x_init = torch.zeros((R, xdim, T), dtype=C.dtype, device=C.device)
    if weights is None:
        weights = torch.ones((ydim,), dtype=C.dtype, device=C.device)

    X, obj, iters, W_final, L32_final = _newton_solve(
        Y, x_init, C, d, Kinv, weights, gtol, maxiter)

    # Posterior covariance from the final (W, L32): cho_solve plus ONE f64
    # refinement step with a structured residual lands at ~(kappa(H) eps32)^2,
    # e.g. 1.7e-7 max abs error against the exact f64 inverse at kappa(H) ~ 1e4
    # (the problem of tests/test_torch_laplace.py), not ~1e-10.
    cov = inv_psd_structured(W_final, Kinv, ns_steps=1, f64_steps=1, L32=L32_final)
    vsm, vsm_gp = cov_views(cov, xdim, T)

    res = InfRes(
        post_mean=X,
        post_vsm=vsm,
        post_vsm_gp=vsm_gp,
        post_cov=cov if compute_cov else None,
        trial_obj=obj,
        newton_iters=iters,
    )
    return res, -(obj.mean() if reduce is None else trial_mean(obj, reduce))


def laplace_estep(params: Params, Y, T: int, bin_size_ms: float, **kw):
    """:func:`laplace_estep_from_arrays` taking a :class:`Params`."""
    return laplace_estep_from_arrays(params.C, params.d, params.tau, Y, T, bin_size_ms, **kw)
