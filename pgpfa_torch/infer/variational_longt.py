"""Dual variational E-step for long trials on block-tridiagonal (banded)
algebra (PyTorch port of ``pgpfa/infer/variational_longt.py``).

Both prior-side quantities of the dual cost are banded: the prior's
quadratic and mean terms ``u^T K u`` and ``-K C_big (lam - y)`` are
block-tridiagonal products, and the posterior precision
``K^{-1} + C_big diag(lam) C_big^T`` has the structure of the banded Laplace
Hessian, so with the prior's UDL factorization it factors as
``A^{-T} M A^{-1}`` and the dual's logdet is ``logdet M``, one
:func:`~pgpfa_torch.ops.blocktridiag.btd_factor` sweep, differentiable by
autograd through the block inverse's exact rules. The posterior views are
those of the banded Laplace path.

The reference's relative diagonal ridge is kept by folding
``ridge * diag(prec)`` into the per-bin curvature, ``diag(prec) =
diag(K^{-1}) + diag(W)``, with ``diag(K^{-1})`` from the prior's selected
inverse once per E-step.

The dual is minimized by the fixed-iteration batched L-BFGS of
:mod:`pgpfa_torch.utils.optim` in chunks of 25 iterations, one host readback
per chunk, over all trials at once.
"""

from __future__ import annotations

import torch

from pgpfa_torch.infer.laplace_longt import (
    BandedInfRes,
    _build_M,
    _to_blocks,
    banded_posterior_views,
    banded_prior,
)
from pgpfa_torch.models.poisson_gpfa import hessian_weights, linear_predictor
from pgpfa_torch.ops.blocktridiag import btd_factor, btd_selected_inverse, btd_solve
from pgpfa_torch.utils.optim import lbfgs_chunked_driver, lbfgs_fixed_init, lbfgs_fixed_steps
from pgpfa_torch.utils.reduce import Reduce, trial_mean

# Iterations per chunk of the chunked driver (one host readback each).
LBFGS_CHUNK = 25


def banded_dual_machinery(C, d, tau, T: int, bin_size_ms: float, block_size: int,
                          eps_noise: float = 0.001, ridge: float = 1e-6):
    """The banded dual-VI pieces shared by all trials.

    Returns ``(dual_cost_banded, kmul, build_M, facK, Gc)``:
    ``dual_cost_banded(rho, Y)`` the dual cost per trial for ``rho, Y
    (..., ydim, T)``; ``kmul(u)`` the banded prior product ``K u`` for ``u
    (..., xdim, T)``; ``build_M(lam)`` the blocks of ``M = S_K^{-1} + A^T W~
    A``; the prior's factorization ``facK`` (leading trial axis of 1) and its
    combined gains ``Gc``.
    """
    xdim = C.shape[1]
    s = block_size
    nb = T // s
    Kd, Kb, facK, Gc = banded_prior(tau, T, bin_size_ms, s, eps_noise, xdim)
    # diag(K^{-1}) per (bin, latent): the selected inverse's diagonal blocks
    dKinv = btd_selected_inverse(facK).diag[0].diagonal(dim1=-2, dim2=-1).reshape(T, xdim)

    def kmul(u):
        ub = u.reshape(*u.shape[:-2], xdim, nb, s)
        out = torch.einsum("kntu,...knu->...knt", Kd, ub)
        below = torch.einsum("kntu,...knu->...knt", Kb, ub[..., :-1, :])
        above = torch.einsum("knut,...knu->...knt", Kb, ub[..., 1:, :])
        out = out + torch.cat([torch.zeros_like(out[..., :1, :]), below], -2)
        out = out + torch.cat([above, torch.zeros_like(out[..., :1, :])], -2)
        return out.reshape(u.shape)

    def build_M(lam):
        """``M`` with the relative ridge folded into the per-bin curvature:
        ``W~ = W + ridge diag(diag(K^{-1}) + diag(W))``."""
        Wbin = hessian_weights(C, lam)
        dW = Wbin.diagonal(dim1=-2, dim2=-1)
        Wbin = Wbin + torch.diag_embed(ridge * (dW + dKinv))
        return _build_M(Wbin, facK, Gc, nb, s)

    def dual_cost_banded(rho, Y):
        lam = torch.exp(rho)
        lmy = lam - Y
        u = C.T @ lmy
        a = 0.5 * (u * kmul(u)).sum((-2, -1))
        b = -(d * lmy.sum(-1)).sum(-1)
        c = -0.5 * btd_factor(*build_M(lam)).logdet  # logdet prec = logdet M
        e = (lam * (rho - 1.0)).sum((-2, -1))
        return a + b + c + e

    return dual_cost_banded, kmul, build_M, facK, Gc


def vi_estep_banded(
    C,
    d,
    tau,
    Y,
    T: int,
    bin_size_ms: float,
    block_size: int,
    rho_init=None,
    gtol: float = 1e-8,
    maxiter: int = 150,
    eps_noise: float = 0.001,
    ridge: float = 1e-6,
    reduce: Reduce = None,
):
    """Batched banded-prior dual variational inference (the long-trial path),
    the counterpart of
    :func:`pgpfa_torch.infer.variational.vi_estep_from_arrays` with the
    L-BFGS solver. ``block_size`` must divide ``T`` and satisfy
    ``block_size * bin_size_ms >~ 6000 max(tau)``. With ``reduce`` (sums
    over ranks) both means run over the trials of all ranks.

    Returns:
        ``(BandedInfRes, post_loglik, var_lower_bound, rho)``: ``post_loglik``
        is minus the mean banded Laplace objective at the posterior means,
        ``var_lower_bound`` the mean converged dual cost.
    """
    R, ydim, _ = Y.shape
    xdim = C.shape[1]
    s = block_size
    nb = T // s
    dual, kmul, build_M, facK, Gc = banded_dual_machinery(
        C, d, tau, T, bin_size_ms, block_size, eps_noise, ridge)
    if rho_init is None:
        rho_init = torch.zeros((R, ydim, T), dtype=C.dtype, device=C.device)

    def fun(r):
        return dual(r, Y)

    shape = rho_init.shape[1:]
    slack_coef = 1e-13 if C.dtype == torch.float64 else 1e-6
    carry = lbfgs_chunked_driver(lambda n: lambda c: lbfgs_fixed_steps(fun, c, n, shape),
                                 lbfgs_fixed_init(fun, rho_init), maxiter,
                                 chunk=LBFGS_CHUNK, slack_coef=slack_coef, gtol=gtol)
    rho, bound = carry[0].reshape(rho_init.shape), carry[1]
    gnorm = carry[2].abs().amax(-1)

    lam = torch.exp(rho)
    means = -kmul(C.T @ (lam - Y))
    vsm, gp_diag, gp_off = banded_posterior_views(btd_factor(*build_M(lam)), Gc, nb, s, xdim)
    # the Laplace objective at the VI mean, its prior term banded
    act = linear_predictor(C, d, means)
    xb = _to_blocks(means, nb, s)
    obj = (torch.exp(act).sum((-2, -1)) - (Y * act).sum((-2, -1))
           + 0.5 * (xb * btd_solve(facK, xb)).sum((-2, -1)))
    res = BandedInfRes(post_mean=means, post_vsm=vsm, vsm_gp_diag=gp_diag, vsm_gp_off=gp_off,
                       trial_obj=obj, grad_norm=gnorm)
    if reduce is None:
        return res, -obj.mean(), bound.mean(), rho
    means = trial_mean(torch.stack([obj, bound], 1), reduce)
    return res, -means[0], means[1], rho
