"""Laplace E-step for long trials on block-tridiagonal (banded) algebra
(PyTorch port of ``pgpfa/infer/laplace_longt.py``).

The dense E-step factors an ``(xdim*T)^2`` Hessian per trial. Here the time
axis is cut into ``nb = T / s`` blocks and, with the banded prior's UDL
factorization ``K = A S_K A^T`` (``A`` unit block-bidiagonal), the
posterior precision factors exactly as::

    H = K^{-1} + W = A^{-T} M A^{-1},   M = S_K^{-1} + A^T W A

with ``M`` block-tridiagonal. The Newton solves, ``logdet H = logdet M``
and the posterior moments (``H^{-1} = A M^{-1} A^T`` by the Takahashi
selected inverse) then cost O(T s^2) time and O(T s) memory. The only
approximation is the banding of the prior
(:func:`pgpfa_torch.ops.blocktridiag.btd_truncation_error`).

Within a block the layout is time-major, ``(t, k) -> t*xdim + k``, so the
observation curvature stays block-diagonal there. All trials run as one
batch: every block step of every factorization is one batched
``chol32`` and two ``ns_step`` launches at ``(R, s*xdim, s*xdim)``. The
Newton loop runs a fixed number of bodies with no host readback, as the JAX
package's ``lax.scan``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pgpfa_torch.convert import to_numpy
from pgpfa_torch.models.poisson_gpfa import hessian_weights, linear_predictor
from pgpfa_torch.ops.blocktridiag import (
    BTDFactor,
    btd_factor,
    btd_rbf_kernel,
    btd_selected_inverse,
    btd_solve,
)


class BandedInfRes(NamedTuple):
    """Posterior inference results with banded temporal covariances.

    ``post_vsm`` has the dense path's layout; each latent's temporal
    covariance is kept as its diagonal and first off-diagonal blocks.
    """

    post_mean: torch.Tensor  # (R, xdim, T)
    post_vsm: torch.Tensor  # (R, T, xdim, xdim)
    vsm_gp_diag: torch.Tensor  # (R, xdim, nb, s, s)
    vsm_gp_off: torch.Tensor  # (R, xdim, nb-1, s, s), block (i+1, i)
    trial_obj: torch.Tensor  # (R,)
    grad_norm: torch.Tensor  # (R,) objective-gradient inf-norm at the mode

    @property
    def newton_iters(self) -> torch.Tensor:
        """``(R,)`` zeros: the banded E-steps run a fixed budget and record
        no Newton counts."""
        return torch.zeros(self.post_mean.shape[0], dtype=torch.int32,
                           device=self.post_mean.device)

    def vsm_gp_dense(self) -> torch.Tensor:
        """The banded temporal covariance as ``(R, xdim, T, T)``, zero past
        the first off-diagonal blocks."""
        return _banded_dense(self.vsm_gp_diag, self.vsm_gp_off)

    def to_reference_dict(self) -> dict:
        """The reference's ``infRes`` layout (as
        :meth:`pgpfa_torch.infer.laplace.InfRes.to_reference_dict`), the
        temporal covariance from :meth:`vsm_gp_dense`."""
        return {
            "post_mean": list(to_numpy(self.post_mean)),
            "post_vsm": list(to_numpy(self.post_vsm)),
            "post_vsmGP": [v.transpose(1, 2, 0) for v in to_numpy(self.vsm_gp_dense())],
            "post_cov": None,
        }


def _banded_dense(diag: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Dense symmetric ``(..., T, T)`` from diagonal blocks ``(..., nb, s,
    s)`` and subdiagonal blocks ``(..., nb-1, s, s)``, zero elsewhere."""
    nb, s = diag.shape[-3], diag.shape[-1]
    lead = diag.shape[:-3]
    out = diag.new_zeros(*lead, nb, s, nb, s)
    i = torch.arange(nb, device=diag.device)
    # advanced indices on axes -4 and -2 put the block axis first
    out[..., i, :, i, :] = diag.movedim(-3, 0)
    if nb > 1:
        o = off.movedim(-3, 0)
        out[..., i[1:], :, i[:-1], :] = o
        out[..., i[:-1], :, i[1:], :] = o.transpose(-1, -2)
    return out.reshape(*lead, nb * s, nb * s)


def require_f64(dtype):
    """The banded path runs in f64 only."""
    if dtype != torch.float64:
        raise NotImplementedError(
            f"the banded long-trial path (time_block) runs in float64 only, not {dtype}; "
            "its f32 fast mode is not ported (ROADMAP.md, queue 1)")


def _to_blocks(X: torch.Tensor, nb: int, s: int) -> torch.Tensor:
    """``(..., xdim, T)`` -> ``(..., nb, s*xdim)``, time-major in a block."""
    xdim = X.shape[-2]
    return X.reshape(*X.shape[:-2], xdim, nb, s).movedim(-3, -1).reshape(
        *X.shape[:-2], nb, s * xdim)


def _from_blocks(Xb: torch.Tensor, xdim: int) -> torch.Tensor:
    """``(..., nb, s*xdim)`` -> ``(..., xdim, T)``."""
    nb, m = Xb.shape[-2], Xb.shape[-1]
    return Xb.reshape(*Xb.shape[:-2], nb, m // xdim, xdim).movedim(-1, -3).reshape(
        *Xb.shape[:-2], xdim, nb * (m // xdim))


def _latent_blocks_to_combined(Bk: torch.Tensor, xdim: int) -> torch.Tensor:
    """Per-latent blocks ``(xdim, n, s, s)`` -> combined blocks
    ``(n, s*xdim, s*xdim)`` that couple like latents only."""
    n, s = Bk.shape[1], Bk.shape[2]
    eye = torch.eye(xdim, dtype=Bk.dtype, device=Bk.device)
    return torch.einsum("kntu,kl->ntkul", Bk, eye).reshape(n, s * xdim, s * xdim)


def _w_to_combined(Wbin: torch.Tensor, nb: int, s: int) -> torch.Tensor:
    """Per-bin curvature ``(..., T, xdim, xdim)`` -> combined blocks
    ``(..., nb, s*xdim, s*xdim)``, block-diagonal over the bins of a block."""
    xdim = Wbin.shape[-1]
    Wr = Wbin.reshape(*Wbin.shape[:-3], nb, s, xdim, xdim)
    eye = torch.eye(s, dtype=Wbin.dtype, device=Wbin.device)
    return torch.einsum("...nskl,st->...nsktl", Wr, eye).reshape(
        *Wbin.shape[:-3], nb, s * xdim, s * xdim)


def _apply_A(Gc: torch.Tensor, zb: torch.Tensor) -> torch.Tensor:
    """``y = A z``, ``A = I +`` block subdiagonal ``Gc``:
    ``y_i = z_i + Gc_i z_{i-1}``."""
    tail = (Gc @ zb[..., :-1, :, None])[..., 0]
    return torch.cat([zb[..., :1, :], zb[..., 1:, :] + tail], -2)


def _apply_At(Gc: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    """``x = A^T y``: ``x_i = y_i + Gc_{i+1}^T y_{i+1}``."""
    head = (Gc.transpose(-1, -2) @ yb[..., 1:, :, None])[..., 0]
    return torch.cat([yb[..., :-1, :] + head, yb[..., -1:, :]], -2)


def banded_prior(tau, T: int, bin_size_ms: float, block_size: int, eps_noise: float, xdim: int):
    """The banded prior factored once per E-step, per latent (one batched
    factorization over the latents). Returns ``(Kd, Kb, facK, Gc)``: the
    prior's blocks ``(xdim, nb[-1], s, s)``, its factorization in the
    combined layout with a leading trial axis of 1 (shared by all trials),
    and its combined gains ``(nb-1, m, m)``."""
    Kd, Kb = btd_rbf_kernel(tau, T, bin_size_ms, block_size, eps_noise)
    facs = btd_factor(Kd, Kb)
    Pc = _latent_blocks_to_combined(facs.P, xdim)
    Gc = _latent_blocks_to_combined(facs.G, xdim)
    facK = BTDFactor(P=Pc[None], G=Gc[None], logdet=facs.logdet.sum())
    return Kd, Kb, facK, Gc


def _build_M(Wbin, facK: BTDFactor, Gc, nb: int, s: int):
    """``M = S_K^{-1} + A^T W A`` for per-bin curvature ``Wbin
    (..., T, xdim, xdim)``: its diagonal blocks and its subdiagonal blocks
    ``W_{i+1} Gc_{i+1}``."""
    Wc = _w_to_combined(Wbin, nb, s)
    WG = Wc[..., 1:, :, :] @ Gc
    Md = facK.P[0] + Wc
    upper = Gc.transpose(-1, -2) @ WG
    Md = torch.cat([Md[..., :-1, :, :] + upper, Md[..., -1:, :, :]], -3)
    return Md, WG


def banded_posterior_views(facM: BTDFactor, Gc: torch.Tensor, nb: int, s: int, xdim: int):
    """Posterior second-moment views from the factored precision.

    With ``H = A^{-T} M A^{-1}``, ``H^{-1} = A Sig^M A^T``, whose in-band
    blocks follow from the selected inverse of ``M``. Shared by the banded
    Laplace and variational E-steps, whose precisions have the same
    structure. Returns ``(vsm (..., T, xdim, xdim), gp_diag (..., xdim, nb,
    s, s), gp_off (..., xdim, nb-1, s, s))``.
    """
    sel = btd_selected_inverse(facM)
    SD, S1, S2 = sel.diag, sel.off1, sel.off2
    GcT = Gc.transpose(-1, -2)

    # (H^{-1})_{ii} = SD_i + S1_{i-1} Gc_i^T + Gc_i S1_{i-1}^T + Gc_i SD_{i-1} Gc_i^T
    t1 = S1 @ GcT
    t3 = Gc @ SD[..., :-1, :, :] @ GcT
    Hd = torch.cat([SD[..., :1, :, :], SD[..., 1:, :, :] + (t1 + t1.transpose(-1, -2) + t3)], -3)

    # (H^{-1})_{i+1,i} = Gc_{i+1}(SD_i + S1_{i-1} Gc_i^T) + S2_{i-1} Gc_i^T + S1_i
    inner = SD[..., :-1, :, :]
    if nb > 2:
        inner = torch.cat([inner[..., :1, :, :], inner[..., 1:, :, :] + t1[..., :-1, :, :]], -3)
        Ho = Gc @ inner + S1
        Ho = torch.cat([Ho[..., :1, :, :], Ho[..., 1:, :, :] + S2 @ GcT[..., :-1, :, :]], -3)
    else:
        Ho = Gc @ inner + S1

    lead = Hd.shape[:-3]
    Hd6 = Hd.reshape(*lead, nb, s, xdim, s, xdim)
    vsm = torch.einsum("...ntktl->...ntkl", Hd6).reshape(*lead, nb * s, xdim, xdim)
    gp_diag = torch.einsum("...ntkuk->...kntu", Hd6)
    gp_off = torch.einsum("...ntkuk->...kntu", Ho.reshape(*lead, nb - 1, s, xdim, s, xdim))
    return vsm, gp_diag, gp_off


def laplace_estep_banded(
    C,
    d,
    tau,
    Y,
    T: int,
    bin_size_ms: float,
    block_size: int,
    x_init=None,
    weights=None,
    maxiter: int = 12,
    eps_noise: float = 0.001,
):
    """Batched banded-prior Laplace inference (the long-trial path), the
    counterpart of :func:`pgpfa_torch.infer.laplace.laplace_estep_from_arrays`.

    ``block_size`` must divide ``T`` and satisfy ``block_size * bin_size_ms
    >~ 6000 max(tau)`` for the banding to drop less than ~1e-8. Each of the
    ``maxiter`` Newton bodies tries the full step and a quarter step, sets a
    non-finite candidate's objective to +inf and keeps the best point so far
    per trial; there is no early exit. ``weights`` are optional per-neuron
    likelihood weights ``(ydim,)``.

    Returns:
        ``(BandedInfRes, post_loglik)``, ``post_loglik = -mean(objectives)``.
    """
    require_f64(C.dtype)
    R, ydim, _ = Y.shape
    xdim = C.shape[1]
    s = block_size
    nb = T // s
    if x_init is None:
        x_init = torch.zeros((R, xdim, T), dtype=C.dtype, device=C.device)
    if weights is None:
        weights = torch.ones((ydim,), dtype=C.dtype, device=C.device)
    w = weights[:, None]
    wY = w * Y

    _, _, facK, Gc = banded_prior(tau, T, bin_size_ms, s, eps_noise, xdim)

    def obj_grad(Xb):
        act = linear_predictor(C, d, _from_blocks(Xb, xdim))
        expA = torch.exp(act)
        Kinvx = btd_solve(facK, Xb)
        obj = (w * expA).sum((-2, -1)) - (wY * act).sum((-2, -1)) + 0.5 * (Xb * Kinvx).sum((-2, -1))
        Gb = _to_blocks(C.T @ (w * (expA - Y)), nb, s) + Kinvx
        return obj, Gb, expA

    def factor_M(expA):
        return btd_factor(*_build_M(hessian_weights(C, w * expA), facK, Gc, nb, s))

    Xb = _to_blocks(x_init, nb, s)
    f = obj_grad(Xb)[0]
    inf_f = torch.full_like(f, torch.inf)
    for _ in range(maxiter):
        _, Gb, expA = obj_grad(Xb)
        # the Newton step H^{-1} g = A M^{-1} A^T g
        step = _apply_A(Gc, btd_solve(factor_M(expA), _apply_At(Gc, Gb)))
        cand1, cand2 = Xb - step, Xb - 0.25 * step
        f1, f2 = obj_grad(cand1)[0], obj_grad(cand2)[0]
        f1 = torch.where(torch.isfinite(f1), f1, inf_f)
        f2 = torch.where(torch.isfinite(f2), f2, inf_f)
        use2 = f2 < f1
        f_new = torch.minimum(f1, f2)
        X_new = torch.where(use2[:, None, None], cand2, cand1)
        better = f_new < f
        Xb = torch.where(better[:, None, None], X_new, Xb)
        f = torch.where(better, f_new, f)

    # posterior moments at the mode: H^{-1} = A Sig^M A^T
    _, Gb, expA = obj_grad(Xb)
    vsm, gp_diag, gp_off = banded_posterior_views(factor_M(expA), Gc, nb, s, xdim)
    res = BandedInfRes(post_mean=_from_blocks(Xb, xdim), post_vsm=vsm, vsm_gp_diag=gp_diag,
                       vsm_gp_off=gp_off, trial_obj=f, grad_norm=Gb.abs().amax((-2, -1)))
    return res, -f.mean()


def pauto_sum_banded(inf: BandedInfRes) -> torch.Tensor:
    """The tau M-step's ``PautoSum`` ``(xdim, T, T)`` from banded moments:
    ``sum_r m m^T`` exactly, the covariance part from the banded blocks (its
    dropped tail is bounded by the prior's banding)."""
    out = torch.einsum("rkt,rku->ktu", inf.post_mean, inf.post_mean)
    return out + _banded_dense(inf.vsm_gp_diag.sum(0), inf.vsm_gp_off.sum(0))
