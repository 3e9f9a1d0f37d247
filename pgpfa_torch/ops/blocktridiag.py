"""Block-tridiagonal SPD algebra, the long-trial path (PyTorch port of
``pgpfa/ops/blocktridiag.py``).

The time axis is cut into ``nb = T / s`` blocks of ``s`` bins. The RBF prior
decays as ``exp(-lag^2 / 2 tau^2)``, so with ``s * bin >~ 6 tau`` it is
block-tridiagonal to ~1e-8 and every E-step quantity follows from
block-tridiagonal algebra in O(T s^2) time and O(T s) memory.

The factorization is the Schur-complement UDL recursion
``A = (I + E G) S (I + E G)^T``. The JAX package runs it as a ``lax.scan``
over the blocks and ``vmap``-s it over trials, latents or tau lanes; here
the functions take those as leading batch axes and the scan is a Python
loop whose every step is ONE batched
:func:`~pgpfa_torch.ops.blockmat.inv_logdet_psd_mixed_d` over all of them:
one ``chol32`` and two ``ns_step`` launches per block step, whatever the
batch. Everything is out of place and differentiable by autograd, the block
inverse by its exact rules, so the banded tau M-step and the banded dual
cost take gradients straight through :func:`btd_factor`, :func:`btd_solve`
and :func:`btd_selected_inverse`.

Shapes: a block-tridiagonal matrix is given by its diagonal blocks
``D (..., nb, m, m)`` and subdiagonal blocks ``B (..., nb-1, m, m)``,
``B[i] = A[i+1, i]``; a right-hand side by ``(..., nb, m)`` (vectors, one
axis fewer than the factor's ``P``) or ``(..., nb, m, k)``. Leading axes
broadcast, so a factor shared by all trials carries a leading axis of 1.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pgpfa_torch.ops.blockmat import inv_logdet_psd_mixed_d, inv_psd_mixed


class BTDFactor(NamedTuple):
    """UDL factorization ``A = (I + E G) S (I + E G)^T`` of an SPD
    block-tridiagonal matrix, ``S = blockdiag(S_0 .. S_{nb-1})``.

    Attributes:
        P: ``(..., nb, m, m)``, the Schur-complement inverses ``S_i^{-1}``.
        G: ``(..., nb-1, m, m)``, the gains ``G_{i+1} = B_{i+1} P_i``.
        logdet: ``(...)``, ``logdet A = sum_i logdet S_i``.
    """

    P: torch.Tensor
    G: torch.Tensor
    logdet: torch.Tensor


def _stack(blocks, like: torch.Tensor) -> torch.Tensor:
    """Blocks ``(..., m, m)`` stacked on axis -3; an empty list gives zero
    blocks shaped as ``like``'s."""
    if blocks:
        return torch.stack(blocks, -3)
    return like.new_zeros(*like.shape[:-3], 0, *like.shape[-2:])


def _inv_logdet(S: torch.Tensor):
    """:func:`inv_logdet_psd_mixed_d` over all leading axes as one batch."""
    m = S.shape[-1]
    X, ld = inv_logdet_psd_mixed_d(S.reshape(-1, m, m))
    return X.reshape(S.shape), ld.reshape(S.shape[:-2])


def _inv(S: torch.Tensor) -> torch.Tensor:
    """:func:`inv_psd_mixed` over all leading axes as one batch."""
    m = S.shape[-1]
    return inv_psd_mixed(S.reshape(-1, m, m)).reshape(S.shape)


def btd_factor(D: torch.Tensor, B: torch.Tensor) -> BTDFactor:
    """Factor SPD block-tridiagonal matrices from their diagonal blocks
    ``D (..., nb, m, m)`` and subdiagonal blocks ``B (..., nb-1, m, m)``."""
    P_i, ld0 = _inv_logdet(D[..., 0, :, :])
    Ps, Gs, lds = [P_i], [], []
    for i in range(1, D.shape[-3]):
        B_i = B[..., i - 1, :, :]
        G_i = B_i @ P_i
        S_i = D[..., i, :, :] - G_i @ B_i.transpose(-1, -2)
        P_i, ld_i = _inv_logdet(0.5 * (S_i + S_i.transpose(-1, -2)))
        Ps.append(P_i)
        Gs.append(G_i)
        lds.append(ld_i)
    logdet = ld0 + torch.stack(lds).sum(0) if lds else ld0
    P = _stack(Ps, D)
    return BTDFactor(P=P, G=_stack(Gs, P[..., 1:, :, :]), logdet=logdet)


def btd_solve(fac: BTDFactor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = rhs`` for ``rhs (..., nb, m)`` or ``(..., nb, m, k)``:
    the forward sweep through ``I + E G``, the block inverses ``P``, the
    backward sweep through its transpose."""
    vec = rhs.dim() == fac.P.dim() - 1
    r = rhs[..., None] if vec else rhs
    nb = r.shape[-3]
    z = [r[..., 0, :, :]]
    for i in range(1, nb):
        z.append(r[..., i, :, :] - fac.G[..., i - 1, :, :] @ z[-1])
    w = [fac.P[..., i, :, :] @ z[i] for i in range(nb)]
    x = [w[-1]]
    for i in range(nb - 2, -1, -1):
        x.append(w[i] - fac.G[..., i, :, :].transpose(-1, -2) @ x[-1])
    out = torch.stack(x[::-1], -3)
    return out[..., 0] if vec else out


class BTDSelectedInverse(NamedTuple):
    """Selected blocks of ``A^{-1}`` from the Takahashi recursion.

    Attributes:
        diag: ``(..., nb, m, m)``, ``(A^{-1})[i, i]``.
        off1: ``(..., nb-1, m, m)``, ``(A^{-1})[i+1, i]``.
        off2: ``(..., nb-2, m, m)``, ``(A^{-1})[i+2, i]`` (for the
            first-off-diagonal blocks of congruences ``U A^{-1} U^T`` with
            block-bidiagonal ``U``).
    """

    diag: torch.Tensor
    off1: torch.Tensor
    off2: torch.Tensor


def btd_selected_inverse(fac: BTDFactor) -> BTDSelectedInverse:
    """Diagonal and first and second off-diagonal blocks of ``A^{-1}``.

    With ``Sig = A^{-1}``, ``Sig_{nn} = P_n`` and for ``i = nb-2 .. 0``::

        Sig_{i+1,i} = -Sig_{i+1,i+1} G_{i+1}
        Sig_{i,i}   =  P_i + G_{i+1}^T Sig_{i+1,i+1} G_{i+1}
        Sig_{i+2,i} = -Sig_{i+2,i+1} G_{i+1}
    """
    P = fac.P
    nb = P.shape[-3]
    sig_next = P[..., nb - 1, :, :]
    diag, off1, off2 = [sig_next], [], []
    for i in range(nb - 2, -1, -1):
        G_ip1 = fac.G[..., i, :, :]
        t = sig_next @ G_ip1
        if off1:  # Sig_{i+2,i+1} exists
            off2.append(-(off1[-1] @ G_ip1))
        off1.append(-t)
        d_i = P[..., i, :, :] + G_ip1.transpose(-1, -2) @ t
        sig_next = 0.5 * (d_i + d_i.transpose(-1, -2))
        diag.append(sig_next)
    return BTDSelectedInverse(diag=_stack(diag[::-1], P), off1=_stack(off1[::-1], P[..., 1:, :, :]),
                              off2=_stack(off2[::-1], P[..., 2:, :, :]))


# --------------------------------------------------------------------------
# block cyclic reduction: the solve of O(log nb) sequential depth
# --------------------------------------------------------------------------


def _bcr_pad(D, B, rhs):
    """Pad the block count of ``D``, ``B`` and ``rhs (..., nb, m, k)`` to a
    power of two with decoupled identity blocks; returns them and the
    original count."""
    nb, m = D.shape[-3], D.shape[-1]
    n2 = 1 << (nb - 1).bit_length() if nb > 1 else 1
    if n2 == nb:
        return D, B, rhs, nb
    pad = n2 - nb
    eye = torch.eye(m, dtype=D.dtype, device=D.device).expand(*D.shape[:-3], pad, m, m)
    D = torch.cat([D, eye], -3)
    B = torch.cat([B, B.new_zeros(*B.shape[:-3], n2 - 1 - B.shape[-3], m, m)], -3)
    rhs = torch.cat([rhs, rhs.new_zeros(*rhs.shape[:-3], pad, *rhs.shape[-2:])], -3)
    return D, B, rhs, nb


def _shift_down(x: torch.Tensor) -> torch.Tensor:
    """Blocks ``x[..., :-1]`` moved one block down, zero first block."""
    return torch.cat([torch.zeros_like(x[..., :1, :, :]), x[..., :-1, :, :]], -3)


def btd_solve_cr(D: torch.Tensor, B: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve the SPD block-tridiagonal system by block cyclic reduction.

    The answer of ``btd_solve(btd_factor(D, B), rhs)`` with O(log nb)
    sequential depth instead of O(nb): each level eliminates the odd blocks
    with batched ``m x m`` inverses and products, halving the system. Every
    reduced system stays SPD (its diagonal blocks are Schur complements of
    principal submatrices), so the mixed-precision inverse stays well-posed.
    Block counts that are not powers of two are padded with decoupled
    identity blocks.

    Args:
        D: diagonal blocks ``(..., nb, m, m)``.
        B: subdiagonal blocks ``(..., nb-1, m, m)``, ``B[i] = A[i+1, i]``.
        rhs: ``(..., nb, m)`` or ``(..., nb, m, k)``.
    """
    vec = rhs.dim() == D.dim() - 1
    if vec:
        rhs = rhs[..., None]
    D, B, rhs, nb_orig = _bcr_pad(D, B, rhs)
    m = D.shape[-1]
    tr = lambda a: a.transpose(-1, -2)  # noqa: E731

    levels = []
    while D.shape[-3] > 1:
        n = D.shape[-3]
        De, Do = D[..., 0::2, :, :], D[..., 1::2, :, :]
        re, ro = rhs[..., 0::2, :, :], rhs[..., 1::2, :, :]
        # odd block 2t+1 couples to 2t through B[2t] and to 2t+2 through
        # B[2t+1], which the last odd block lacks
        Lo_left = B[..., 0::2, :, :]
        Lo_right = torch.cat([B[..., 1::2, :, :], B.new_zeros(*B.shape[:-3], 1, m, m)], -3)
        Do_inv = _inv(Do)
        levels.append((Lo_left, Lo_right, Do_inv, ro))
        # even row 2t loses its right odd neighbour 2t+1 ...
        KR = tr(Lo_left) @ Do_inv
        # ... and its left one, 2t-1, whose coupling is B[2t-1]
        KL = Lo_right @ Do_inv
        D = De - KR @ Lo_left - _shift_down(KL @ tr(Lo_right))
        rhs = re - KR @ ro - _shift_down(KL @ ro)
        # new subdiagonal: x_{2t+2} couples to x_{2t} through 2t+1
        B = -(KL @ Lo_left)[..., :-1, :, :] if n > 2 else B[..., :0, :, :]

    x = _inv(D) @ rhs
    for Lo_left, Lo_right, Do_inv, ro in reversed(levels):
        # x_odd[t] = Dinv (r_odd[t] - B[2t] x_{2t} - B[2t+1]^T x_{2t+2})
        nxt = torch.cat([x[..., 1:, :, :], torch.zeros_like(x[..., :1, :, :])], -3)
        x_odd = Do_inv @ (ro - Lo_left @ x - tr(Lo_right) @ nxt)
        x = torch.stack([x, x_odd], -3).reshape(*x.shape[:-3], 2 * x.shape[-3], *x.shape[-2:])
    x = x[..., :nb_orig, :, :]
    return x[..., 0] if vec else x


# --------------------------------------------------------------------------
# the banded RBF prior
# --------------------------------------------------------------------------


def btd_rbf_kernel(tau: torch.Tensor, T: int, bin_size_ms: float, block_size: int,
                   eps_noise: float = 0.001):
    """Per-latent RBF prior in block-tridiagonal form: the entries of
    :func:`pgpfa_torch.models.params.rbf_kernel` up to the first
    off-diagonal block, exact where correlations vanish past one block
    (``block_size * bin_size_ms >~ 6000 tau``; :func:`btd_truncation_error`).

    Returns ``(Kd, Kb)``, ``(xdim, nb, s, s)`` and ``(xdim, nb-1, s, s)``
    (each block repeated along ``nb`` as an expanded view).
    """
    if T % block_size != 0:
        raise ValueError(f"T={T} must be divisible by block_size={block_size}")
    tau = tau.reshape(-1)
    s, nb = block_size, T // block_size
    t = torch.arange(s, dtype=tau.dtype, device=tau.device) * float(bin_size_ms)
    tau_ms = tau * 1000.0

    def block(lag):
        # K[t, u] for t in block i + lag and u in block i
        dt = (t[:, None] + lag * s * float(bin_size_ms)) - t[None, :]
        base = (1.0 - eps_noise) * torch.exp(-0.5 * (dt * dt)[None] / (tau_ms**2)[:, None, None])
        if lag == 0:
            base = base + eps_noise * torch.eye(s, dtype=tau.dtype, device=tau.device)[None]
        return base

    xdim = tau.shape[0]
    return (block(0)[:, None].expand(xdim, nb, s, s),
            block(1)[:, None].expand(xdim, max(nb - 1, 0), s, s))


def btd_truncation_error(tau, bin_size_ms: float, block_size: int) -> float:
    """The largest prior correlation the banding drops (entries more than
    one block off the diagonal)."""
    tau_ms = np.asarray(tau, dtype=np.float64).reshape(-1) * 1000.0
    lag_ms = (block_size + 1) * bin_size_ms
    return float(np.max(np.exp(-0.5 * (lag_ms / tau_ms) ** 2)))
