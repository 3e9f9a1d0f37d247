"""Structured (latent x time) block-matrix operators and the mixed-precision
SPD solvers (PyTorch port of ``pgpfa/ops/blockmat.py``).

Matrices over the flattened latent space ``R^{xdim*T}`` (latent-major) have
the form

    M[k*T + t, l*T + u] = delta_{tu} W[t, k, l] + delta_{kl} B[k, t, u]

(the Laplace Hessian: observation curvature diagonal in time plus the GP
prior block-diagonal in latents). Every function takes leading batch axes
where JAX ``vmap``-ed it.

Mixed precision, as in the JAX package: factor in f32 (the :func:`chol32`
kernel), then recover f64 accuracy by residual refinement: iterative
refinement for solves, Newton-Schulz steps (the :func:`ns_step` kernel for
the f32 ones) for inverses, and a residual Taylor series for log-determinants.
In the f32 fast mode (f32 inputs) solves take no refinement by default and
inverses are the symmetrized ``cholesky_solve(I)`` of the factor: refinement
in the factor's own precision cannot improve the forward error. The
triangular solves are ``torch.cholesky_solve``.
"""

from __future__ import annotations

import torch

from pgpfa_torch.ops import cuda_kernels


def _eye(D: int, like: torch.Tensor, dtype=None) -> torch.Tensor:
    return torch.eye(D, dtype=dtype or like.dtype, device=like.device)


def assemble_hessian(W: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Dense ``(..., xdim*T, xdim*T)`` matrix from ``W (..., T, xdim, xdim)``
    and ``B ([...,] xdim, T, T)``."""
    T, xdim = W.shape[-3], W.shape[-1]
    batch = torch.broadcast_shapes(W.shape[:-3], B.shape[:-3])
    H = torch.zeros(*batch, xdim, T, xdim, T, dtype=W.dtype, device=W.device)
    t = torch.arange(T, device=W.device)
    # H[..., k, t, l, t] = W[..., t, k, l]
    H[..., :, t, :, t] = W.expand(*batch, T, xdim, xdim).movedim(-3, 0)
    # H[..., k, t, k, u] += B[..., k, t, u]
    H.diagonal(dim1=-4, dim2=-2).add_(B.movedim(-3, -1))
    return H.reshape(*batch, xdim * T, xdim * T)


def structured_mm(W: torch.Tensor, B: torch.Tensor, Xm: torch.Tensor) -> torch.Tensor:
    """``H @ Xm`` from the structured parts, never forming the dense ``H``.

    ``Xm`` is ``(..., D)`` (vector) or ``(..., D, m)``; ``W``/``B`` carry the
    same leading batch axes (or none for ``B``).
    """
    xdim, T = B.shape[-3], B.shape[-2]
    vec = Xm.dim() == W.dim() - 2
    X4 = Xm.reshape(*Xm.shape[:-1], xdim, T, 1) if vec else Xm.reshape(
        *Xm.shape[:-2], xdim, T, Xm.shape[-1])
    # B part: out[k, t, m] = sum_u B[k, t, u] X[k, u, m]
    out = B @ X4
    # W part: out[k, t, m] += sum_l W[t, k, l] X[l, t, m], one (x, x) @ (x, m)
    # product per time bin
    out = out + (W @ X4.movedim(-3, -2)).movedim(-2, -3)
    return out.reshape(Xm.shape)


def _coarse_solve(L32: torch.Tensor, b: torch.Tensor, dtype, vec: bool) -> torch.Tensor:
    """``(L L^T)^{-1} b`` in f32, cast to ``dtype``."""
    b32 = b.to(torch.float32)
    if vec:
        return torch.cholesky_solve(b32[..., None], L32, upper=False)[..., 0].to(dtype)
    return torch.cholesky_solve(b32, L32, upper=False).to(dtype)


def _ir_steps(ir_steps, dtype) -> int:
    """Refinement steps: 2 in f64 and 0 in f32 by default (``None``); an
    explicit count is honored in either dtype."""
    if ir_steps is None:
        return 2 if dtype == torch.float64 else 0
    return ir_steps


def solve_psd_structured(W, B, rhs, L32, ir_steps=None) -> torch.Tensor:
    """``H^{-1} rhs`` from the f32 factor ``L32`` of ``H`` with ``ir_steps``
    refinement steps (default 2 in f64, 0 in f32) whose residuals use
    :func:`structured_mm`."""
    ir_steps = _ir_steps(ir_steps, rhs.dtype)
    vec = rhs.dim() == W.dim() - 2
    x = _coarse_solve(L32, rhs, rhs.dtype, vec)
    for _ in range(ir_steps):
        r = rhs - structured_mm(W, B, x)
        x = x + _coarse_solve(L32, r, rhs.dtype, vec)
    return x


def inv_psd_structured(W, B, ns_steps: int = 3, f64_steps: int = 1, L32=None):
    """:func:`inv_psd_mixed` from the structured parts: the dense matrix is
    assembled only in f32; every f64 residual uses :func:`structured_mm`."""
    dt = B.dtype
    D = B.shape[-3] * B.shape[-2]
    if dt != torch.float64:
        if L32 is None:
            L32 = chol32(assemble_hessian(W, B))
        return _sym(_inv32(L32).to(dt))
    f64_steps = min(f64_steps, ns_steps)
    H32 = None
    if L32 is None or ns_steps > f64_steps:
        H32 = assemble_hessian(W.to(torch.float32), B.to(torch.float32))
    if L32 is None:
        L32 = chol32(H32)
    eye32 = _eye(D, L32)
    X32 = torch.cholesky_solve(eye32.expand(L32.shape), L32, upper=False)
    for _ in range(ns_steps - f64_steps):
        X32 = cuda_kernels.ns_step(H32.contiguous(), X32.contiguous())
    X = X32.to(dt)
    eye = _eye(D, B)
    for _ in range(f64_steps):
        Rres = eye - structured_mm(W, B, X)
        X = X + (X.to(torch.float32) @ Rres.to(torch.float32)).to(dt)
    return _sym(X)


def cov_views(cov: torch.Tensor, xdim: int, T: int):
    """``(vsm (..., T, xdim, xdim), vsm_gp (..., xdim, T, T))`` views of a
    dense posterior covariance ``(..., xdim*T, xdim*T)``."""
    c4 = cov.reshape(*cov.shape[:-2], xdim, T, xdim, T)
    vsm = c4.diagonal(dim1=-3, dim2=-1).movedim(-1, -3)  # [.., t, k, l]
    vsm_gp = c4.diagonal(dim1=-4, dim2=-2).movedim(-1, -3)  # [.., k, t, u]
    return vsm.contiguous(), vsm_gp.contiguous()


def chol32(H: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of SPD matrices computed in float32 (the kernel on CUDA)."""
    return cuda_kernels.chol32(H.to(torch.float32).contiguous())


def solve_psd_mixed(H: torch.Tensor, rhs: torch.Tensor, L32=None,
                    ir_steps=None) -> torch.Tensor:
    """``H x = rhs`` by an f32 factorization and ``ir_steps`` iterative
    refinement steps (default 2 in f64, 0 in f32). ``rhs`` is ``(..., D)`` or
    ``(..., D, k)``."""
    ir_steps = _ir_steps(ir_steps, H.dtype)
    if L32 is None:
        L32 = chol32(H)
    vec = rhs.dim() == H.dim() - 1
    x = _coarse_solve(L32, rhs, H.dtype, vec)
    for _ in range(ir_steps):
        Hx = (H @ x[..., None])[..., 0] if vec else H @ x
        x = x + _coarse_solve(L32, rhs - Hx, H.dtype, vec)
    return x


def _inv32(L32: torch.Tensor) -> torch.Tensor:
    """``(L L^T)^{-1}`` in f32 from the f32 factor."""
    return torch.cholesky_solve(_eye(L32.shape[-1], L32).expand(L32.shape), L32, upper=False)


def _sym(X: torch.Tensor) -> torch.Tensor:
    return 0.5 * (X + X.transpose(-1, -2))


def inv_psd_mixed(H: torch.Tensor, L32=None, ns_steps: int = 3,
                  f64_steps: int = 1, X32=None) -> torch.Tensor:
    """SPD inverse by an f32 Cholesky plus Newton-Schulz refinement
    ``X <- X (2I - H X)``: the first ``ns_steps - f64_steps`` steps in f32 (the
    kernel), the last ``f64_steps`` with an f64 residual. Symmetrized.
    ``X32``, the f32 inverse from ``L32``, may be passed where the caller
    already has it. In f32 the result is the symmetrized f32 inverse, with no
    step."""
    D = H.shape[-1]
    if L32 is None:
        L32 = chol32(H)
    if H.dtype != torch.float64:
        return _sym((_inv32(L32) if X32 is None else X32).to(H.dtype))
    f64_steps = min(f64_steps, ns_steps)
    H32 = H.to(torch.float32).contiguous()
    if X32 is None:
        X32 = _inv32(L32)
    for _ in range(ns_steps - f64_steps):
        X32 = cuda_kernels.ns_step(H32, X32.contiguous())
    X = X32.to(H.dtype)
    eye = _eye(D, H)
    for _ in range(f64_steps):
        # The residual is a cancellation and needs f64; the correction X R
        # only needs f32 (its rounding lands below the refined accuracy).
        Rres = eye - H @ X
        X = X + (X.to(torch.float32) @ Rres.to(torch.float32)).to(H.dtype)
    return _sym(X)


def trace(A: torch.Tensor) -> torch.Tensor:
    return A.diagonal(dim1=-2, dim2=-1).sum(-1)


def _logdet_series(A: torch.Tensor) -> torch.Tensor:
    """``logdet(I - A)`` for a small residual ``A``:
    ``-(tr A + tr A^2/2 + tr A^3/3 + tr A^4/4)``; the powers are f32 products."""
    At = A.transpose(-1, -2)
    tr1 = trace(A)
    tr2 = (A * At).sum((-2, -1))
    A32 = A.to(torch.float32)
    A2 = (A32 @ A32).to(A.dtype)
    tr3 = (A2 * At).sum((-2, -1))
    tr4 = (A2 * A2.transpose(-1, -2)).sum((-2, -1))
    return -(tr1 + tr2 / 2.0 + tr3 / 3.0 + tr4 / 4.0)


def _logdet_equilibrated(Hs, L32, s, dtype, X32=None):
    """logdet of the Jacobi-equilibrated ``Hs`` (f32 factor ``L32``, f32
    inverse ``X32`` from it if given) plus the de-equilibration term
    ``-2 sum log s``.

    With ``G = Ld Ld^T`` (exact product of the f32 factor) and ``X`` the f32
    inverse: ``logdet Hs = logdet(G) + logdet(I - R) - logdet(I + E)``,
    ``R = I - X Hs``, ``E = G X - I``; both residuals are small, so the only
    approximation is the series truncation.
    """
    D = Hs.shape[-1]
    eye = _eye(D, Hs, dtype)
    X = (_inv32(L32) if X32 is None else X32).to(dtype)
    Ld = L32.to(dtype)
    base = 2.0 * torch.log(Ld.diagonal(dim1=-2, dim2=-1)).sum(-1) - 2.0 * torch.log(s).sum(-1)
    R = eye - X @ Hs
    E = (Ld @ Ld.transpose(-1, -2)) @ X - eye
    return base + _logdet_series(R) - _logdet_series(-E)


def _equilibrate(H: torch.Tensor):
    """``(D H D, s)`` with ``D = diag(s)``, ``s = diag(H)^{-1/2}``: unit
    diagonal, so the f32 factor's error stays small."""
    s = 1.0 / torch.sqrt(H.diagonal(dim1=-2, dim2=-1))
    return H * (s[..., :, None] * s[..., None, :]), s


class _LogdetPsdMixed(torch.autograd.Function):
    """logdet with the exact derivative ``d logdet H = <H^{-1}, dH>``, the
    inverse from :func:`inv_psd_mixed`; autograd never enters the f32 factor."""

    @staticmethod
    def forward(ctx, H):
        ctx.save_for_backward(H)
        Hs, s = _equilibrate(H)
        return _logdet_equilibrated(Hs, chol32(Hs), s, H.dtype)

    @staticmethod
    def backward(ctx, g):
        (H,) = ctx.saved_tensors
        return g[..., None, None] * inv_psd_mixed(H)


def logdet_psd_mixed(H: torch.Tensor) -> torch.Tensor:
    """f64-accurate ``log det`` of SPD matrices ``(..., D, D)`` from an f32
    factorization of the Jacobi-equilibrated matrix; differentiable by the
    exact rule ``d logdet H = <H^{-1}, dH>``."""
    return _LogdetPsdMixed.apply(H)


def inv_logdet_psd_mixed(H: torch.Tensor, ns_steps: int = 3, f64_steps: int = 1):
    """``(H^{-1}, logdet H)`` from one f32 factor of the equilibrated matrix;
    the f32 inverse from it is also computed once and serves both."""
    Hs, s = _equilibrate(H)
    L32 = chol32(Hs)
    X32 = _inv32(L32)
    ld = _logdet_equilibrated(Hs, L32, s, H.dtype, X32=X32)
    inv_s = inv_psd_mixed(Hs, L32=L32, ns_steps=ns_steps, f64_steps=f64_steps, X32=X32)
    return inv_s * (s[..., :, None] * s[..., None, :]), ld


class _InvLogdetPsdMixed(torch.autograd.Function):
    """:func:`inv_logdet_psd_mixed` with the exact derivative rules of the
    exact quantities, ``d(H^{-1}) = -H^{-1} dH H^{-1}`` and
    ``d logdet H = <H^{-1}, dH>``, applied from the saved inverse ``X``
    (symmetric): ``grad_H = -X gX X + g_ld X``. Autograd never enters the f32
    factor or the Newton-Schulz steps."""

    @staticmethod
    def forward(ctx, H):
        X, ld = inv_logdet_psd_mixed(H)
        ctx.save_for_backward(X)
        ctx.set_materialize_grads(False)
        return X, ld

    @staticmethod
    def backward(ctx, gX, g_ld):
        (X,) = ctx.saved_tensors
        grad = None
        if gX is not None:
            grad = -(X @ gX @ X)
        if g_ld is not None:
            term = g_ld[..., None, None] * X
            grad = term if grad is None else grad + term
        return grad


def inv_logdet_psd_mixed_d(H: torch.Tensor):
    """``(H^{-1}, logdet H)`` of SPD matrices ``(..., D, D)`` as
    :func:`inv_logdet_psd_mixed`, differentiable by the exact rules (either
    output's cotangent may be absent). This makes the block-tridiagonal
    factorization of :mod:`pgpfa_torch.ops.blocktridiag` differentiable."""
    return _InvLogdetPsdMixed.apply(H)


def blocks_inv(K: torch.Tensor) -> torch.Tensor:
    """Per-block SPD inverse of a ``(..., T, T)`` stack with an extra f64
    Newton-Schulz step (it defines the prior term of the Laplace objective)."""
    return inv_psd_mixed(K, ns_steps=4, f64_steps=2)
