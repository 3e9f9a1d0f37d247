"""Fixed-iteration L-BFGS batched over independent lanes, and the chunked
driver with early exit (PyTorch port of the parts of ``pgpfa/utils/optim.py``
the variational E-step uses).

Lanes lead every tensor: a carry holds ``R`` independent problems (one per
trial), every inner product is a per-lane sum and every accept test an
``(R,)`` mask. ``fun`` maps a batch of points ``(R, *shape)`` to the lanes'
costs ``(R,)``; because the lanes are independent, the gradient of the sum of
the costs is each lane's own gradient, so one ``torch.autograd.grad`` call
serves all lanes.
"""

from __future__ import annotations

from typing import Callable

import torch

from pgpfa_torch.infer.laplace import _where


def _value_and_grad(fun: Callable, xf: torch.Tensor, shape):
    """Per-lane cost and gradient of ``fun`` at the flat points ``xf (R, n)``."""
    with torch.enable_grad():
        x = xf.detach().requires_grad_(True)
        f = fun(x.reshape(x.shape[0], *shape))
        (g,) = torch.autograd.grad(f.sum(), x)
    return f.detach(), g


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def lbfgs_fixed_init(fun: Callable, x0: torch.Tensor, memory_size: int = 10):
    """Initial carry ``(x, f, g, S, Y, rho, gamma)`` of the fixed-iteration
    L-BFGS for the lanes ``x0 (R, *shape)``; ``x`` is flattened per lane."""
    R = x0.shape[0]
    xf0 = x0.reshape(R, -1)
    f0, g0 = _value_and_grad(fun, xf0, x0.shape[1:])
    n, m = xf0.shape[1], memory_size
    z = lambda *s: torch.zeros(*s, dtype=x0.dtype, device=x0.device)  # noqa: E731
    return (xf0, f0, g0, z(R, m, n), z(R, m, n), z(R, m),
            torch.ones(R, dtype=x0.dtype, device=x0.device))


def lbfgs_fixed_steps(fun: Callable, carry, n_iter: int, shape):
    """Advance a :func:`lbfgs_fixed_init` carry by ``n_iter`` iterations;
    ``shape`` is one lane's point shape."""
    for _ in range(n_iter):
        carry = _lbfgs_fixed_body(fun, carry, shape)
    return carry


def _lbfgs_fixed_body(fun: Callable, carry, shape):
    """One L-BFGS iteration on every lane.

    Two-loop recursion over the ``m`` most recent pairs (empty slots carry
    ``rho = 0`` and do nothing); steepest descent where the direction does
    not descend; a branchless line search that evaluates the full step and a
    quadratic-interpolation step and keeps the better; a lane whose best
    candidate does not improve keeps its point. Only accepted steps with
    positive curvature enter the memory; a rejected step flushes it.
    """
    x, f, g, S, Ym, rho, gamma = carry
    R, m = x.shape[0], S.shape[1]

    def f_of(xf):
        with torch.no_grad():
            return fun(xf.reshape(R, *shape))

    q = g
    alphas = [None] * m
    for i in range(m - 1, -1, -1):
        a = rho[:, i] * _vdot(S[:, i], q)
        q = q - a[:, None] * Ym[:, i]
        alphas[i] = a
    r = gamma[:, None] * q
    for i in range(m):
        b = rho[:, i] * _vdot(Ym[:, i], r)
        r = r + S[:, i] * (alphas[i] - b)[:, None]
    p = -r
    slope = _vdot(g, p)
    bad = ~torch.isfinite(slope) | (slope >= 0)
    p = _where(bad, -g, p)
    slope = torch.where(bad, -_vdot(g, g), slope)

    f1 = f_of(x + p)
    denom = f1 - f - slope
    pos = denom > 0
    t_q = torch.where(pos, -0.5 * slope / torch.where(pos, denom, 1.0), 1.0).clamp(0.05, 2.0)
    f2 = f_of(x + t_q[:, None] * p)
    inf = torch.full_like(f1, torch.inf)
    f1 = torch.where(torch.isfinite(f1), f1, inf)
    f2 = torch.where(torch.isfinite(f2), f2, inf)
    t = torch.where(f2 < f1, t_q, 1.0)
    f_cand = torch.minimum(f1, f2)
    accept = f_cand < f
    x_new = _where(accept, x + t[:, None] * p, x)
    f_new = torch.where(accept, f_cand, f)
    _, g_new = _value_and_grad(fun, x_new, shape)

    s = x_new - x
    y = g_new - g
    sy = _vdot(s, y)
    yy = _vdot(y, y)
    valid = accept & (sy > 1e-13 * torch.sqrt(_vdot(s, s) * yy)) & torch.isfinite(sy)
    S = torch.cat([S[:, 1:], _where(valid, s, torch.zeros_like(s))[:, None]], 1)
    Ym = torch.cat([Ym[:, 1:], _where(valid, y, torch.zeros_like(y))[:, None]], 1)
    rho_new = torch.where(valid, 1.0 / torch.where(valid, sy, 1.0), 0.0)
    rho = torch.cat([rho[:, 1:], rho_new[:, None]], 1) * accept.to(rho.dtype)[:, None]
    gamma = torch.where(valid, sy / yy, gamma)
    gamma = torch.where(accept, gamma, 0.1 * gamma)
    return (x_new, f_new, g_new, S, Ym, rho, gamma)


def lbfgs_chunked_driver(
    make_step: Callable[[int], Callable],
    init,
    maxiter: int,
    chunk: int = 25,
    slack_coef: float = 1e-13,
    gtol: float = None,
):
    """Drive a batched carry in chunks of iterations with early exit.

    Runs at most ``floor(maxiter / chunk)`` full chunks, then one chunk of
    ``maxiter % chunk`` iterations unless done, so the budget is exactly
    ``maxiter``. Done: after a chunk, every lane improved by no more than its
    own slack ``slack_coef * (1 + |f|)``, or (with ``gtol``) every lane's
    gradient inf-norm is at most ``gtol``. Each chunk ends in one host
    readback of that test.

    Args:
        make_step: ``make_step(n)`` advances the whole carry by ``n``
            iterations.
        init: the carry; ``carry[1]`` is the lanes' cost ``(R,)``,
            ``carry[2]`` their gradient ``(R, ...)``.
        maxiter: exact total iteration budget.
    """
    chunk = min(chunk, maxiter)
    n_full, rem = divmod(maxiter, chunk)
    step = make_step(chunk)
    carry, done = init, False
    for _ in range(n_full):
        f_before = carry[1]
        carry = step(carry)
        f_after = carry[1]
        stop = (f_before - f_after <= slack_coef * (1.0 + f_after.abs())).all()
        if gtol is not None:
            stop = stop | (carry[2].abs().amax() <= gtol)
        done = bool(stop)
        if done:
            break
    if rem and not done:
        carry = make_step(rem)(carry)
    return carry
