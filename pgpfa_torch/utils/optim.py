"""Minimizers (PyTorch port of ``pgpfa/utils/optim.py``): the converging
L-BFGS of the online (C, d) M-step (:func:`minimize_lbfgs`), and the
fixed-iteration L-BFGS batched over independent lanes with its chunked
driver, which the variational E-step uses.

Lanes lead every tensor: a carry holds ``R`` independent problems (one per
trial), every inner product is a per-lane sum and every accept test an
``(R,)`` mask. ``fun`` maps a batch of points ``(R, *shape)`` to the lanes'
costs ``(R,)``; because the lanes are independent, the gradient of the sum of
the costs is each lane's own gradient, so one ``torch.autograd.grad`` call
serves all lanes.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from pgpfa_torch.infer.laplace import _where


class MinimizeResult(NamedTuple):
    x: torch.Tensor
    fun: torch.Tensor
    grad_norm: torch.Tensor
    niter: torch.Tensor


def minimize_lbfgs(fun: Callable[[torch.Tensor], torch.Tensor], x0: torch.Tensor,
                   maxiter: int = 500, tol: float = 1e-10,
                   memory_size: int = 15) -> MinimizeResult:
    """Minimize a smooth scalar function of one tensor with L-BFGS until the
    gradient's infinity norm is at most ``tol`` (at least one iteration, at
    most ``maxiter``, stopping early on a non-finite gradient), as the JAX
    package's optax loop does.

    The line search (:func:`_line_search`) accepts a step on the strong Wolfe
    conditions with optax's approximate decrease ``f <= f0 + 1e-6 |f0|`` in
    place of the Armijo test, so near the optimum, where cost differences
    fall below the cost's rounding, it decides on the directional derivative
    and still converges. Its steps differ from optax's zoom search, so the
    iterates and the iteration counts differ; the converged points agree.
    Every iteration reads the gradient norm and the line search's tests back
    to the host.

    Returns the final point, ``fun`` there, the infinity norm of its
    gradient there and the iteration count.
    """
    x = x0.detach().clone()
    f, g = _fun_grad(fun, x)
    S, Yk = [], []
    niter = 0
    while niter == 0 or niter < maxiter:
        gnorm = float(g.abs().max())
        if niter > 0 and not gnorm > tol:  # also stops on a NaN
            break
        d = -_two_loop(g, S, Yk)
        slope = float(d @ g)
        found = None
        if S and slope < 0:
            found = _line_search(fun, x, float(f), d, slope, 1.0)
        if found is None:  # no memory, no descent from it, or no step along it
            S, Yk = [], []
            d = -g
            t0 = min(1.0, 1.0 / max(float(g.abs().sum()), 1e-300))
            found = _line_search(fun, x, float(f), d, -float(g @ g), t0)
        niter += 1
        if found is None:  # no acceptable step even along -g: stalled
            break
        t, f_new, g_new = found
        s, y = t * d, g_new - g
        sy = float(s @ y)
        if sy > 1e-13 * float(torch.linalg.vector_norm(s) * torch.linalg.vector_norm(y)):
            S.append(s)
            Yk.append(y)
            if len(S) > memory_size:
                S.pop(0)
                Yk.pop(0)
        x, f, g = x + s, f_new, g_new
    return MinimizeResult(x=x, fun=f, grad_norm=g.abs().amax(),
                          niter=torch.tensor(niter, dtype=torch.int32, device=x0.device))


def _fun_grad(fun: Callable, x: torch.Tensor):
    """``fun`` and its gradient at one point ``x``."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        f = fun(xr)
        (g,) = torch.autograd.grad(f, xr)
    return f.detach(), g


def _two_loop(g, S, Yk):
    """The L-BFGS inverse-Hessian approximation applied to ``g``, with the
    initial scaling ``s.y / y.y`` of the newest pair."""
    q = g.clone()
    alphas = []
    for s, y in zip(reversed(S), reversed(Yk)):
        a = (s @ q) / (s @ y)
        q = q - a * y
        alphas.append(a)
    if S:
        q = q * ((S[-1] @ Yk[-1]) / (Yk[-1] @ Yk[-1]))
    for (s, y), a in zip(zip(S, Yk), reversed(alphas)):
        b = (y @ q) / (s @ y)
        q = q + (a - b) * s
    return q


def _line_search(fun, x, f0: float, d, slope: float, t: float, c1: float = 1e-4,
                 c2: float = 0.9, approx_rtol: float = 1e-6, max_evals: int = 30):
    """A step ``t`` along the descent direction ``d`` (``slope = g . d < 0``)
    meeting the strong Wolfe conditions, with the Armijo test relaxed to
    optax's approximate decrease ``f(t) <= f0 + approx_rtol |f0|``; returns
    ``(t, f(t), grad(t))``, or None after ``max_evals`` evaluations.

    The step doubles while the cost stays acceptable and the slope negative;
    once bracketed, the next trial is the secant root of the slope, kept in
    the middle 80% of the bracket, or else the midpoint."""
    lo, hi = 0.0, None
    slope_lo, slope_hi = slope, None
    for _ in range(max_evals):
        ft, gt = _fun_grad(fun, x + t * d)
        fv, st = float(ft), float(gt @ d)
        decrease = fv <= f0 + c1 * t * slope or fv <= f0 + approx_rtol * abs(f0)
        if decrease and abs(st) <= c2 * -slope:
            return t, ft, gt
        if not decrease or st > 0:  # too far (or NaN): t bounds the step from above
            hi, slope_hi = t, (st if decrease else None)
        else:
            lo, slope_lo = t, st
        if hi is None:
            t = 2.0 * t
            continue
        w = hi - lo
        t = 0.5 * (lo + hi)
        if slope_hi is not None and slope_hi > slope_lo:
            sec = lo - slope_lo * w / (slope_hi - slope_lo)
            if lo + 0.1 * w <= sec <= hi - 0.1 * w:
                t = sec
    return None


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
    xf0 = x0.reshape(R, x0.shape[1:].numel())
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
            stop = stop | (carry[2].abs() <= gtol).all()
        done = bool(stop)
        if done:
            break
    if rem and not done:
        carry = make_step(rem)(carry)
    return carry
