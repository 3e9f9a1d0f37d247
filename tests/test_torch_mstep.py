"""The port's M-steps against ``pgpfa.learn`` in f64 (CPU), on posterior
moments from one JAX E-step of a small problem."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pgpfa.infer.laplace import laplace_estep_from_arrays as jax_estep
from pgpfa.learn import mstep_gp as jgp
from pgpfa.learn import mstep_obs as jobs
from pgpfa.models.params import pack_cd as jax_pack_cd
from pgpfa.models.params import time_sqdist
from pgpfa_torch.learn import mstep_gp as tgp
from pgpfa_torch.learn import mstep_obs as tobs
from pgpfa_torch.utils.optim import minimize_lbfgs
from torch_helpers import npy, rel_err, small_problem, t64

BIN = 10.0


@pytest.fixture(scope="module")
def moments():
    """Y, init and the JAX E-step's moments (identical inputs to both M-steps)."""
    ds, init = small_problem()
    inf, _ = jax_estep(*(jnp.asarray(init[k]) for k in ("C", "d", "tau")), jnp.asarray(ds.Y),
                       ds.T, BIN)
    m = {k: np.asarray(getattr(inf, k)) for k in ("post_mean", "post_vsm", "post_vsm_gp")}
    return ds, init, m


def test_cd_cost(moments):
    """One einsum expression summed in another order: 1e-13 relative."""
    ds, init, m = moments
    v = np.asarray(jax_pack_cd(jnp.asarray(init["C"]), jnp.asarray(init["d"])))
    want = float(jobs.cd_cost(jnp.asarray(v), jnp.asarray(ds.Y), jnp.asarray(m["post_mean"]),
                              jnp.asarray(m["post_vsm"])))
    got = float(tobs.cd_cost(t64(v), t64(ds.Y), t64(m["post_mean"]), t64(m["post_vsm"])))
    assert abs(got - want) <= 1e-13 * abs(want)


@pytest.mark.parametrize("n_iter", [3, 8])
def test_learn_cd_newton(moments, n_iter):
    """After 3 steps (still converging) the iterates agree to 1e-12. Near the
    optimum a candidate's cost change falls to one ULP of the cost, so
    ``f_c < f`` accepts or rejects it on rounding: the per-neuron iterates
    then agree only to the size of such a step (~3e-8 here) and the costs to
    1e-13 relative (both optimal to their resolution)."""
    ds, init, m = moments
    args = (ds.Y, m["post_mean"], m["post_vsm"], init["C"], init["d"])
    j = jobs.learn_cd_newton(*map(jnp.asarray, args), n_iter=n_iter)
    t = tobs.learn_cd_newton(*map(t64, args), n_iter=n_iter)
    tol = 1e-12 if n_iter == 3 else 1e-7
    np.testing.assert_allclose(npy(t.C), np.asarray(j.C), rtol=0, atol=tol)
    np.testing.assert_allclose(npy(t.d), np.asarray(j.d), rtol=0, atol=tol)
    assert abs(float(t.cost) - float(j.cost)) <= 1e-13 * abs(float(j.cost))
    if n_iter == 3:
        assert int(t.niter) == int(j.niter) == 3
    else:
        assert float(t.grad_norm) < 1e-6 and float(j.grad_norm) < 1e-6


@pytest.fixture(scope="module")
def moments_x10():
    """Random moments at xdim 10, the problem of tests/test_mstep.py's
    contraction-branch test (R 3, ydim 7, T 10) one latent wider."""
    rng = np.random.default_rng(3)
    R, ydim, T, xdim = 3, 7, 10, 10
    means = rng.normal(0, 0.5, (R, xdim, T))
    A = rng.normal(0, 0.2, (R, T, xdim, xdim))
    vsms = np.einsum("rtij,rtkj->rtik", A, A) + 0.05 * np.eye(xdim)
    C0 = rng.uniform(-0.3, 0.3, (ydim, xdim))
    d0 = rng.uniform(-1.0, 0.0, ydim)
    Y = rng.poisson(np.exp(np.clip(np.einsum("nk,rkt->rnt", C0, means) + d0[:, None], None,
                                   2.0))).astype(float)
    return Y, means, vsms, C0, d0


@pytest.mark.parametrize("n_iter", [3, 25])
def test_learn_cd_newton_contraction_xdim10(moments_x10, n_iter):
    """xdim > 8 takes the contraction form (u = m + V c; the x^4 moment
    tensor is never formed) on both sides. After 3 steps (still converging)
    the iterates agree to 1e-12; after 25 (converged, with near-optimum
    accept/reject ties on cost rounding as at xdim 2) to 1e-7, the costs to
    1e-13 relative and both gradients are below 1e-6."""
    j = jobs.learn_cd_newton(*map(jnp.asarray, moments_x10), n_iter=n_iter)
    t = tobs.learn_cd_newton(*map(t64, moments_x10), n_iter=n_iter)
    tol = 1e-12 if n_iter == 3 else 1e-7
    np.testing.assert_allclose(npy(t.C), np.asarray(j.C), rtol=0, atol=tol)
    np.testing.assert_allclose(npy(t.d), np.asarray(j.d), rtol=0, atol=tol)
    assert abs(float(t.cost) - float(j.cost)) <= 1e-13 * abs(float(j.cost))
    if n_iter == 25:
        assert float(t.grad_norm) < 1e-6 and float(j.grad_norm) < 1e-6


def test_learn_cd_newton_branch_only(moments):
    """``learn_cd``: without a prior the Newton path (3 steps accepted); with
    ``method='lbfgs'`` and with a dense prior over the packed vector the
    L-BFGS path, which converges to ``tol`` where optax does and agrees with
    JAX at the converged point: parameters 1e-8 (the gradient 1e-9 over the
    smallest curvature), cost 1e-12 relative."""
    ds, init, m = moments
    arrays = (ds.Y, m["post_mean"], m["post_vsm"], init["C"], init["d"])
    args = tuple(map(t64, arrays))
    res = tobs.learn_cd(*args, maxiter=3)
    assert int(res.niter) == 3
    n = init["C"].size + init["d"].size
    rng = np.random.default_rng(0)
    A = rng.normal(size=(n, n)) / np.sqrt(n)
    P = A @ A.T + 0.5 * np.eye(n)
    center = np.asarray(jax_pack_cd(jnp.asarray(init["C"]), jnp.asarray(init["d"]))) + 0.05
    for kw, jkw in ((dict(method="lbfgs"), dict(method="lbfgs")),
                    (dict(prior=(t64(P), t64(center))),
                     dict(prior=(jnp.asarray(P), jnp.asarray(center))))):
        t = tobs.learn_cd(*args, tol=1e-9, **kw)
        j = jobs.learn_cd(*map(jnp.asarray, arrays), tol=1e-9, **jkw)
        assert float(t.grad_norm) <= 1e-9 and float(j.grad_norm) <= 1e-9
        np.testing.assert_allclose(npy(t.C), np.asarray(j.C), rtol=0, atol=1e-8)
        np.testing.assert_allclose(npy(t.d), np.asarray(j.d), rtol=0, atol=1e-8)
        assert abs(float(t.cost) - float(j.cost)) <= 1e-12 * abs(float(j.cost))
    with pytest.raises(ValueError):
        tobs.learn_cd(*args, method="bfgs")


@pytest.mark.parametrize("n_iter", [2, 8])
@pytest.mark.parametrize("kind", ["diag", "hess"])
def test_learn_cd_newton_prior(moments, kind, n_iter):
    """The prior-blocked Newton of the online rules: blocks ``I / s^2``
    ('diag', s = 0.5) or the exact per-neuron Hessian plus ``I`` ('hess'),
    centered at the init. The prior speeds convergence, so after 2 steps
    (still converging) the iterates agree to 1e-12 and the accepted-step
    counts exactly; after 8 (converged, with the near-optimum accept/reject
    ties of test_learn_cd_newton) to 1e-7 with both gradients below 1e-6.
    The cost, penalty included, agrees to 1e-13 relative."""
    ds, init, m = moments
    arrays = (ds.Y, m["post_mean"], m["post_vsm"], init["C"], init["d"])
    theta = np.concatenate([init["C"], init["d"][:, None]], axis=1)
    ydim, q = theta.shape
    if kind == "diag":
        Pb = np.broadcast_to(np.eye(q) / 0.5**2, (ydim, q, q)).copy()
    else:
        Pb = npy(tobs.neuron_grad_hess(t64(theta), *map(t64, arrays[:3]))[1]) + np.eye(q)
    j = jobs.learn_cd_newton(*map(jnp.asarray, arrays),
                             prior_blocks=(jnp.asarray(Pb), jnp.asarray(theta)), n_iter=n_iter)
    t = tobs.learn_cd_newton(*map(t64, arrays), prior_blocks=(t64(Pb), t64(theta)),
                             n_iter=n_iter)
    tol = 1e-12 if n_iter == 2 else 1e-7
    np.testing.assert_allclose(npy(t.C), np.asarray(j.C), rtol=0, atol=tol)
    np.testing.assert_allclose(npy(t.d), np.asarray(j.d), rtol=0, atol=tol)
    assert abs(float(t.cost) - float(j.cost)) <= 1e-13 * abs(float(j.cost))
    if n_iter == 2:
        assert int(t.niter) == int(j.niter) == 2
    else:
        assert float(t.grad_norm) < 1e-6 and float(j.grad_norm) < 1e-6


def test_neuron_grad_hess(moments):
    """The moment-tensor form against JAX's vmapped per-neuron einsums:
    1e-12 relative to the largest entry."""
    ds, init, m = moments
    theta = np.concatenate([init["C"], init["d"][:, None]], axis=1)
    Y, means, vsms = ds.Y, m["post_mean"], m["post_vsm"]
    R = Y.shape[0]
    gj, Hj = jax.vmap(lambda th, y: jobs._neuron_grad_hess(
        th, y, jnp.asarray(means), jnp.asarray(vsms), R))(
        jnp.asarray(theta), jnp.swapaxes(jnp.asarray(Y), 0, 1))
    gt, Ht = tobs.neuron_grad_hess(t64(theta), t64(Y), t64(means), t64(vsms))
    assert gt.shape == (theta.shape[0], 3) and Ht.shape == (theta.shape[0], 3, 3)
    assert rel_err(gt, gj) < 1e-12
    assert rel_err(Ht, Hj) < 1e-12


def test_c_only_grad_hess(moments):
    """The C-only gradient and the scattered dense Hessian in latent-major
    ``vC`` order against ``jax.grad`` and ``jax.hessian`` of the JAX cost
    and against ``torch.func.hessian`` of the port's: 1e-12 relative. xdim 2,
    where a neuron-major layout would not agree."""
    ds, init, m = moments
    Y, means, vsms = ds.Y, m["post_mean"], m["post_vsm"]
    d = init["d"]
    vC = init["C"].T.reshape(-1)
    assert init["C"].shape[1] >= 2

    def c_cost(v):
        return jobs.cd_cost(jnp.concatenate([v, jnp.asarray(d)]), jnp.asarray(Y),
                            jnp.asarray(means), jnp.asarray(vsms))

    g, H = tobs.c_only_grad_hess(t64(vC), t64(d), t64(Y), t64(means), t64(vsms))
    assert rel_err(g, jax.jit(jax.grad(c_cost))(jnp.asarray(vC))) < 1e-12
    assert rel_err(H, jax.jit(jax.hessian(c_cost))(jnp.asarray(vC))) < 1e-12
    Hf = torch.func.hessian(lambda v: tobs.c_only_cost(v, t64(d), t64(Y), t64(means),
                                                        t64(vsms)))(t64(vC))
    assert rel_err(H, Hf) < 1e-12


def test_update_d_closed_form(moments):
    ds, init, m = moments
    arrays = (ds.Y, m["post_mean"], m["post_vsm"], init["C"])
    want = jobs.update_d_closed_form(*map(jnp.asarray, arrays))
    assert rel_err(tobs.update_d_closed_form(*map(t64, arrays)), want) < 1e-12


@pytest.mark.parametrize("case", ["quadratic", "rosenbrock"])
def test_minimize_lbfgs(case):
    """The converging L-BFGS reaches ``tol`` on a convex quadratic whose
    optimum lies far from zero cost (cost differences there fall below the
    cost's rounding long before the gradient reaches ``tol``) and on the
    20-dimensional Rosenbrock function."""
    rng = np.random.default_rng(1)
    if case == "quadratic":
        A = rng.normal(size=(20, 20))
        A = t64(A @ A.T + np.eye(20))
        b = t64(rng.normal(size=20))
        x_star = np.linalg.solve(npy(A), npy(b))

        def fun(x):
            return 0.5 * x @ (A @ x) - b @ x + 130.0
        x0 = torch.zeros(20, dtype=torch.float64)
    else:
        x_star = np.ones(20)

        def fun(x):
            return ((1 - x[:-1]) ** 2).sum() + 100 * ((x[1:] - x[:-1] ** 2) ** 2).sum()
        x0 = t64(np.tile([-1.2, 1.0], 10))
    res = minimize_lbfgs(fun, x0, maxiter=500, tol=1e-10)
    assert float(res.grad_norm) <= 1e-10 and 0 < int(res.niter) < 500
    np.testing.assert_allclose(npy(res.x), x_star, rtol=0, atol=1e-8)
    assert float(res.fun) == float(fun(res.x))


def test_pauto_sum(moments):
    _, _, m = moments
    got = tgp.pauto_sum(t64(m["post_mean"]), t64(m["post_vsm_gp"]))
    want = np.asarray(jgp.pauto_sum(jnp.asarray(m["post_mean"]), jnp.asarray(m["post_vsm_gp"])))
    assert rel_err(got, want) < 1e-14


@pytest.fixture(scope="module")
def pauto(moments):
    ds, _, m = moments
    P = np.asarray(jgp.pauto_sum(jnp.asarray(m["post_mean"]), jnp.asarray(m["post_vsm_gp"])))
    return P, np.asarray(time_sqdist(ds.T)), float(ds.numTrials)


@pytest.mark.parametrize("p", [-2.0, -3.5, -5.0])
def test_tau_cost_and_derivatives(pauto, p):
    """Cost (logdet + refined solve, ~1e-12 accurate in both) to 1e-12
    relative. The derivatives come from ``inv_psd_mixed`` (one f64 step:
    ~(kappa eps32)^2 relative, kappa(K) from 7e3 at p = -2 to 2.4e4 at
    p = -5) through products with cancellation, so g and h agree to 5e-8
    relative of their magnitude (1e-8 observed at p = -5)."""
    P, dsq, R = pauto
    pt = torch.tensor([p, p], dtype=torch.float64)
    cost = tgp.tau_cost(pt, t64(P), R, t64(dsq))
    g, h = tgp._tau_derivatives(pt, t64(P), R, t64(dsq), 1e-3)
    for k in range(2):
        args = (jnp.asarray(p), jnp.asarray(P[k]), R, jnp.asarray(dsq))
        want = float(jgp.tau_cost(*args))
        assert abs(float(cost[k]) - want) <= 1e-12 * abs(want)
        gj, hj = (float(x) for x in jgp._tau_derivatives(*args, 1e-3))
        assert abs(float(g[k]) - gj) <= 5e-8 * max(abs(gj), abs(hj))
        assert abs(float(h[k]) - hj) <= 5e-8 * max(abs(gj), abs(hj))


def test_learn_tau(moments):
    """Six guarded Newton steps on those derivatives: the timescales agree to
    1e-7 relative (the optimum moves by the derivative difference over the
    curvature), the costs to 1e-12, the accepted-step counts exactly. With
    the online-EM prior (centered at the init, step size 0.1 s) the same
    after 2 steps; it converges there, so after 6 the later accept/reject
    decisions tie on cost rounding and only tau and the cost are compared."""
    ds, init, m = moments
    args = (m["post_mean"], m["post_vsm_gp"], init["tau"])
    prior_t, prior_j = (t64(init["tau"]), 0.1), (jnp.asarray(init["tau"]), 0.1)
    for tp, jp, maxiter in ((None, None, 6), (prior_t, prior_j, 2), (prior_t, prior_j, 6)):
        j = jgp.learn_tau(*map(jnp.asarray, args), BIN, prior=jp, maxiter=maxiter)
        t = tgp.learn_tau(*map(t64, args), BIN, prior=tp, maxiter=maxiter)
        assert rel_err(t.tau, j.tau) < 1e-7
        assert rel_err(t.cost, j.cost) < 1e-12
        if tp is None or maxiter == 2:
            np.testing.assert_array_equal(npy(t.niter), np.asarray(j.niter))
