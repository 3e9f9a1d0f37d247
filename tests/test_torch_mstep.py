"""The port's M-steps against ``pgpfa.learn`` in f64 (CPU), on posterior
moments from one JAX E-step of a small problem."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pgpfa.infer.laplace import laplace_estep_from_arrays as jax_estep
from pgpfa.learn import mstep_gp as jgp
from pgpfa.learn import mstep_obs as jobs
from pgpfa.models.params import pack_cd as jax_pack_cd
from pgpfa.models.params import time_sqdist
from pgpfa_torch.learn import mstep_gp as tgp
from pgpfa_torch.learn import mstep_obs as tobs
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
    ds, init, m = moments
    args = tuple(map(t64, (ds.Y, m["post_mean"], m["post_vsm"], init["C"], init["d"])))
    res = tobs.learn_cd(*args, maxiter=3)
    assert int(res.niter) == 3
    with pytest.raises(NotImplementedError):
        tobs.learn_cd(*args, method="lbfgs")
    with pytest.raises(NotImplementedError):
        tobs.learn_cd(*args, prior=(torch.eye(2), torch.zeros(2)))


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
    curvature), the costs to 1e-12, the accepted-step counts exactly."""
    ds, init, m = moments
    args = (m["post_mean"], m["post_vsm_gp"], init["tau"])
    j = jgp.learn_tau(*map(jnp.asarray, args), BIN, maxiter=6)
    t = tgp.learn_tau(*map(t64, args), BIN, maxiter=6)
    assert rel_err(t.tau, j.tau) < 1e-7
    assert rel_err(t.cost, j.cost) < 1e-12
    np.testing.assert_array_equal(npy(t.niter), np.asarray(j.niter))
    with pytest.raises(NotImplementedError):
        tgp.learn_tau(*map(t64, args), BIN, prior=(t64(init["tau"]), 0.1))
