"""The port's dual variational E-step against ``pgpfa.infer.variational``
(f64, CPU) on the problem of ``tests/test_variational.py``, and the
variational fit against ``pgpfa.em.fit.fit``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pgpfa.em.fit import FitConfig as JaxFitConfig
from pgpfa.em.fit import fit as jax_fit
from pgpfa.infer import variational as JV
from pgpfa.models.params import rbf_kernel as jax_rbf_kernel
from pgpfa.ops import blockmat as JB
from pgpfa.oracle import oracle_np as O
from pgpfa_torch import FitConfig, fit
from pgpfa_torch.infer import variational as TV
from pgpfa_torch.models.params import rbf_kernel
from pgpfa_torch.ops import blockmat as TB
from pgpfa_torch.utils.optim import lbfgs_chunked_driver
from torch_helpers import npy, rel_err, requires_cuda, t64

RIDGE = 1e-6
SOLVERS = ("newton", "lbfgs")
# Converged-value parity (tests/test_variational.py holds Newton against
# L-BFGS so): the accept tests f_try < f tie on rounding near the optimum, so
# the two packages' iterates differ while the bound does not.
BOUND_TOL, MEAN_TOL = 1e-7, 1e-5
# Against the SciPy L-BFGS-B oracle, an independent implementation.
ORACLE_TOL, ORACLE_MEAN_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def problem():
    """xdim 2, ydim 8, T 15, R 3: the problem of tests/test_variational.py."""
    rng = np.random.default_rng(33)
    xdim, ydim, T, R, bin_ms = 2, 8, 15, 3, 20.0
    C = rng.uniform(-0.5, 0.5, (ydim, xdim))
    d = rng.uniform(-1.5, 0.0, ydim)
    tau = np.array([0.15, 0.3])
    X = rng.standard_normal((R, xdim, T)) * 0.7
    Y = rng.poisson(np.exp(np.einsum("nk,rkt->rnt", C, X) + d[None, :, None])).astype(float)
    rho = 0.3 * np.random.default_rng(5).standard_normal((R, ydim, T))
    return dict(C=C, d=d, tau=tau, Y=Y, T=T, bin_ms=bin_ms, rho=rho)


def _jargs(p):
    return (jnp.asarray(p["C"]), jnp.asarray(p["d"]), jnp.asarray(p["tau"]),
            jnp.asarray(p["Y"]), p["T"], p["bin_ms"])


def _targs(p):
    return t64(p["C"]), t64(p["d"]), t64(p["tau"]), t64(p["Y"]), p["T"], p["bin_ms"]


def _kernels(p):
    """``(K, Kinv)`` of the JAX package as NumPy: both packages get the same
    prior blocks, so the dual functions are compared alone."""
    K = jax_rbf_kernel(jnp.asarray(p["tau"]), p["T"], p["bin_ms"], 0.001)
    return np.asarray(K), np.asarray(jax.jit(JB.blocks_inv)(K))


@pytest.fixture(scope="module")
def jax_esteps(problem):
    """One cold JAX E-step per solver and the oracle's per-trial solutions."""
    out = {s: JV.vi_estep_from_arrays(*_jargs(problem), solver=s) for s in SOLVERS}
    p = problem
    out["oracle"] = [O.vi_infer_trial(p["Y"][r], p["C"], p["d"], p["tau"], p["bin_ms"])
                     for r in range(p["Y"].shape[0])]
    return out


@pytest.fixture(scope="module")
def torch_esteps(problem):
    return {s: TV.vi_estep_from_arrays(*_targs(problem), solver=s) for s in SOLVERS}


# The inverse of inv_logdet_psd_mixed is one f64 Newton-Schulz step past f32
# ones, so it lands at ~(kappa eps32)^2 of the exact inverse (kappa ~ 2.4e3
# here): measured 2.5e-10 (port) and 3.2e-10 (JAX) from NumPy's, and 4.0e-10
# apart, since the two f32 factors round differently. The logdet's series
# correction takes it to the f64 floor.
INV_TOL, LOGDET_TOL = 2e-9, 1e-10


def test_inv_logdet_psd_mixed_matches_jax(problem):
    """Posterior precisions at a random rho: inverse and logdet against the
    JAX package and NumPy's exact f64 ones; the logdet's gradient is the
    inverse."""
    p = problem
    K, Kinv = _kernels(p)
    prec = npy(TV._posterior_precision(torch.exp(t64(p["rho"])), t64(p["C"]), t64(Kinv), RIDGE))
    inv_t, ld_t = TB.inv_logdet_psd_mixed(t64(prec))
    inv_j, ld_j = jax.jit(jax.vmap(JB.inv_logdet_psd_mixed))(jnp.asarray(prec))
    exact = np.linalg.inv(prec)
    assert rel_err(inv_t, inv_j) < INV_TOL and rel_err(inv_t, exact) < INV_TOL
    assert rel_err(ld_t, ld_j) < LOGDET_TOL
    assert rel_err(ld_t, np.linalg.slogdet(prec)[1]) < LOGDET_TOL
    H = t64(prec).requires_grad_(True)
    (g,) = torch.autograd.grad(TB.logdet_psd_mixed(H).sum(), H)
    assert rel_err(g, exact) < INV_TOL


def test_dual_cost_and_dual_eval_match_jax(problem):
    """Cost to 1e-12 relative; the rho-space gradient and the Newton
    direction, which carry the inverse's ~(kappa eps32)^2, to INV_TOL."""
    p = problem
    K, Kinv = _kernels(p)
    C, d, rho, Y = t64(p["C"]), t64(p["d"]), t64(p["rho"]), t64(p["Y"])
    cost = TV.dual_cost(rho, Y, C, d, t64(K), t64(Kinv), RIDGE)
    f, g, dr = TV._dual_eval(rho, Y, C, d, t64(K), t64(Kinv), RIDGE)
    shared = (jnp.asarray(p["C"]), jnp.asarray(p["d"]), jnp.asarray(K), jnp.asarray(Kinv), RIDGE)

    @jax.jit
    def jax_side(r, y):
        one = lambda a, b: (JV.dual_cost(a, b, *shared), *JV._dual_eval(a, b, *shared))  # noqa: E731
        return jax.vmap(one)(r, y)

    cj, fj, gj, drj = jax_side(jnp.asarray(p["rho"]), jnp.asarray(p["Y"]))
    assert rel_err(cost, cj) <= 1e-12 and rel_err(f, fj) <= 1e-12
    assert rel_err(g, gj) < INV_TOL and rel_err(dr, drj) < INV_TOL


def test_dual_eval_gradient_matches_autograd(problem):
    """``_dual_eval``'s analytic gradient (with the ridge correction) equals
    autograd through ``dual_cost``, whose logdet backward is the exact rule:
    the stationarity condition both solvers share."""
    p = problem
    K, Kinv = _kernels(p)
    C, d, Y = t64(p["C"]), t64(p["d"]), t64(p["Y"])
    rho = t64(p["rho"]).requires_grad_(True)
    cost = TV.dual_cost(rho, Y, C, d, t64(K), t64(Kinv), RIDGE)
    (g_ref,) = torch.autograd.grad(cost.sum(), rho)
    f, g, _ = TV._dual_eval(rho.detach(), Y, C, d, t64(K), t64(Kinv), RIDGE)
    np.testing.assert_allclose(npy(f), npy(cost), rtol=1e-12)
    np.testing.assert_allclose(npy(g), npy(g_ref), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("solver", SOLVERS)
def test_vi_estep_matches_jax_and_oracle(problem, jax_esteps, torch_esteps, solver):
    """Cold E-step: bound and post_loglik within 1e-7 of the JAX package's
    same solver, means within 1e-5; bound and post_loglik within 1e-5 of the
    SciPy oracle, means within 1e-4; covariance views and shapes."""
    res, pll, vlb, rho = torch_esteps[solver]
    j_res, j_pll, j_vlb, _ = jax_esteps[solver]
    assert abs(float(vlb) - float(j_vlb)) <= BOUND_TOL
    assert abs(float(pll) - float(j_pll)) <= BOUND_TOL
    np.testing.assert_allclose(npy(res.post_mean), np.asarray(j_res.post_mean), rtol=0,
                               atol=MEAN_TOL)
    np.testing.assert_allclose(npy(res.post_vsm), np.asarray(j_res.post_vsm), rtol=0,
                               atol=MEAN_TOL)
    np.testing.assert_allclose(npy(res.post_vsm_gp), np.asarray(j_res.post_vsm_gp), rtol=0,
                               atol=MEAN_TOL)
    oracle = jax_esteps["oracle"]
    assert abs(float(vlb) - np.mean([o["bound"] for o in oracle])) <= ORACLE_TOL
    assert abs(float(pll) + np.mean([o["nlp_at_mean"] for o in oracle])) <= ORACLE_TOL
    np.testing.assert_allclose(npy(res.post_mean), np.stack([o["mean"] for o in oracle]),
                               rtol=0, atol=ORACLE_MEAN_TOL)
    R, ydim, T = problem["Y"].shape
    assert rho.shape == (R, ydim, T) and res.post_cov.shape == (R, 2 * T, 2 * T)
    assert npy(res.newton_iters).tolist() == [0] * R


@pytest.mark.parametrize("solver", SOLVERS)
def test_vi_warm_start_from_converged_rho(problem, torch_esteps, solver):
    """A warm start from the converged rho stays at the optimum: the bound
    moves by at most 1e-7 in a short budget."""
    _, _, vlb, rho = torch_esteps[solver]
    _, _, vlb2, _ = TV.vi_estep_from_arrays(*_targs(problem), solver=solver, maxiter=10,
                                            rho_init=rho)
    assert abs(float(vlb2) - float(vlb)) <= BOUND_TOL


def test_vi_estep_rejects_unknown_solver_and_f32(problem):
    with pytest.raises(ValueError, match="'newton' or 'lbfgs'"):
        TV.vi_estep_from_arrays(*_targs(problem), solver="auto")
    # the f32 fast mode runs (tests/test_torch_f32.py holds it against JAX)
    C, d, tau, Y, T, b = _targs(problem)
    _, pll, vlb, rho = TV.vi_estep_from_arrays(C.float(), d.float(), tau.float(), Y.float(), T, b,
                                               solver="newton")
    assert pll.dtype == vlb.dtype == rho.dtype == torch.float32
    assert bool(torch.isfinite(pll) and torch.isfinite(vlb) and torch.isfinite(rho).all())


def _toy_driver(maxiter, chunk, stall_after, gtol=None, g=1.0):
    """Drive a toy carry ``(n, f, g)`` whose cost falls by 1 per iteration
    for ``stall_after`` iterations and then stays; returns the iterations run
    and the chunk sizes asked for."""
    sizes = []

    def make_step(n):
        sizes.append(n)

        def step(c):
            it, f, grad = c
            f = f - float(min(it + n, stall_after) - min(it, stall_after))
            return it + n, f, grad
        return step

    init = (0, torch.zeros(2, dtype=torch.float64), torch.full((2, 3), g, dtype=torch.float64))
    carry = lbfgs_chunked_driver(make_step, init, maxiter, chunk=chunk, gtol=gtol)
    return carry[0], sizes


def test_chunked_driver_exact_budget_and_early_exit():
    """The budget is exactly maxiter (full chunks, then the remainder); the
    run stops after the first chunk without improvement, and at once when
    every gradient is within gtol."""
    assert _toy_driver(23, 5, stall_after=1000) == (23, [5, 3])
    assert _toy_driver(20, 5, stall_after=1000) == (20, [5])
    assert _toy_driver(3, 5, stall_after=1000) == (3, [3])
    assert _toy_driver(23, 5, stall_after=7)[0] == 15  # chunk 3 improves nothing
    assert _toy_driver(23, 5, stall_after=1000, gtol=1e-8, g=1e-9)[0] == 5


N_ITER = 3


@pytest.fixture(scope="module")
def fits(problem):
    """A 3-iteration variational fit per solver in each package."""
    p = problem
    init = {"C": p["C"], "d": p["d"], "tau": p["tau"]}
    out = {}
    for s in SOLVERS:
        kw = dict(inference_method="variational", max_em_iter=N_ITER, vi_solver=s)
        j = jax_fit(init, p["Y"], p["bin_ms"], JaxFitConfig(**kw))
        jax.block_until_ready(j.post_loglik)
        out[s] = j, fit(init, p["Y"], p["bin_ms"], FitConfig(**kw), device="cpu")
    return out


@pytest.mark.parametrize("solver", SOLVERS)
def test_variational_fit_matches_jax(fits, solver):
    """Iteration 0 sees identical inputs: post_loglik and bound within 1e-8
    with Newton; L-BFGS stops farther from the optimum (its E-step's means
    differ by ~1e-7), so within BOUND_TOL. EM amplifies the solvers' stopping
    noise ~5x per iteration, so iteration n agrees within 1e-6 * 5^(n-1)
    (tests/test_torch_fit.py). The bound rises (variational EM is monotone
    up to solver tolerance)."""
    j, t = fits[solver]
    tol0 = 1e-8 if solver == "newton" else BOUND_TOL
    for name in ("post_loglik", "var_lower_bound"):
        a, b = npy(getattr(t, name)), np.asarray(getattr(j, name))
        assert abs(a[0] - b[0]) <= tol0, (name, a[0] - b[0])
        for n in range(1, N_ITER):
            assert abs(a[n] - b[n]) <= 1e-6 * 5.0 ** (n - 1), (name, n, a[n] - b[n])
    np.testing.assert_allclose(npy(t.tau), np.asarray(j.tau), rtol=1e-5)
    vlb = npy(t.var_lower_bound)
    assert np.all(np.diff(vlb) >= -1e-6 * np.abs(vlb[1:]))
    assert npy(t.newton_iters).shape == (N_ITER, 3) and not npy(t.newton_iters).any()


@requires_cuda
@pytest.mark.parametrize("solver", SOLVERS)
def test_cuda_vi_estep_matches_cpu(problem, torch_esteps, solver):
    """The E-step on the card (both kernels) against the port's CPU path:
    bound and post_loglik within 1e-7, means within 1e-5."""
    C, d, tau, Y, T, b = (x.cuda() if isinstance(x, torch.Tensor) else x for x in _targs(problem))
    res, pll, vlb, _ = TV.vi_estep_from_arrays(C, d, tau, Y, T, b, solver=solver)
    c_res, c_pll, c_vlb, _ = torch_esteps[solver]
    assert vlb.device.type == "cuda"
    assert abs(float(vlb) - float(c_vlb)) <= BOUND_TOL
    assert abs(float(pll) - float(c_pll)) <= BOUND_TOL
    np.testing.assert_allclose(npy(res.post_mean), npy(c_res.post_mean), rtol=0, atol=MEAN_TOL)


# The covariance Sigma inside _dual_eval is the f64-refined inverse of an f32
# factor: ~(kappa eps32)^2 <= 4e-7 relative at the Stevenson slice's
# equilibrated condition (kappa ~ 1e4; 2.6e-9 measured against NumPy's exact
# inverse on the CPU), on each side. It enters the gradient lam * g only
# through the sandwich term 0.5 lam s, s = diag(C^T Sigma C), and the
# direction C Sigma C^T w - g through g's 0.5 s and through C Sigma C^T w:
# each is held to 1e-6 of the largest entries of its terms.
DUAL_EVAL_TOL = 1e-6


@requires_cuda
def test_cuda_dual_eval_d700_matches_cpu():
    """``_dual_eval`` at the Stevenson width (2 trials, D = 700) on the card
    against the CPU: the cost to 1e-10 relative, the gradient and direction
    to ``DUAL_EVAL_TOL``."""
    from pgpfa_torch import initialize_params, stevenson_surrogate

    ds = stevenson_surrogate(xdim=5, seed=2011)
    init = initialize_params(5, ds.ydim, ds, seed=0)
    C, d, tau = t64(init["C"]), t64(init["d"]), t64(init["tau"])
    Y = t64(ds.Y[:2])
    rho = torch.log(Y + 0.5)
    K = rbf_kernel(tau, ds.T, float(ds.binSize))
    Kinv = TB.blocks_inv(K)
    f, w, dr = TV._dual_eval(rho, Y, C, d, K, Kinv, RIDGE)
    gf, gw, gdr = TV._dual_eval(*(x.cuda() for x in (rho, Y, C, d, K, Kinv)), RIDGE)
    assert rel_err(gf, f) <= 1e-10
    lam = torch.exp(rho)
    g = w / lam
    half_s = rho - g - (d[:, None] - C @ TV._prior_terms(rho, Y, C, d, K)[2])
    scale_dr = float(half_s.abs().max() + (dr + g).abs().max())
    assert float((gw.cpu() - w).abs().max()) <= DUAL_EVAL_TOL * float((lam * half_s).abs().max())
    assert float((gdr.cpu() - dr).abs().max()) <= DUAL_EVAL_TOL * scale_dr
