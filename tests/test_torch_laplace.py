"""The port's Laplace E-step against ``pgpfa.infer.laplace`` in f64 (CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pgpfa.infer.laplace import laplace_estep_from_arrays as jax_estep
from pgpfa_torch.infer.laplace import _newton_solve
from pgpfa_torch.infer.laplace import laplace_estep_from_arrays as torch_estep
from torch_helpers import npy, rel_err, small_problem, t64

BIN = 10.0


@pytest.fixture(scope="module")
def problem():
    ds, init = small_problem()
    return ds, init


def _both(ds, C, d, tau, **kw):
    jkw = {k: (None if v is None else jnp.asarray(v)) for k, v in kw.items()}
    tkw = {k: (None if v is None else t64(v)) for k, v in kw.items()}
    j, jp = jax_estep(jnp.asarray(C), jnp.asarray(d), jnp.asarray(tau), jnp.asarray(ds.Y),
                      ds.T, BIN, **jkw)
    t, tp_ = torch_estep(t64(C), t64(d), t64(tau), t64(ds.Y), ds.T, BIN, **tkw)
    return (j, float(jp)), (t, float(tp_))


# Tolerances. Each Newton direction is an f32 solve with ONE f64 refinement
# step, so it carries ~(kappa(H) eps32)^2 ~ 1e-7 relative error (kappa(H)
# ~ 1e4 here: the eps = 1e-3 jitter bounds the prior's conditioning, not the
# timescale); times the size of the last steps, the two packages' modes
# agree to ~1e-9 and the objectives, flat at the mode, to ~1e-13. The
# covariance comes from the last factor plus ONE f64 Newton-Schulz step,
# which leaves ~(kappa eps32)^2 ~ 1e-7..1e-6 of the exact inverse in each
# package (more with a neuron masked out), and their f32 factors differ.
MODE_TOL, OBJ_TOL, COV_TOL = 1e-8, 1e-12, 5e-6


def _exact_cov(ds, C, d, tau, X):
    """Dense f64 inverse of the Laplace Hessian at the modes ``X``."""
    from pgpfa_torch.models.params import rbf_kernel
    from pgpfa_torch.models.poisson_gpfa import hessian_weights, linear_predictor
    from pgpfa_torch.ops.blockmat import assemble_hessian

    Kinv = np.linalg.inv(npy(rbf_kernel(t64(tau), ds.T, BIN)))
    W = hessian_weights(t64(C), torch.exp(linear_predictor(t64(C), t64(d), X)))
    return np.linalg.inv(npy(assemble_hessian(W, t64(Kinv))))


@pytest.mark.parametrize("tau", [None, [0.05, 0.2]], ids=["init_tau", "fixed_tau"])
def test_estep_matches_jax(problem, tau):
    """Cold solve: modes, objectives, post_loglik, Newton counts (exactly)
    and the covariance views."""
    ds, init = problem
    tau = init["tau"] if tau is None else np.asarray(tau)
    (j, jp), (t, tp_) = _both(ds, init["C"], init["d"], tau)
    assert rel_err(t.post_mean, j.post_mean) < MODE_TOL
    assert rel_err(t.trial_obj, j.trial_obj) < OBJ_TOL
    assert abs(tp_ - jp) <= OBJ_TOL * abs(jp)
    np.testing.assert_array_equal(npy(t.newton_iters), np.asarray(j.newton_iters))
    assert rel_err(t.post_vsm, j.post_vsm) < COV_TOL
    assert rel_err(t.post_vsm_gp, j.post_vsm_gp) < COV_TOL
    assert rel_err(t.post_cov, j.post_cov) < COV_TOL
    exact = _exact_cov(ds, init["C"], init["d"], tau, t.post_mean)
    assert rel_err(t.post_cov, exact) < COV_TOL
    assert rel_err(j.post_cov, exact) < COV_TOL
    assert t.post_mean.shape == (ds.numTrials, 2, ds.T)
    assert t.post_vsm.shape == (ds.numTrials, ds.T, 2, 2)
    assert t.post_vsm_gp.shape == (ds.numTrials, 2, ds.T, ds.T)


def test_estep_warm_start_and_neuron_weights(problem):
    """Warm start from perturbed modes with one neuron masked out (the
    leave-one-out form): same tolerances as the cold solve."""
    ds, init = problem
    (j0, _), _ = _both(ds, init["C"], init["d"], init["tau"])
    rng = np.random.default_rng(0)
    x0 = np.asarray(j0.post_mean) + 0.05 * rng.normal(size=j0.post_mean.shape)
    w = np.ones(ds.ydim)
    w[3] = 0.0
    (j, jp), (t, tp_) = _both(ds, init["C"], init["d"], init["tau"], x_init=x0, weights=w)
    assert rel_err(t.post_mean, j.post_mean) < MODE_TOL
    assert abs(tp_ - jp) <= OBJ_TOL * abs(jp)
    np.testing.assert_array_equal(npy(t.newton_iters), np.asarray(j.newton_iters))
    assert rel_err(t.post_vsm, j.post_vsm) < COV_TOL


def test_compute_cov_false_drops_cov(problem):
    ds, init = problem
    res, _ = torch_estep(t64(init["C"]), t64(init["d"]), t64(init["tau"]), t64(ds.Y), ds.T,
                         BIN, compute_cov=False)
    assert res.post_cov is None


def test_newton_maxiter_freezes_lanes(problem):
    """With maxiter = 1 every lane stops after one step and reports it."""
    ds, init = problem
    res, _ = torch_estep(t64(init["C"]), t64(init["d"]), t64(init["tau"]), t64(ds.Y), ds.T,
                         BIN, maxiter=1)
    assert npy(res.newton_iters).tolist() == [1] * ds.numTrials


def test_newton_solve_rejects_f32(problem):
    """The f32 fast mode of the Newton solve runs (it was refused before the
    port had it; tests/test_torch_f32.py holds it against the JAX package):
    finite f32 modes and objectives."""
    ds, init = problem
    X0 = torch.zeros(ds.numTrials, 2, ds.T)
    X, f, it, W, L32 = _newton_solve(
        t64(ds.Y).float(), X0, t64(init["C"]).float(), t64(init["d"]).float(),
        torch.eye(ds.T).expand(2, ds.T, ds.T), torch.ones(ds.ydim), 1e-8, 10)
    assert X.dtype == f.dtype == W.dtype == L32.dtype == torch.float32
    assert bool(torch.isfinite(X).all() and torch.isfinite(f).all())
    assert int(it.min()) >= 1
