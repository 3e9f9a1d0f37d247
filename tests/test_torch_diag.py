"""The port's diagnostics against the JAX package's on the same NumPy
inputs (f64, CPU): the model's gradient and Hessian, the (C, d) Hessian and
its error bars, the per-lane weights of the Newton solve, leave-one-neuron-out
prediction, the cross-validated sweep and the NumPy metrics."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import pgpfa_torch
from pgpfa.diag import metrics as JM
from pgpfa.diag.crossval import crossValidation as jax_cv
from pgpfa.diag.loo import leave_one_out_prediction as jax_loo
from pgpfa.learn.mstep_obs import cd_hessian as jax_cd_hessian
from pgpfa.models import poisson_gpfa as JP
from pgpfa.models.params import pack_cd as jax_pack_cd
from pgpfa.oracle import oracle_np as O
from pgpfa_torch.diag import metrics as M
from pgpfa_torch.diag.loo import leave_one_out_prediction
from pgpfa_torch.infer.laplace import _newton_solve, laplace_estep_from_arrays
from pgpfa_torch.learn.mstep_obs import cd_hessian
from pgpfa_torch.models import poisson_gpfa as P
from pgpfa_torch.models.params import pack_cd, rbf_kernel
from pgpfa_torch.ops.blockmat import blocks_inv
from torch_helpers import npy, rel_err, requires_cuda, small_problem, t64

BIN = 10


@pytest.fixture(scope="module")
def problem():
    """The small problem (4 trials, 15 neurons, T 40, xdim 2), its true
    parameters, and the port's Laplace moments at them."""
    ds, init = small_problem()
    p = {k: np.asarray(v, dtype=np.float64) for k, v in ds.params.items()}
    inf, _ = laplace_estep_from_arrays(t64(p["C"]), t64(p["d"]), t64(p["tau"]), t64(ds.Y),
                                       ds.T, BIN, compute_cov=False)
    return dict(ds=ds, init=init, p=p, means=npy(inf.post_mean), vsms=npy(inf.post_vsm))


@pytest.fixture(scope="module")
def loo(problem):
    """LOO predictions of both packages at the true parameters."""
    ds, p = problem["ds"], problem["p"]
    return jax_loo(p, ds.Y, BIN), leave_one_out_prediction(p, ds.Y, BIN, device="cpu")


def test_neg_log_posterior_grad_hess_match_jax(problem):
    """The gradient and the dense Hessian at random latents, trial by
    trial against the JAX package's one-trial functions and the NumPy
    oracle's dense-Kronecker ones on the same ``K^{-1}``, to 1e-12."""
    ds, p = problem["ds"], problem["p"]
    X = np.random.default_rng(0).normal(size=(ds.numTrials, 2, ds.T)) * 0.5
    Kinv = blocks_inv(rbf_kernel(t64(p["tau"]), ds.T, BIN))
    args = (t64(ds.Y), t64(p["C"]), t64(p["d"]), Kinv)
    G = P.neg_log_posterior_grad(t64(X), *args)
    H = P.neg_log_posterior_hess(t64(X), *args)
    assert G.shape == (ds.numTrials, 2, ds.T) and H.shape == (ds.numTrials, 2 * ds.T, 2 * ds.T)
    jargs = (jnp.asarray(p["C"]), jnp.asarray(p["d"]), jnp.asarray(npy(Kinv)))
    for r in range(ds.numTrials):
        Gj = JP.neg_log_posterior_grad(jnp.asarray(X[r]), jnp.asarray(ds.Y[r]), *jargs)
        Hj = JP.neg_log_posterior_hess(jnp.asarray(X[r]), jnp.asarray(ds.Y[r]), *jargs)
        assert rel_err(G[r], Gj) <= 1e-12 and rel_err(H[r], Hj) <= 1e-12
        Cb, db = O.cd_big(p["C"], p["d"], ds.T)
        dense = (X[r].reshape(-1), ds.Y[r].reshape(-1), Cb, db, sla.block_diag(*npy(Kinv)))
        assert rel_err(G[r].reshape(-1), O.nlp_grad(*dense)) <= 1e-12
        assert rel_err(H[r], O.nlp_hess(*dense)) <= 1e-12


def test_cd_hessian_matches_jax_hessian(problem):
    """The scattered per-neuron blocks equal JAX's ``jax.hessian`` of the
    cost to 1e-10 and the NumPy oracle's per-neuron loop to 1e-12, and the
    scatter puts nothing outside the blocks."""
    ds, p = problem["ds"], problem["p"]
    args = (ds.Y, problem["means"], problem["vsms"])
    H = cd_hessian(pack_cd(t64(p["C"]), t64(p["d"])), *map(t64, args))
    Hj = jax_cd_hessian(jax_pack_cd(jnp.asarray(p["C"]), jnp.asarray(p["d"])),
                        *map(jnp.asarray, args))
    assert H.shape == ((2 + 1) * ds.ydim,) * 2
    assert rel_err(H, Hj) <= 1e-10
    assert rel_err(H, O.cd_hessian(O.pack_cd(p["C"], p["d"]), *args)) <= 1e-12
    idx = torch.arange(H.shape[0]) % ds.ydim  # the neuron of each packed entry
    assert not H[idx[:, None] != idx[None, :]].any()


def test_cd_error_bars_match_jax(problem):
    ds, p = problem["ds"], problem["p"]
    args = (ds.Y, problem["means"], problem["vsms"])
    eb = M.cd_error_bars(p, *args, device="cpu")
    ej = JM.cd_error_bars(p, *args)
    assert eb.shape == ej.shape == ((2 + 1) * ds.ydim,)
    assert rel_err(eb, ej) <= 1e-8


def test_newton_solve_per_lane_weights_bit_equal(problem):
    """``(R, ydim)`` all-ones weights give bit for bit the ``(ydim,)``
    call's result: the shared-weight path is unchanged."""
    ds, p = problem["ds"], problem["p"]
    R, ydim, T = ds.Y.shape
    Kinv = blocks_inv(rbf_kernel(t64(p["tau"]), T, BIN))
    X0 = torch.zeros(R, 2, T, dtype=torch.float64)
    args = (t64(ds.Y), X0, t64(p["C"]), t64(p["d"]), Kinv)
    one = _newton_solve(*args, torch.ones(ydim, dtype=torch.float64), 1e-8, 100)
    per = _newton_solve(*args, torch.ones(R, ydim, dtype=torch.float64), 1e-8, 100)
    for a, b in zip(one, per):
        assert torch.equal(a, b)


@pytest.mark.parametrize("lane", [(0, 0), (2, 7), (3, 14)])
def test_loo_lane_equals_deleted_row(problem, loo, lane):
    """The reference's semantics: a lane's prediction is the Newton mode
    with the neuron's row deleted from C, d and Y, mapped through the
    neuron's own row, to 1e-9 relative."""
    ds, p = problem["ds"], problem["p"]
    r, n = lane
    keep = np.arange(ds.ydim) != n
    Kinv = blocks_inv(rbf_kernel(t64(p["tau"]), ds.T, BIN))
    X = _newton_solve(t64(ds.Y[r:r + 1, keep]), torch.zeros(1, 2, ds.T, dtype=torch.float64),
                      t64(p["C"][keep]), t64(p["d"][keep]), Kinv,
                      torch.ones(ds.ydim - 1, dtype=torch.float64), 1e-8, 100)[0][0]
    want = np.exp(p["C"][n] @ npy(X) + p["d"][n])
    assert rel_err(loo[1][0][r, n], want) <= 1e-9


def test_loo_matches_jax(problem, loo):
    """Predictions to 1e-7 relative and the summed error to 1e-8: both
    solve the same masked objectives to the same gtol and decrement, so they
    differ by the f32 factors' rounding the f64 refinement leaves."""
    (pj, ej), (pt, et) = loo
    assert pt.shape == pj.shape == problem["ds"].Y.shape
    assert rel_err(pt, pj) <= 1e-7
    assert abs(et - ej) <= 1e-8 * abs(ej)


def test_loo_chunking_does_not_change_the_result(problem, loo):
    """Lanes are independent: chunks of 7 lanes (60 lanes, a ragged last
    chunk) give the one-chunk result to 1e-12."""
    ds, p = problem["ds"], problem["p"]
    pt, et = leave_one_out_prediction(p, ds.Y, BIN, device="cpu", _lanes_per_chunk=7)
    assert rel_err(pt, loo[1][0]) <= 1e-12
    assert abs(et - loo[1][1]) <= 1e-12 * abs(loo[1][1])


@pytest.fixture(scope="module")
def cvs(problem):
    """The JAX sweep and the port's padded and unpadded sweeps on one split
    (2 training and 2 test trials, xdim 1..3, 2 EM iterations)."""
    ds = problem["ds"]
    kw = dict(numTrainingTrials=2, numTestTrials=2, maxXdim=3, maxEMiter=2)
    return (jax_cv(ds, **kw), pgpfa_torch.crossValidation(ds, device="cpu", **kw),
            pgpfa_torch.crossValidation(ds, device="cpu", pad_xdim=False, **kw))


def test_cross_validation_matches_jax(cvs):
    """The errors to 1e-5 relative (the EM chaos envelope after two
    iterations) and the same optimXdim."""
    j, t, _ = cvs
    assert len(t.errs) == 3 and all(np.isfinite(t.errs))
    np.testing.assert_allclose(t.errs, j.errs, rtol=1e-5)
    assert t.optimXdim == j.optimXdim


def test_cross_validation_padded_equals_unpadded(cvs, problem):
    """The zero-column embedding is exact: padded errors equal the
    unpadded to 1e-8. The stripped fits' C agree to 1e-7 absolute, not to
    the JAX test's 1e-8: the CPU's f32 factor of a wider Hessian blocks the
    first latent's columns differently (the f64 refinement leaves ~1e-10 of
    that), and the (C, d) Newton's accept test then ties on cost rounding
    (cd_niter 6 against 7 here), leaving the size of a last step, 2.7e-8 at
    most (ROADMAP, queue 3)."""
    _, pad, raw = cvs
    np.testing.assert_allclose(pad.errs, raw.errs, rtol=1e-8)
    assert pad.optimXdim == raw.optimXdim
    for k, (fp, fr) in enumerate(zip(pad.fits, raw.fits), start=1):
        assert fp.C.shape == (problem["ds"].ydim, k) and fp.tau_seq.shape == (2, k)
        np.testing.assert_allclose(npy(fp.C), npy(fr.C), rtol=0, atol=1e-7)


def test_split_train_test(problem):
    ds = problem["ds"]
    train, test = pgpfa_torch.split_train_test(ds, 3, 1)
    assert train.numTrials == 3 and test.numTrials == 1
    np.testing.assert_array_equal(test.Y, ds.Y[3:4])
    with pytest.raises(ValueError):
        pgpfa_torch.split_train_test(ds, 3, 2)


def test_metrics_match_jax(problem):
    """The NumPy metrics equal the JAX package's to 1e-12."""
    ds, p = problem["ds"], problem["p"]
    rng = np.random.default_rng(1)
    C2 = p["C"] + 0.1 * rng.normal(size=p["C"].shape)
    assert abs(M.subspace_angle(p["C"], C2) - JM.subspace_angle(p["C"], C2)) <= 1e-12
    for a, b in zip(M.mean_cov_y_from_params(p), JM.mean_cov_y_from_params(p)):
        assert rel_err(a, b) <= 1e-12
    S1, S2 = M.mean_cov_y_from_params(p)[1], M.mean_cov_y_from_params({"C": C2, "d": p["d"]})[1]
    assert rel_err(M.js_logdet_div(S1, S2), JM.js_logdet_div(S1, S2)) <= 1e-12
    x, mean = rng.normal(size=ds.ydim), rng.normal(size=ds.ydim)
    assert rel_err(M.mvnpdf(x, mean, S1), JM.mvnpdf(x, mean, S1)) <= 1e-12
    P1 = np.linalg.inv(S1)
    assert rel_err(M.mvnpdf_use_inv_cov(x, mean, P1), JM.mvnpdf_use_inv_cov(x, mean, P1)) <= 1e-12
    assert rel_err(M.orthonormalized_trajectories(p["C"], problem["means"]),
                   JM.orthonormalized_trajectories(p["C"], problem["means"])) <= 1e-12


@pytest.mark.parametrize("entry", ["leave_one_out_prediction", "cd_error_bars",
                                   "crossValidation", "PPGPFAfit"])
def test_entry_points_default_to_the_card(problem, entry):
    """Without ``device`` the diagnostics run on the card: on a CPU-only
    build they raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    ds, p = problem["ds"], problem["p"]
    call = {
        "leave_one_out_prediction": lambda: pgpfa_torch.leave_one_out_prediction(p, ds.Y, BIN),
        "cd_error_bars": lambda: pgpfa_torch.cd_error_bars(p, ds.Y, problem["means"],
                                                           problem["vsms"]),
        "crossValidation": lambda: pgpfa_torch.crossValidation(
            ds, numTrainingTrials=2, numTestTrials=2, maxXdim=1, maxEMiter=1),
        "PPGPFAfit": lambda: pgpfa_torch.PPGPFAfit(ds, problem["init"], maxEMiter=1),
    }[entry]
    with pytest.raises((RuntimeError, AssertionError)):
        call()


@requires_cuda
def test_cuda_loo_and_error_bars_match_cpu(problem, loo):
    """On the card (chol32 and ns_step launched) against the CPU: the
    predictions to 1e-8 relative, the error bars to 1e-8."""
    from pgpfa_torch.ops.cuda_kernels import chol32, ns_step

    ds, p = problem["ds"], problem["p"]
    chol32.launches = ns_step.launches = 0
    pg, eg = leave_one_out_prediction(p, ds.Y, BIN, device="cuda")
    assert chol32.launches > 0 and ns_step.launches > 0
    assert rel_err(pg, loo[1][0]) <= 1e-8 and abs(eg - loo[1][1]) <= 1e-8 * abs(loo[1][1])
    args = (ds.Y, problem["means"], problem["vsms"])
    assert rel_err(M.cd_error_bars(p, *args, device="cuda"),
                   M.cd_error_bars(p, *args, device="cpu")) <= 1e-8
