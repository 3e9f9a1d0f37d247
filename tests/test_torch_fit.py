"""The slice end to end: ``pgpfa_torch.fit`` against ``pgpfa.em.fit.fit``
(batch Laplace EM, f64, CPU) on the same NumPy dataset and init."""

import numpy as np
import pytest
import torch

from pgpfa.em.fit import FitConfig as JaxFitConfig
from pgpfa.em.fit import fit as jax_fit
import pgpfa_torch
from pgpfa_torch import FitConfig, fit, params_from_numpy
from torch_helpers import npy, small_problem

N_ITER = 3
BIN = 10
MONOTONE = 1e-3  # tests/test_torch_f32.py's


@pytest.fixture(scope="module")
def fits():
    """One JAX fit and one port fit per module (the JAX program is the
    expensive part)."""
    ds, init = small_problem()
    j = jax_fit(init, ds.Y, BIN, JaxFitConfig(max_em_iter=N_ITER))
    t = fit(init, ds.Y, BIN, FitConfig(max_em_iter=N_ITER), device="cpu")
    return ds, init, j, t


def test_iteration0_matches(fits):
    """Iteration 0 sees identical inputs: the post_loglik agrees to 1e-9
    relative and the E-step Newton counts exactly. The M-step's per-neuron
    Newton decides its last near-tie steps on cost rounding and the moments
    carry the one-step refinement floor (~1e-7, see test_torch_laplace.py),
    so C, d and tau after iteration 0 agree to 1e-7."""
    _, _, j, t = fits
    pj, pt = np.asarray(j.post_loglik), npy(t.post_loglik)
    assert abs(pt[0] - pj[0]) <= 1e-9 * abs(pj[0])
    np.testing.assert_array_equal(npy(t.newton_iters[0]), np.asarray(j.newton_iters[0]))
    for name in ("C_seq", "d_seq", "tau_seq"):
        np.testing.assert_allclose(npy(getattr(t, name)[0]), np.asarray(getattr(j, name)[0]),
                                   rtol=0, atol=1e-7)


def test_later_iterations_within_chaos_envelope(fits):
    """EM amplifies a perturbation ~4-5x per iteration (PARITY.md, trajectory parity):
    from the 1e-7 parameter difference after iteration 0, iteration n's
    post_loglik may differ by up to 1e-6 * 5^(n-1) (absolute; ~250 here)."""
    _, _, j, t = fits
    pj, pt = np.asarray(j.post_loglik), npy(t.post_loglik)
    for n in range(1, N_ITER):
        assert abs(pt[n] - pj[n]) <= 1e-6 * 5.0 ** (n - 1), (n, pt[n] - pj[n])
    np.testing.assert_allclose(npy(t.tau), np.asarray(j.tau), rtol=1e-5)
    assert np.all(np.diff(pt) > 0), "nPLL must increase"


def test_result_shapes_and_diagnostics(fits):
    ds, _, j, t = fits
    R, xdim, ydim = ds.numTrials, 2, ds.ydim
    assert t.C.shape == (ydim, xdim) and t.d.shape == (ydim,) and t.tau.shape == (xdim,)
    assert t.C_seq.shape == (N_ITER, ydim, xdim) and t.tau_seq.shape == (N_ITER, xdim)
    assert t.post_loglik.shape == t.cd_cost.shape == t.cd_grad_norm.shape == (N_ITER,)
    assert t.tau_cost.shape == t.tau_niter.shape == (N_ITER, xdim)
    assert t.newton_iters.shape == (N_ITER, R)
    assert float(t.var_lower_bound.abs().max()) == 0.0
    np.testing.assert_allclose(npy(t.cd_cost), np.asarray(j.cd_cost), rtol=1e-8)
    assert torch.equal(t.C, t.C_seq[-1])


def test_fit_takes_params_on_their_device(fits):
    """A ``Params`` input runs where its tensors live; one iteration
    reproduces the dict-input run's iteration 0 exactly."""
    ds, init, _, t = fits
    p = params_from_numpy(init, "cpu", torch.float64)
    one = fit(p, torch.as_tensor(ds.Y), BIN, FitConfig(max_em_iter=1))
    assert one.post_loglik.device.type == "cpu" and one.C.device.type == "cpu"
    assert torch.equal(one.post_loglik[0], t.post_loglik[0])
    assert torch.equal(one.tau_seq[0], t.tau_seq[0])


@pytest.mark.parametrize("kw", [
    dict(inference_method="variational", time_block=10), dict(time_block=10),
])
def test_fitconfig_f32_banded_runs(fits, kw):
    """The banded long-trial path (``time_block``) runs in f32 (it raised
    before the port had it): a finite f32 fit whose nPLL (and bound) rises
    to within MONOTONE per iteration (tests/test_torch_f32.py's). The init's
    timescales are cut to 15 ms so that blocks of 10 bins (100 ms) hold the
    prior (``time_block * bin >~ 6 max(tau)``); at the init's 0.42 s the
    banded prior is not positive definite and the fit is NaN in f64 too."""
    ds, init, _, _ = fits
    init = {**init, "tau": np.array([0.015, 0.015])}
    r = fit(init, ds.Y, BIN, FitConfig(max_em_iter=N_ITER, **kw), device="cpu",
            dtype=torch.float32)
    assert r.post_loglik.dtype == r.C.dtype == r.tau.dtype == torch.float32
    for series in (r.post_loglik, r.var_lower_bound):
        assert bool(torch.isfinite(series).all())
        assert np.all(np.diff(npy(series)) > -MONOTONE), npy(series)
    assert bool(torch.isfinite(r.C).all() and (r.tau > 0).all())


@pytest.mark.parametrize("kw", [dict(inference_method="mcmc"), dict(em_mode="minibatch"),
                                dict(vi_solver="auto"), dict(online_update="adam")])
def test_fitconfig_rejects_unknown_values(kw):
    with pytest.raises(ValueError):
        FitConfig(**kw)


def test_fit_rejects_f32(fits):
    """The f32 fast mode runs (it was refused before the port had it): one
    iteration gives finite f32 results. Without a device it goes to the
    card, which on a machine without one raises, as the f64 fit does
    (tests/test_torch_data.py)."""
    ds, init, _, _ = fits
    one = fit(init, ds.Y, BIN, FitConfig(max_em_iter=1), device="cpu", dtype=torch.float32)
    assert one.post_loglik.dtype == one.C.dtype == one.tau.dtype == torch.float32
    assert bool(torch.isfinite(one.post_loglik).all() and torch.isfinite(one.C).all())
    if torch.cuda.is_available():
        return
    with pytest.raises((RuntimeError, AssertionError)):
        fit(init, ds.Y, BIN, FitConfig(max_em_iter=1), dtype=torch.float32)


def test_public_surface():
    for name in ("dataset", "initialize_params", "stevenson_surrogate", "Params", "FitConfig",
                 "FitResult", "fit", "params_from_numpy", "draw_batch_indices",
                 "ONLINE_UPDATE_METHODS", "fit_loop", "posterior_mcmc",
                 "posterior_mcmc_from_arrays", "posterior_mcmc_batched", "ESSResult",
                 "PPGPFAfit", "crossValidation", "split_train_test", "leave_one_out_prediction",
                 "subspace_angle", "js_logdet_div", "mean_cov_y_from_params", "cd_error_bars",
                 "mvnpdf", "mvnpdf_use_inv_cov", "orthonormalized_trajectories",
                 "subsample_trials", "seen_trials", "laplace_estep", "laplace_estep_from_arrays",
                 "pack_cd", "unpack_cd", "leaveOneOutPrediction", "subspaceAngle",
                 "JSLogdetDiv", "getMeanCovYfromParams", "splitTrainingTestDataset",
                 "subsampleTrials", "seenTrials", "initializeParams", "rbf_kernel", "vi_estep",
                 "vi_estep_from_arrays", "save_variables", "open_variables", "save_checkpoint",
                 "load_checkpoint", "fit_sharded"):
        assert hasattr(pgpfa_torch, name)
        assert name in pgpfa_torch.__all__
