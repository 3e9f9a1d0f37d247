"""``pgpfa_torch.PPGPFAfit`` against ``pgpfa.PPGPFAfit`` (f64, CPU) on the
same NumPy dataset and init: the batch Laplace and dual-Newton variational
fits, the post-processing attributes, the reference ``infRes`` layout, the
online driver against ``fit_loop``, the plots, the dataset statistics and
the batching helpers."""

import copy
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import pgpfa
from pgpfa.data.batching import seen_trials as jax_seen, subsample_trials as jax_subsample
from pgpfa.em.fit import FitConfig as JaxFitConfig
from pgpfa.em.fit import fit_loop as jax_fit_loop
import pgpfa_torch
from pgpfa_torch import FitConfig, PPGPFAfit
from torch_helpers import npy, rel_err, small_problem

N_ITER = 3
BIN = 10
# online EM, as tests/test_torch_online.py: iteration 0 to 1e-9 relative,
# later post_loglik 1e-6, parameters 2e-5
PLL0_REL, PLL_TOL, PARAM_TOL = 1e-9, 1e-6, 2e-5


@pytest.fixture(scope="module")
def problem():
    return small_problem()


@pytest.fixture(scope="module")
def batch(problem):
    """A 3-iteration batch Laplace fit in each package, with the leave-one-
    out predictions, the re-inferred trajectories and those at the true
    parameters."""
    ds, init = problem
    kw = dict(maxEMiter=N_ITER, extractAllTraj=True, extractAllTraj_trueParams=True)
    j = pgpfa.PPGPFAfit(ds, init, **kw)
    t = PPGPFAfit(ds, init, getPredictionErr=True, device="cpu", **kw)
    return j, t


def test_batch_laplace_matches_jax(batch):
    """Iteration 1's nPLL to 1e-9 relative (identical inputs); later
    iterations within the EM chaos envelope of tests/test_torch_fit.py
    (1e-6 * 5^(n-1)); tau to 1e-5 relative; the true-parameter E-step, a
    cold E-step at identical inputs, to 1e-9."""
    j, t = batch
    pj, pt = np.asarray(j.posteriorLikelihood), np.asarray(t.posteriorLikelihood)
    assert pt.shape == (N_ITER,) and abs(pt[0] - pj[0]) <= 1e-9 * abs(pj[0])
    for n in range(1, N_ITER):
        assert abs(pt[n] - pj[n]) <= 1e-6 * 5.0 ** (n - 1), (n, pt[n] - pj[n])
    np.testing.assert_allclose(t.optimParams["tau"], j.optimParams["tau"], rtol=1e-5)
    assert np.all(np.diff(pt) > 0)
    assert abs(t.nll_trueParams_all_traj - j.nll_trueParams_all_traj) <= \
        1e-9 * abs(j.nll_trueParams_all_traj)
    assert abs(t.nll_all_traj - j.nll_all_traj) <= 1e-6 * 5.0 ** (N_ITER - 1)
    assert t.variationalLowerBound == [] and t.EMmode == "Batch"
    assert len(t.paramSeq) == N_ITER + 1 and len(t.learningDetails) == N_ITER
    assert t.inferenceTime.shape == t.learningTime.shape == (N_ITER,)
    assert np.all(t.inferenceTime > 0) and np.all(t.learningTime > 0)
    assert t.learningDetails[0].keys() == j.learningDetails[0].keys()
    np.testing.assert_array_equal(t.learningDetails[0]["inference_newton_iters"],
                                  j.learningDetails[0]["inference_newton_iters"])
    assert t.y_pred_mode.shape == t._Y.shape and np.isfinite(t.pred_err_mode)


def test_variational_matches_jax(problem):
    """Dual-Newton variational, the solver named on both sides through
    ``config``: iteration 1's nPLL and bound within 1e-8, iteration 2
    within the chaos envelope (tests/test_torch_variational.py)."""
    ds, init = problem
    kw = dict(inference_method="variational", vi_solver="newton", max_em_iter=2)
    j = pgpfa.PPGPFAfit(ds, init, config=JaxFitConfig(**kw))
    t = PPGPFAfit(ds, init, config=FitConfig(**kw), device="cpu")
    assert t.inferenceMethod == "variational" and len(t.variationalLowerBound) == 2
    for name in ("posteriorLikelihood", "variationalLowerBound"):
        a, b = np.asarray(getattr(t, name)), np.asarray(getattr(j, name))
        assert abs(a[0] - b[0]) <= 1e-8 and abs(a[1] - b[1]) <= 1e-6, (name, a - b)
    np.testing.assert_allclose(t.optimParams["tau"], j.optimParams["tau"], rtol=1e-5)


_POST = ("tauSeq", "expectedSpikeCountsEst", "expectedSpikeCountsEstVar",
         "sampleMeanSpikeCounts", "sampleMeanSpikeCountsVar",
         "meanSquaredErrorOverTrueVariance_SM", "varESpkCountSampleMean_Ratios",
         "expectedSpikeCountsTrue", "expectedSpikeCountsTrueVar", "varESpkCountTrue_Ratios",
         "subspaceAngleC", "CabsoluteValue",
         "E_y_init_params", "E_yy_init_params", "E_y_optim_params", "E_yy_optim_params",
         "E_y_obs", "E_yy_obs", "mean_err_optim_obs", "mean_err_init_obs",
         "cov_err_optim_obs", "cov_err_init_obs", "JSdiv_cov_optim_obs", "JSdiv_cov_init_obs",
         "E_y_true_params", "E_yy_true_params", "mean_err_optim_true", "mean_err_init_true",
         "cov_err_optim_true", "cov_err_init_true", "JSdiv_cov_optim_true",
         "JSdiv_cov_init_true")


@pytest.mark.parametrize("name", _POST)
def test_post_processing_from_jax_params(batch, name):
    """The port's post-processing on JAX's own ``paramSeq`` and
    ``optimParams`` equals JAX's attributes to 1e-12."""
    j, t = batch
    t = copy.copy(t)
    t.paramSeq, t.optimParams = j.paramSeq, j.optimParams
    t.processParamResults()
    t.performSpikeCountAnalysis()
    assert rel_err(np.asarray(getattr(t, name)), np.asarray(getattr(j, name))) <= 1e-12


def test_inf_res_layout(batch):
    """``infRes`` is the reference's per-trial NumPy lists, ``post_vsmGP``
    as ``(T, T, xdim)``; ``_inf`` stays the port's tensors."""
    j, t = batch
    R, xdim, T = t.numTrials, t.xdim, t.T
    for res in (t.infRes, t.infRes_trueParams):
        assert res.keys() == j.infRes.keys() and res["post_cov"] is None
        for key, shape in (("post_mean", (xdim, T)), ("post_vsm", (T, xdim, xdim)),
                           ("post_vsmGP", (T, T, xdim))):
            assert len(res[key]) == R and all(a.shape == shape for a in res[key])
            assert all(isinstance(a, np.ndarray) for a in res[key])
    assert isinstance(t._inf.post_mean, torch.Tensor)
    np.testing.assert_array_equal(t.infRes["post_vsmGP"][1][:, :, 0],
                                  npy(t._inf.post_vsm_gp[1, 0]))
    np.testing.assert_array_equal(t.infRes["post_mean"][2], npy(t._inf.post_mean[2]))


@pytest.fixture(scope="module")
def online(problem):
    """Online 'diag' at batch 2: the class, the port's fit_loop on the same
    seed, and JAX's fit_loop on the class's recorded stream."""
    ds, init = problem
    t = PPGPFAfit(ds, init, EMmode="Online", batchSize=2, maxEMiter=N_ITER, seed=3,
                  device="cpu")
    cfg = dict(em_mode="online", batch_size=2, max_em_iter=N_ITER)
    r = pgpfa_torch.fit_loop(init, ds.Y, BIN, FitConfig(**cfg), device="cpu", seed=3)
    j = jax_fit_loop(init, ds.Y, BIN, JaxFitConfig(**cfg), batch_indices=t.seenTrialIdx)
    return t, r, j


def test_online_equals_fit_loop(online):
    """The class draws the stream of ``draw_batch_indices`` with its seed
    and runs fit_loop's steps: the same numbers bit for bit."""
    t, r, _ = online
    idx = pgpfa_torch.draw_batch_indices(t.numTrials, 2, N_ITER, 3)
    np.testing.assert_array_equal(np.stack(t.seenTrialIdx), npy(idx))
    np.testing.assert_array_equal(t.posteriorLikelihood, npy(r.post_loglik))
    for n in range(N_ITER):
        for k, seq in (("C", r.C_seq), ("d", r.d_seq), ("tau", r.tau_seq)):
            np.testing.assert_array_equal(t.paramSeq[n + 1][k], npy(seq[n]))
    assert t.EMmode == "Online" and t._inf.post_mean.shape[0] == 2


def test_online_matches_jax_on_its_stream(online):
    t, _, j = online
    pt, pj = np.asarray(t.posteriorLikelihood), np.asarray(j.post_loglik)
    assert abs(pt[0] - pj[0]) <= PLL0_REL * abs(pj[0])
    np.testing.assert_allclose(pt, pj, rtol=0, atol=PLL_TOL)
    for n in range(N_ITER):
        for k, seq in (("C", j.C_seq), ("d", j.d_seq), ("tau", j.tau_seq)):
            np.testing.assert_allclose(t.paramSeq[n + 1][k], np.asarray(seq[n]), rtol=0,
                                       atol=PARAM_TOL)


def test_reference_only_options_warn(problem):
    """The reference's optimizer options warn, naming the port only."""
    ds, init = problem
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        PPGPFAfit(ds, init, maxEMiter=1, CdOptimMethod="L-BFGS-B", tauOptimMethod="BFGS",
                  hessTol=1e-4, device="cpu")
        PPGPFAfit(ds, init, maxEMiter=1, inferenceMethod="variational", device="cpu")
    msgs = [str(x.message) for x in w]
    assert len(msgs) == 4 and all("pgpfa_torch" in m and "pgpfa." not in m for m in msgs)


def test_verbose_banner(problem, capsys):
    ds, init = problem
    PPGPFAfit(ds, init, maxEMiter=1, EMmode="Online", batchSize=2, verbose=True, device="cpu")
    out = capsys.readouterr().out
    assert "Fit Options" in out and "`diag`" in out and "Iteration:   1 of   1" in out


def test_plotting_smoke(batch, problem):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _, t = batch
    ds, _ = problem
    t = copy.copy(t)
    for name in ("plotTrajectory", "plotTrajectories", "plotParamSeq", "plotFitDetails",
                 "plotOptimParams", "plotParamComparison", "plotCovAnalysis",
                 "plotLNOprediction"):
        assert getattr(t, name)() is not None, name
    t.orthonormalizeTrajectories()
    assert t.x_tilde.shape == (t.numTrials, t.xdim, t.T)
    for fig in (ds.plotTrajectory(), ds.plotParams(), ds.plotMeanVsVariance()):
        assert fig is not None
    plt.close("all")


def test_dataset_statistics_match_jax():
    """The port's dataset computes the JAX package's statistics (numpy
    backend: the same counts)."""
    kw = dict(xdim=2, ydim=12, numTrials=5, trialDur=400, binSize=20, seed=11)
    t, j = pgpfa_torch.dataset(**kw), pgpfa.dataset(backend="numpy", **kw)
    np.testing.assert_array_equal(t.Y, j.Y)
    for name in ("avgFR", "totalSpkCt", "all_raster", "means", "variances"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    np.testing.assert_allclose(t.curve_p, j.curve_p, rtol=1e-12)
    np.testing.assert_array_equal(t.getAvgFiringRate(), j.getAvgFiringRate())


def test_batching_helpers_match_jax(problem):
    ds, _ = problem
    t = pgpfa_torch.subsample_trials(ds, 3, rng=np.random.default_rng(5))
    j = jax_subsample(ds, 3, rng=np.random.default_rng(5))
    np.testing.assert_array_equal(t.batchTrIdx, j.batchTrIdx)
    np.testing.assert_array_equal(t.Y, j.Y)
    assert t.numTrials == 3 and len(t.data) == 3 and len(set(t.batchTrIdx)) == 3
    s, sj = pgpfa_torch.seenTrials(ds, [0, 2, 2]), jax_seen(ds, [0, 2, 2])
    assert s.numTrials == sj.numTrials == 3
    np.testing.assert_array_equal(s.Y, sj.Y)


def test_import_leaves_out_jax_and_matplotlib():
    code = ("import sys, pgpfa_torch; bad = [m for m in ('jax', 'matplotlib', 'pgpfa') "
            "if m in sys.modules]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=str(Path(__file__).resolve().parents[1]))
