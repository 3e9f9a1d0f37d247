"""The port's reference-compatible shims (``pgpfa_torch.compat``), every test
of ``tests/test_compat.py`` through them with ``device="cpu"``, and their
values held to the JAX package's ``pgpfa.compat`` on the same inputs,
recorded in ``tests/torch_compat_reference.npz``
(``python tests/torch_compat_reference.py``); nothing here runs JAX.

Tolerances: the dense NumPy objectives at fixed inputs (the port's copies of
``pgpfa/oracle/oracle_np.py``, given the JAX run's own ``infRes``) to 1e-12
relative. E-steps as ``tests/test_torch_laplace.py`` holds them (modes 1e-8,
nPLL 1e-12 relative, covariances 5e-6) and the dual as
``tests/test_torch_variational.py`` does (bound and nPLL 1e-7, means 1e-5);
M-step parameters 2e-5 and costs 1e-6 as ``tests/test_torch_online.py``;
their curvature matrices 1e-6 relative (the covariances they are built from
agree to ~3e-9). The class fit as ``tests/test_torch_fit.py``: iteration 1
1e-9 relative, later iterations 1e-6, parameters 2e-5. The bounded-lambda
dual is host NumPy and SciPy in both packages; only the prior's rounding
differs (the port's kernel from torch), so its nPLL and bound are held to
1e-9 relative and its means and lambdas to 1e-7.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_compat_reference import compat_inputs, compat_problem, load
from torch_helpers import rel_err

REF = load()
CPU = dict(device="cpu")
XDIM, YDIM = 2, 10
DENSE_REL = 1e-12
MODE_TOL, OBJ_TOL, COV_TOL = 1e-8, 1e-12, 5e-6
BOUND_TOL, MEAN_TOL = 1e-7, 1e-5
PLL_TOL, PARAM_TOL, COST_TOL, CURV_REL = 1e-6, 2e-5, 1e-6, 1e-6
BOUNDED_REL, BOUNDED_MEAN_REL = 1e-9, 1e-7


@pytest.fixture(scope="module")
def setup():
    return compat_problem()


@pytest.fixture(scope="module")
def jax_res():
    """The JAX run's Laplace ``infRes`` at the init, as the reference's
    dict of lists."""
    return {k: list(REF["laplace_" + k]) for k in ("post_mean", "post_vsm", "post_vsmGP")}


def _params_close(new, prefix):
    for k in ("C", "d", "tau"):
        np.testing.assert_allclose(new[k], REF[f"{prefix}_{k}"], rtol=0, atol=PARAM_TOL)


def test_reference_workflow(setup):
    """The reference example.py workflow through the compat modules, held to
    the JAX package's engine.PPGPFAfit."""
    from pgpfa_torch.compat import engine

    train, init = setup
    fit = engine.PPGPFAfit(experiment=train, initParams=init, inferenceMethod="laplace",
                           EMmode="Batch", maxEMiter=3, **CPU)
    assert len(fit.posteriorLikelihood) == 3
    assert fit.optimParams["C"].shape == (10, 2)
    assert "post_vsmGP" in fit.infRes
    assert fit.infRes["post_vsmGP"][0].shape == (train.T, train.T, 2)
    pll, want = np.asarray(fit.posteriorLikelihood), REF["fit_pll"]
    assert abs(pll[0] - want[0]) <= 1e-9 * abs(want[0])
    np.testing.assert_allclose(pll, want, rtol=0, atol=PLL_TOL)
    _params_close(fit.optimParams, "fit")


def test_full_reference_kwarg_signature(setup):
    """A verbatim reference call passing every engine kwarg, including the
    six that only matter to scipy optimizers, is accepted; the scipy-specific
    ones are mapped or warned, never TypeErrors."""
    import warnings

    from pgpfa_torch.compat import engine

    train, init = setup
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fit = engine.PPGPFAfit(
            experiment=train, initParams=init, xdim=2, inferenceMethod="laplace", maxEMiter=2,
            optimLogLamb=True, CdOptimMethod="BFGS", tauOptimMethod="BFGS", verbose=False,
            EMmode="Online", batchSize=3, onlineParamUpdateMethod="diag", hessTol=1e-4,
            stepPow=0.75, updateCdJointly=True, fullyUpdateTau=False, extractAllTraj=False,
            extractAllTraj_trueParams=False, getPredictionErr=False, CdMaxIter=100,
            tauMaxIter=100, **CPU)
    assert len(fit.posteriorLikelihood) == 2
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        engine.PPGPFAfit(experiment=train, initParams=init, maxEMiter=1, EMmode="Batch",
                         CdOptimMethod="BFGS", **CPU)
    assert any("CdOptimMethod" in str(w.message) for w in rec)
    fit3 = engine.PPGPFAfit(experiment=train, initParams=init, maxEMiter=1, EMmode="Batch",
                            CdMaxIter=2, tauMaxIter=2, **CPU)
    assert fit3.config.cd_newton_iters == 2
    assert fit3.config.tau_maxiter == 2


def test_inference_shim(setup):
    """laplace (cold and warm) and the rho-space dual against JAX's."""
    from pgpfa_torch.compat import inference

    train, init = setup
    res, pll, modes = inference.laplace(train, init, **CPU)
    assert len(res["post_mean"]) == train.numTrials
    assert res["post_mean"][0].shape == (2, train.T)
    assert np.isfinite(pll)
    assert rel_err(np.stack(res["post_mean"]), REF["laplace_post_mean"]) < MODE_TOL
    assert abs(pll - REF["laplace_pll"]) <= OBJ_TOL * abs(REF["laplace_pll"])
    for k in ("post_vsm", "post_vsmGP"):
        assert rel_err(np.stack(res[k]), REF["laplace_" + k]) < COV_TOL, k
    res2, pll2, _ = inference.laplace(train, init, prevOptimRes=modes, **CPU)
    np.testing.assert_allclose(pll2, pll, atol=1e-8)
    assert abs(pll2 - REF["laplace_warm_pll"]) <= OBJ_TOL * abs(REF["laplace_warm_pll"])

    vres, vpll, vlb, rhos = inference.dualVariational(train, init, optimizeLogLambda=True, **CPU)
    assert np.isfinite(vlb)
    assert len(rhos) == train.numTrials
    assert abs(vlb - REF["vi_vlb"]) <= BOUND_TOL and abs(vpll - REF["vi_pll"]) <= BOUND_TOL
    np.testing.assert_allclose(np.stack(vres["post_mean"]), REF["vi_post_mean"], rtol=0,
                               atol=MEAN_TOL)


def test_learning_shim(setup):
    """updateParams and makePrecomp against JAX's on the port's own E-step."""
    from pgpfa_torch.compat import inference, learning

    train, init = setup
    res, pll, _ = inference.laplace(train, init, **CPU)
    new_params, details = learning.updateParams(init, res, train, **CPU)
    assert new_params["C"].shape == (10, 2)
    assert np.isfinite(details["Cd"])
    _params_close(new_params, "update")
    assert abs(details["Cd"] - REF["update_cd_cost"]) <= COST_TOL
    np.testing.assert_allclose(details["tau"], REF["update_tau_cost"], rtol=0, atol=COST_TOL)
    pre = learning.makePrecomp(res, **CPU)
    assert len(pre) == 2 and pre[0]["PautoSum"].shape == (train.T, train.T)
    assert rel_err(np.stack([q["PautoSum"] for q in pre]), REF["pauto"]) < COV_TOL


def test_mcmc_shim(setup):
    """The shape of the reference's sample array, and the port's own chain
    on the same seed exactly (its draws are the port's, not jax.random's)."""
    from pgpfa_torch import posterior_mcmc_from_arrays
    from pgpfa_torch.compat import mcmc

    train, init = setup
    samples = mcmc.PosteriorMCMC(train, train.params, 50, trial=0, **CPU)
    assert samples.shape == (50, 2 * train.T)
    assert np.isfinite(samples).all()
    p = train.params
    own = posterior_mcmc_from_arrays(p["C"], np.ravel(p["d"]), np.ravel(p["tau"]),
                                     train.data[0]["Y"], train.T, float(train.binSize),
                                     n_samples=50, seed=0, **CPU)
    np.testing.assert_array_equal(samples, own.samples.reshape(50, -1).numpy())


def test_util_shims(setup):
    """The dense lifts and the packing, against the JAX package's K_big."""
    from pgpfa_torch.compat import util

    train, init = setup
    Cb, db = util.makeCd_big(init, train.T)
    assert Cb.shape == (2 * train.T, 10 * train.T)
    Kb, K = util.makeK_big(init, train.trialDur, train.binSize)
    assert Kb.shape == (2 * train.T, 2 * train.T)
    assert K.shape == (2, train.T, train.T)
    vec = util.CdtoVecCd(init["C"], init["d"])
    C2, d2 = util.vecCdtoCd(vec, 2, 10)
    np.testing.assert_allclose(C2, init["C"])
    np.testing.assert_allclose(d2, init["d"])
    np.testing.assert_array_equal(Cb, REF["C_big"])
    np.testing.assert_array_equal(db, REF["d_big"])
    assert rel_err(Kb, REF["K_big"]) <= DENSE_REL and rel_err(K, REF["K_blocks"]) <= DENSE_REL


def test_objective_surface_shims(setup, jax_res):
    """The reference's public objective trio and dual functions, exercised
    the way reference user code calls them, the grad checks of
    tests/test_compat.py, and every value against the JAX package's at the
    same inputs (1e-12: both sides are the same NumPy)."""
    import scipy.optimize as sopt

    from pgpfa_torch.compat import inference, learning

    train, init = setup
    a = compat_inputs(train, init)
    Cb, db, Kb, Kinv, ybar, x = a["Cb"], a["db"], a["Kb"], a["Kinv"], a["ybar"], a["x"]
    xdim, ydim = XDIM, YDIM

    def same(got, key):
        assert rel_err(got, REF[key]) <= DENSE_REL, key

    same(inference.negLogPosteriorUnNorm(x, ybar, Cb, db, Kinv, xdim, ydim), "nlp")
    same(inference.negLogPosteriorUnNorm_grad(x, ybar, Cb, db, Kinv, xdim, ydim), "nlp_grad")
    H = inference.negLogPosteriorUnNorm_hess(x, ybar, Cb, db, Kinv, xdim, ydim)
    same(H, "nlp_hess")
    g_norm = np.linalg.norm(inference.negLogPosteriorUnNorm_grad(x, ybar, Cb, db, Kinv))
    err = sopt.check_grad(inference.negLogPosteriorUnNorm, inference.negLogPosteriorUnNorm_grad,
                          x, ybar, Cb, db, Kinv, xdim, ydim)
    assert err / g_norm < 1e-6
    g = lambda z: inference.negLogPosteriorUnNorm_grad(z, ybar, Cb, db, Kinv)  # noqa: E731
    e = np.zeros_like(x)
    e[3] = 1e-6
    np.testing.assert_allclose(H[:, 3], (g(x + e) - g(x - e)) / 2e-6, atol=1e-4)

    lam = a["lam"]
    f_lam = inference.dualProblem(lam, ybar, Cb, Kb, Kinv, db)
    np.testing.assert_allclose(f_lam, inference.dualProblemRho(np.log(lam), ybar, Cb, Kb, Kinv,
                                                               db), rtol=1e-12)
    same(f_lam, "dual")
    same(inference.dualProblem_grad(lam, ybar, Cb, Kb, Kinv, db), "dual_grad")
    same(inference.dualProblemRho(np.log(lam), ybar, Cb, Kb, Kinv, db), "dual_rho")
    same(inference.dualProblemRho_grad(np.log(lam), ybar, Cb, Kb, Kinv, db), "dual_rho_grad")
    err = sopt.check_grad(inference.dualProblemRho, inference.dualProblemRho_grad,
                          np.log(lam), ybar, Cb, Kb, Kinv, db)
    assert err < 1e-3
    cov, prec = inference.VIPostCov(Kinv, Cb, lam)
    assert cov.shape == (xdim * train.T, xdim * train.T)
    same(cov, "vi_cov")
    same(prec, "vi_prec")
    same(inference.VIPostMean(Kb, Cb, ybar, lam), "vi_mean")

    res, vecCd, vecC, p0 = jax_res, a["vecCd"], a["vecC"], a["p0"]
    same(learning.MStepObservationCost(vecCd, xdim, ydim, train, res), "mstep_cost")
    same(learning.MStepObservationCost_grad(vecCd, xdim, ydim, train, res), "mstep_cost_grad")
    err = sopt.check_grad(learning.MStepObservationCost, learning.MStepObservationCost_grad,
                          vecCd, xdim, ydim, train, res)
    g_norm = np.linalg.norm(learning.MStepObservationCost_grad(vecCd, xdim, ydim, train, res))
    assert err / max(g_norm, 1.0) < 1e-5
    pre = learning.makePrecomp(res, **CPU)
    same(learning.MStepGPtimescaleCost(p0, pre[0], 0.001), "tau_cost")
    tau_grad = lambda p, q, e: learning.MStepGPtimescaleCost_grad(p, q, e, **CPU)  # noqa: E731
    assert rel_err(tau_grad(p0, pre[0], 0.001), REF["tau_cost_grad"]) < 1e-9
    assert sopt.check_grad(learning.MStepGPtimescaleCost, tau_grad, p0, pre[0], 0.001) < 1e-4
    newC, newd, cost = learning.learnLTparams(init, res, train, "newton", **CPU)
    assert newC.shape == (ydim, xdim) and np.isfinite(cost)
    np.testing.assert_allclose(newC, REF["lt_C"], rtol=0, atol=PARAM_TOL)
    np.testing.assert_allclose(newd, REF["lt_d"], rtol=0, atol=PARAM_TOL)
    assert abs(cost - REF["lt_cost"]) <= COST_TOL
    newTau, _ = learning.learnGPparams(init, res, train, **CPU)
    np.testing.assert_allclose(newTau, REF["gp_tau"], rtol=0, atol=PARAM_TOL)

    invP = -np.eye(len(vecCd))
    f = learning.MStepObservationCostWithPrior(vecCd + 0.1, init, xdim, ydim, train, res, invP)
    f0 = learning.MStepObservationCost(vecCd + 0.1, xdim, ydim, train, res)
    np.testing.assert_allclose(f - f0, 0.5 * 0.1**2 * len(vecCd), rtol=1e-9)
    same(f, "cost_prior")
    gp = learning.MStepObservationCostWithPrior_grad(vecCd + 0.05, init, xdim, ydim, train, res,
                                                     invP)
    same(gp, "cost_prior_grad")
    err = sopt.check_grad(learning.MStepObservationCostWithPrior,
                          learning.MStepObservationCostWithPrior_grad,
                          vecCd + 0.05, init, xdim, ydim, train, res, invP)
    assert err / max(np.linalg.norm(gp), 1.0) < 1e-5
    invPc = -np.eye(len(vecC))
    same(learning.MStep_C_costWithPrior(vecC + 0.05, init, xdim, ydim, train, res, invPc),
         "c_cost_prior")
    gc = learning.MStep_C_costWithPrior_grad(vecC + 0.05, init, xdim, ydim, train, res, invPc)
    same(gc, "c_cost_prior_grad")
    err = sopt.check_grad(learning.MStep_C_costWithPrior, learning.MStep_C_costWithPrior_grad,
                          vecC + 0.05, init, xdim, ydim, train, res, invPc)
    assert err / max(np.linalg.norm(gc), 1.0) < 1e-5
    same(learning.MStepGPtimescaleCostWithPrior(p0, pre[0], 0.001, train.binSize, 0.2, 1.0),
         "tau_cost_prior")


def test_online_driver_shims(setup, jax_res):
    """updateParamsWithPrior and updateParamsWithGradDescent, joint and
    C-only, and the 'useHessian' curvature, against JAX's on the same
    infRes; update_d_closedForm likewise."""
    from pgpfa_torch.compat import learning
    from pgpfa_torch.compat.util import CdtoVecCd

    train, init = setup
    res = jax_res
    for name, kw in (("prior_joint", dict(updateCdJointly=True)),
                     ("prior_conly", dict(updateCdJointly=False)),
                     ("prior_hess", dict(prevInvPriorCov=np.eye(3 * YDIM),
                                         covOpts="useHessian"))):
        new_p, det, P = learning.updateParamsWithPrior(
            init, res, train, regularizer_stepsize_Cd=1.0, regularizer_stepsize_tau=1.0, **kw,
            **CPU)
        assert new_p["C"].shape == init["C"].shape and np.isfinite(det["Cd"])
        assert P.shape[0] == P.shape[1]
        _params_close(new_p, name)
        assert abs(det["Cd"] - REF[name + "_cost"]) <= COST_TOL
        assert rel_err(P, REF[name + "_P"]) < CURV_REL
    assert np.all(np.linalg.eigvalsh(P) > 0)  # accumulated curvature is PD

    for name, joint in (("gd_joint", True), ("gd_conly", False)):
        new_p, det, H = learning.updateParamsWithGradDescent(init, res, train, stepSize=0.5,
                                                             updateCdJointly=joint, **CPU)
        assert np.isfinite(new_p["C"]).all() and np.isfinite(H).all()
        _params_close(new_p, name)
        assert rel_err(H, REF[name + "_H"]) < CURV_REL
        if joint:  # a damped Newton step from the old params must reduce the cost
            c_new = learning.MStepObservationCost(CdtoVecCd(new_p["C"], new_p["d"]), 2, 10,
                                                  train, res)
            c_old = learning.MStepObservationCost(CdtoVecCd(init["C"], init["d"]), 2, 10,
                                                  train, res)
            assert c_new < c_old
    np.testing.assert_allclose(learning.update_d_closedForm(init, res, train, **CPU),
                               REF["d_closed"], rtol=0, atol=PARAM_TOL)


def test_migration_guide_symbols_exist():
    """Every symbol of MIGRATION.md's mapping table resolves on the port."""
    import pgpfa_torch
    from pgpfa_torch.compat import datamanager, engine, inference, learning, mcmc, util

    table = {
        pgpfa_torch: [
            "PPGPFAfit", "dataset", "initializeParams", "subsampleTrials",
            "seenTrials", "crossValidation", "splitTrainingTestDataset",
            "leaveOneOutPrediction", "subspaceAngle", "JSLogdetDiv",
            "getMeanCovYfromParams", "saveVariables", "openVariables",
            "fit_sharded",
        ],
        engine: ["PPGPFAfit"],
        inference: [
            "laplace", "dualVariational", "negLogPosteriorUnNorm",
            "negLogPosteriorUnNorm_grad", "negLogPosteriorUnNorm_hess",
            "dualProblem", "dualProblem_grad", "dualProblemRho",
            "dualProblemRho_grad", "VIPostMean", "VIPostCov",
        ],
        learning: [
            "updateParams", "updateParamsWithPrior",
            "updateParamsWithGradDescent", "MStepObservationCost",
            "MStepObservationCost_grad", "MStepGPtimescaleCost",
            "MStepGPtimescaleCost_grad", "MStepGPtimescaleCostWithPrior",
            "MStepObservationCostWithPrior", "MStepObservationCostWithPrior_grad",
            "MStep_C_costWithPrior", "MStep_C_costWithPrior_grad",
            "makePrecomp", "learnLTparams", "learnGPparams",
            "update_d_closedForm",
        ],
        mcmc: ["PosteriorMCMC"],
        util: [
            "makeK_big", "makeCd_big", "CdtoVecCd", "vecCdtoCd",
            "load_crcns_data", "loadDataForGPFA_CV_comparison",
            "loadDataHighData", "MATLABdataset",
            "getCdErrorBars", "mvnpdf", "mvnpdf_use_inv_cov",
            "approx_jacobian",
        ],
        datamanager: ["StevensonDataset", "MATLABdataset"],
    }
    missing = [f"{mod.__name__}.{name}" for mod, names in table.items() for name in names
               if not hasattr(mod, name)]
    assert not missing, f"symbols missing from the port: {missing}"


def test_cd_error_bars_and_numeric_helpers(setup):
    """getCdErrorBars on the reference infRes format against JAX's;
    approx_jacobian against the exact Jacobian; mvnpdf against scipy."""
    import scipy.stats as st

    from pgpfa_torch.compat import inference, util

    train, init = setup
    params = {"C": init["C"], "d": np.ravel(init["d"]), "tau": np.ravel(init["tau"])}
    infRes, _, _ = inference.laplace(train, params, **CPU)
    errs = util.getCdErrorBars(params, train, infRes, **CPU)
    assert errs.shape == (init["C"].size + np.ravel(init["d"]).size,)
    assert np.all(np.isfinite(errs)) and np.all(errs > 0)
    assert rel_err(errs, REF["error_bars"]) < CURV_REL

    A = np.arange(6.0).reshape(2, 3)

    def f(x):
        return np.array([np.sin(x) @ A[0], np.exp(-x) @ A[1]])

    x0 = np.array([0.3, -0.2, 0.7])
    J = util.approx_jacobian(x0, f, None)
    J_exact = np.stack([A[0] * np.cos(x0), -A[1] * np.exp(-x0)])
    np.testing.assert_allclose(J, J_exact, rtol=1e-7, atol=1e-9)

    rng = np.random.default_rng(3)
    S = rng.normal(size=(4, 4))
    cov = S @ S.T + 4 * np.eye(4)
    mean = rng.normal(size=4)
    x = rng.normal(size=4)
    want = st.multivariate_normal(mean=mean, cov=cov).pdf(x)
    np.testing.assert_allclose(util.mvnpdf(x, mean, cov), want, rtol=1e-10)
    np.testing.assert_allclose(util.mvnpdf_use_inv_cov(x, mean, np.linalg.inv(cov)), want,
                               rtol=1e-9)
    big = np.eye(120) * 1e6
    v = float(util.JSLogdetDiv(big, big * 1.5))
    assert np.isfinite(v) and v > 0


def test_dual_variational_bounded_lambda_path(setup):
    """optimizeLogLambda=False (the reference's default) runs the
    bounded-lambda L-BFGS-B dual on the host: lambdas in the box, the two
    parametrizations agree as in tests/test_compat.py, and the bounded path
    equals JAX's bounded path."""
    from pgpfa_torch.compat import inference

    train, init = setup
    res_b, pll_b, vlb_b, lambdas = inference.dualVariational(train, init,
                                                             optimizeLogLambda=False)
    res_r, pll_r, vlb_r, _ = inference.dualVariational(train, init, optimizeLogLambda=True,
                                                       **CPU)
    assert len(lambdas) == train.numTrials
    for lam in lambdas:
        assert lam.shape == (train.ydim * train.T,)
        assert np.all(lam >= 1e-10)
    assert abs(vlb_b - vlb_r) / (1.0 + abs(vlb_r)) < 1e-5
    assert abs(pll_b - pll_r) / (1.0 + abs(pll_r)) < 1e-5
    assert np.max(np.abs(np.stack(res_b["post_mean"]) - np.stack(res_r["post_mean"]))) < 3e-3
    assert res_b["post_vsmGP"][0].shape == (train.T, train.T, 2)
    assert res_b["post_vsm"][0].shape == (train.T, 2, 2)
    assert abs(pll_b - REF["bounded_pll"]) <= BOUNDED_REL * abs(REF["bounded_pll"])
    assert abs(vlb_b - REF["bounded_vlb"]) <= BOUNDED_REL * abs(REF["bounded_vlb"])
    assert rel_err(np.stack(res_b["post_mean"]), REF["bounded_post_mean"]) < BOUNDED_MEAN_REL
    assert rel_err(np.stack(lambdas), REF["bounded_lambda"]) < BOUNDED_MEAN_REL


def test_import_has_no_jax_pgpfa_or_pandas():
    """Importing the compat package imports neither JAX, nor the JAX
    package, nor pandas; and its entry points default to the card."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, pgpfa_torch.compat; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'pgpfa', 'pandas')))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=repo,
                       timeout=120, check=True)
    assert r.stdout.strip() == "[]", r.stdout
    if not torch.cuda.is_available():
        from pgpfa_torch.compat import inference

        train, init = compat_problem()
        with pytest.raises((AssertionError, RuntimeError)):
            inference.laplace(train, init)
