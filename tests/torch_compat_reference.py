"""The JAX package's sharded-online and compat outputs, recorded.

    python tests/torch_compat_reference.py

runs the JAX package on the CPU and writes ``tests/torch_compat_reference.npz``,
which ``tests/test_torch_parallel_online.py`` and ``tests/test_torch_compat.py``
hold the port against:

* ``pgpfa.em.fit.fit_loop`` online EM with the injected stream
  :data:`STREAM` (3 iterations, batch 4) on ``tests/test_parallel.py``'s
  problem (16 trials x 16 neurons, 30 bins of 20 ms, xdim 2, seed 4, init
  seed 0), the ``'diag'`` rule joint and C-only. Sharding is exact in the
  JAX package (GSPMD gathers the minibatch), so its one-device fit is the
  sharded fit's reference;
* every value-returning function of ``pgpfa.compat`` on
  ``tests/test_compat.py``'s problem (5 trials x 10 neurons, 20 bins of
  20 ms, xdim 2, seed 2, init seed 0) at the inputs :func:`compat_inputs`
  makes: the dense objectives and their gradients, ``laplace`` (cold and
  warm), ``dualVariational`` on both paths, the batch and online M-step
  drivers, ``getCdErrorBars`` and a 3-iteration ``engine.PPGPFAfit``.

Why recorded: each of these JAX programs compiles for seconds, and run live
beside the rest of the suite on six workers they would cost the suite's time
limit far more (``tests/torch_longt_reference.py``). Rerun this script after
a change to the JAX package's online or compat paths, or to the inputs. The
inputs are made by the port's NumPy data path (``tests/torch_helpers.py``),
which draws the same numbers as ``pgpfa.dataset(backend="numpy")``.
"""

import sys
from pathlib import Path

import numpy as np

PATH = Path(__file__).with_name("torch_compat_reference.npz")
REPO = Path(__file__).resolve().parents[1]

# The online stream over the 16 trials: iteration 2's minibatch lies in
# trials 0-7, so a second rank holding 8-15 (or 10-15) has none of it.
STREAM = np.array([[2, 9, 14, 5], [0, 3, 5, 7], [11, 4, 8, 15]])
BIN = 20.0


def online_config(**kw):
    return dict(em_mode="online", batch_size=STREAM.shape[1], max_em_iter=len(STREAM), **kw)


def compat_problem():
    """tests/test_compat.py's dataset and init (the port's NumPy data path)."""
    sys.path.insert(0, str(REPO))
    from pgpfa_torch import dataset, initialize_params

    train = dataset(xdim=2, ydim=10, numTrials=5, trialDur=400, binSize=20, dOffset=0.5,
                    fixTau=True, fixedTau=np.array([0.1, 0.3]), seed=2)
    return train, initialize_params(2, 10, train, seed=0)


def compat_inputs(train, init):
    """The fixed points the dense objectives are evaluated at, and the dense
    operators at the init (``C_big``, ``d_big``, ``K_big``, its inverse),
    made by the port's shims so that both packages see the same inputs."""
    from pgpfa_torch.compat import util

    T, xdim, ydim = train.T, 2, 10
    rng = np.random.default_rng(0)
    x = 0.1 * rng.standard_normal(xdim * T)
    lam = np.exp(0.1 * rng.standard_normal(ydim * T))
    Cb, db = util.makeCd_big(init, T)
    Kb, _ = util.makeK_big(init, train.trialDur, train.binSize)
    return dict(x=x, lam=lam, ybar=train.data[0]["Y"].reshape(-1), Cb=Cb, db=db, Kb=Kb,
                Kinv=np.linalg.inv(Kb), vecCd=util.CdtoVecCd(init["C"], init["d"]),
                vecC=np.asarray(init["C"], float).reshape(-1), p0=np.array([-1.0]))


def _ref_dict(res, prefix):
    """A reference-format ``infRes`` as stacked arrays under ``prefix``."""
    return {f"{prefix}_{k}": np.stack(res[k]) for k in ("post_mean", "post_vsm", "post_vsmGP")}


def record_online(out):
    import pgpfa_torch  # noqa: F401  (its data path)
    from pgpfa.em.fit import FitConfig, fit_loop
    from torch_helpers import parallel_problem

    ds, init = parallel_problem()
    for name, joint in (("joint", True), ("conly", False)):
        r = fit_loop(init, ds.Y, BIN, FitConfig(**online_config(online_update="diag",
                                                                update_cd_jointly=joint)),
                     batch_indices=STREAM)
        for k in ("post_loglik", "C_seq", "d_seq", "tau_seq", "cd_cost"):
            out[f"online_{name}_{k}"] = np.asarray(getattr(r, k))


def record_compat(out):
    from pgpfa.compat import engine, inference, learning, util

    train, init = compat_problem()
    a = compat_inputs(train, init)
    Cb, db, Kb, Kinv, ybar = a["Cb"], a["db"], a["Kb"], a["Kinv"], a["ybar"]
    xdim, ydim = 2, 10
    out["C_big"], out["d_big"] = util.makeCd_big(init, train.T)
    out["K_big"], out["K_blocks"] = util.makeK_big(init, train.trialDur, train.binSize)
    out["nlp"] = inference.negLogPosteriorUnNorm(a["x"], ybar, Cb, db, Kinv)
    out["nlp_grad"] = inference.negLogPosteriorUnNorm_grad(a["x"], ybar, Cb, db, Kinv)
    out["nlp_hess"] = inference.negLogPosteriorUnNorm_hess(a["x"], ybar, Cb, db, Kinv)
    out["dual"] = inference.dualProblem(a["lam"], ybar, Cb, Kb, Kinv, db)
    out["dual_grad"] = inference.dualProblem_grad(a["lam"], ybar, Cb, Kb, Kinv, db)
    out["dual_rho"] = inference.dualProblemRho(np.log(a["lam"]), ybar, Cb, Kb, Kinv, db)
    out["dual_rho_grad"] = inference.dualProblemRho_grad(np.log(a["lam"]), ybar, Cb, Kb, Kinv, db)
    out["vi_cov"], out["vi_prec"] = inference.VIPostCov(Kinv, Cb, a["lam"])
    out["vi_mean"] = inference.VIPostMean(Kb, Cb, ybar, a["lam"])

    res, pll, modes = inference.laplace(train, init)
    out.update(_ref_dict(res, "laplace"))
    out["laplace_pll"] = pll
    out["laplace_warm_pll"] = inference.laplace(train, init, prevOptimRes=modes)[1]
    vres, vpll, vlb, rhos = inference.dualVariational(train, init, optimizeLogLambda=True)
    out["vi_post_mean"], out["vi_pll"], out["vi_vlb"] = np.stack(vres["post_mean"]), vpll, vlb
    bres, bpll, bvlb, lams = inference.dualVariational(train, init, optimizeLogLambda=False)
    out["bounded_post_mean"], out["bounded_pll"], out["bounded_vlb"] = (
        np.stack(bres["post_mean"]), bpll, bvlb)
    out["bounded_lambda"] = np.stack(lams)

    v, vC, p0 = a["vecCd"], a["vecC"], a["p0"]
    out["mstep_cost"] = learning.MStepObservationCost(v, xdim, ydim, train, res)
    out["mstep_cost_grad"] = learning.MStepObservationCost_grad(v, xdim, ydim, train, res)
    pre = learning.makePrecomp(res)
    out["pauto"] = np.stack([q["PautoSum"] for q in pre])
    out["tau_cost"] = learning.MStepGPtimescaleCost(p0, pre[0], 0.001)
    out["tau_cost_grad"] = learning.MStepGPtimescaleCost_grad(p0, pre[0], 0.001)
    out["tau_cost_prior"] = learning.MStepGPtimescaleCostWithPrior(p0, pre[0], 0.001,
                                                                   train.binSize, 0.2, 1.0)
    invP = -np.eye(len(v))
    out["cost_prior"] = learning.MStepObservationCostWithPrior(v + 0.1, init, xdim, ydim, train,
                                                               res, invP)
    out["cost_prior_grad"] = learning.MStepObservationCostWithPrior_grad(
        v + 0.05, init, xdim, ydim, train, res, invP)
    invPc = -np.eye(len(vC))
    out["c_cost_prior"] = learning.MStep_C_costWithPrior(vC + 0.05, init, xdim, ydim, train,
                                                         res, invPc)
    out["c_cost_prior_grad"] = learning.MStep_C_costWithPrior_grad(vC + 0.05, init, xdim, ydim,
                                                                   train, res, invPc)

    new, det = learning.updateParams(init, res, train)
    for k in ("C", "d", "tau"):
        out[f"update_{k}"] = new[k]
    out["update_cd_cost"], out["update_tau_cost"] = det["Cd"], det["tau"]
    out["lt_C"], out["lt_d"], out["lt_cost"] = learning.learnLTparams(init, res, train, "newton")
    out["gp_tau"] = learning.learnGPparams(init, res, train)[0]
    out["d_closed"] = learning.update_d_closedForm(init, res, train)
    for name, kw in (("prior_joint", dict(updateCdJointly=True)),
                     ("prior_conly", dict(updateCdJointly=False)),
                     ("prior_hess", dict(prevInvPriorCov=np.eye(3 * ydim),
                                         covOpts="useHessian"))):
        new, det, P = learning.updateParamsWithPrior(init, res, train, **kw)
        for k in ("C", "d", "tau"):
            out[f"{name}_{k}"] = new[k]
        out[f"{name}_P"], out[f"{name}_cost"] = P, det["Cd"]
    for name, joint in (("gd_joint", True), ("gd_conly", False)):
        new, _, H = learning.updateParamsWithGradDescent(init, res, train, stepSize=0.5,
                                                         updateCdJointly=joint)
        for k in ("C", "d", "tau"):
            out[f"{name}_{k}"] = new[k]
        out[f"{name}_H"] = H
    params = {"C": init["C"], "d": np.ravel(init["d"]), "tau": np.ravel(init["tau"])}
    out["error_bars"] = util.getCdErrorBars(params, train, res)

    fit = engine.PPGPFAfit(experiment=train, initParams=init, inferenceMethod="laplace",
                           EMmode="Batch", maxEMiter=3)
    out["fit_pll"] = np.asarray(fit.posteriorLikelihood)
    for k in ("C", "d", "tau"):
        out[f"fit_{k}"] = np.asarray(fit.optimParams[k])


def load():
    with np.load(PATH) as z:
        return {k: z[k] for k in z.files}


def main():
    import time

    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(Path(__file__).parent))
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    t0 = time.time()
    out = {}
    record_online(out)
    record_compat(out)
    np.savez(PATH, **{k: np.asarray(v) for k, v in out.items()})
    print(f"wrote {PATH} ({len(out)} arrays) in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
