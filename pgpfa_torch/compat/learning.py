"""Shim for the reference's ``funs/learning.py`` public surface (port of
``pgpfa/compat/learning.py``).

``infRes`` may be either the reference's dict-of-lists format or a
:class:`pgpfa_torch.infer.laplace.InfRes`. The M-step drivers run the port's
M-steps on ``device``; the cost functions of the reference's packed
vectors are NumPy (:mod:`pgpfa_torch.compat._dense`).
"""

import numpy as np
import torch

from pgpfa_torch.compat import _dense as O
from pgpfa_torch.compat.util import CdtoVecCd
from pgpfa_torch.convert import params_from_numpy, to_numpy
from pgpfa_torch.data.synthetic import stack_experiment
from pgpfa_torch.infer.laplace import InfRes
from pgpfa_torch.learn.mstep_gp import learn_tau
from pgpfa_torch.learn.mstep_obs import learn_cd


def _moments(infRes, device, dtype):
    """``(means, post_vsm, post_vsm_gp)`` as tensors on ``device``."""
    if isinstance(infRes, InfRes):
        parts = (infRes.post_mean, infRes.post_vsm, infRes.post_vsm_gp)
    else:
        parts = (np.stack(infRes["post_mean"]), np.stack(infRes["post_vsm"]),
                 np.stack([np.transpose(v, (2, 0, 1)) for v in infRes["post_vsmGP"]]))
    return tuple(torch.as_tensor(a, dtype=dtype, device=device) for a in parts)


def _inputs(oldParams, infRes, experiment, device, dtype):
    """The parameters, the moments and the counts on ``device``."""
    p = params_from_numpy(oldParams, device, dtype)
    means, vsm, vsm_gp = _moments(infRes, p.C.device, dtype)
    Y = torch.as_tensor(stack_experiment(experiment), dtype=dtype, device=p.C.device)
    return p, means, vsm, vsm_gp, Y


def _np_moments(infRes):
    means, vsm, _ = _moments(infRes, "cpu", torch.float64)
    return means.numpy(), vsm.numpy()


def updateParams(oldParams, infRes, experiment, CdOptimMethod="newton", CdMaxIter=None,
                 tauMaxIter=None, verbose=False, device="cuda", dtype=torch.float64):
    """Batch M-step (reference ``funs/learning.py:295-309``) on ``device``.

    Returns ``(newParams, optimDetails)`` with the reference's dict shapes.
    """
    p, means, vsm, vsm_gp, Y = _inputs(oldParams, infRes, experiment, device, dtype)
    cd = learn_cd(Y, means, vsm, p.C, p.d, maxiter=CdMaxIter or 10)
    tr = learn_tau(means, vsm_gp, p.tau, float(experiment.binSize), maxiter=tauMaxIter or 8)
    new_params = {"C": to_numpy(cd.C), "d": to_numpy(cd.d), "tau": to_numpy(tr.tau)}
    details = {"Cd": float(cd.cost), "tau": to_numpy(tr.cost)}
    return new_params, details


def makePrecomp(infRes, device="cuda", dtype=torch.float64):
    """Reference ``funs/learning.py:145-173``: list of per-latent dicts with
    the summed posterior second moments (``PautoSum`` on ``device``, returned
    as NumPy)."""
    from pgpfa_torch.learn.mstep_gp import pauto_sum

    means, _, vsm_gp = _moments(infRes, device, dtype)
    ps = to_numpy(pauto_sum(means, vsm_gp))
    xdim, T = means.shape[1], means.shape[2]
    idx = np.arange(T, dtype=float)
    tdif = idx[:, None] - idx[None, :]
    return [
        {"T": T, "Tdif": tdif, "difSq": tdif * tdif,
         "numTrials": means.shape[0], "PautoSum": ps[k]}
        for k in range(xdim)
    ]


# -- drivers (reference funs/learning.py:93-141, 257-293) --------------------


def learnLTparams(oldParams, infRes, experiment, CdOptimMethod="newton",
                  CdMaxIter=None, verbose=False, device="cuda", dtype=torch.float64):
    """Batch (C, d) M-step driver (reference ``funs/learning.py:93-141``).
    Returns ``(newC, newd, costFun)``."""
    p, means, vsm, _, Y = _inputs(oldParams, infRes, experiment, device, dtype)
    cd = learn_cd(Y, means, vsm, p.C, p.d, maxiter=CdMaxIter or 10)
    return to_numpy(cd.C), to_numpy(cd.d), float(cd.cost)


def learnGPparams(oldParams, infRes, experiment, tauOptimMethod=None, verbose=False,
                  device="cuda", dtype=torch.float64):
    """Batch tau M-step driver (reference ``funs/learning.py:257-293``).
    Returns ``(newTau, optimizeDetails)``."""
    p = params_from_numpy(oldParams, device, dtype)
    means, _, vsm_gp = _moments(infRes, p.C.device, dtype)
    tr = learn_tau(means, vsm_gp, p.tau, float(experiment.binSize))
    return to_numpy(tr.tau), [{"cost": float(c)} for c in to_numpy(tr.cost)]


# -- public cost functions (reference funs/learning.py:20-91, 175-255) -------


def MStepObservationCost(vecCd, xdim, ydim, experiment, infRes):
    """Expected-complete-data (C, d) cost over the packed vector
    (reference ``funs/learning.py:20-49``; normalized by numTrials)."""
    means, vsm = _np_moments(infRes)
    Y = np.asarray(stack_experiment(experiment), dtype=float)
    return float(O.cd_cost(np.asarray(vecCd, float), Y, means, vsm))


def MStepObservationCost_grad(vecCd, xdim, ydim, experiment, infRes):
    """Analytic gradient of :func:`MStepObservationCost`
    (reference ``funs/learning.py:51-91``)."""
    means, vsm = _np_moments(infRes)
    Y = np.asarray(stack_experiment(experiment), dtype=float)
    return O.cd_cost_grad(np.asarray(vecCd, float), Y, means, vsm)


def MStepGPtimescaleCost(p, precomp, epsNoise=0.001):
    """Per-latent GP-timescale cost in ``p = log gamma`` space
    (reference ``funs/learning.py:175-214``; exact symmetric computation
    instead of the reference's ceil/floor-split vector trick)."""
    return float(O.tau_cost(np.ravel(p)[0], precomp["PautoSum"],
                            precomp["numTrials"], precomp["T"], epsNoise))


def MStepGPtimescaleCost_grad(p, precomp, epsNoise=0.001, device="cuda", dtype=torch.float64):
    """Analytic gradient of :func:`MStepGPtimescaleCost`
    (reference ``funs/learning.py:216-255``), the port's exact derivative
    of the tau M-step on ``device``."""
    from pgpfa_torch.learn.mstep_gp import _tau_derivatives

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=dtype, device=device)

    g, _ = _tau_derivatives(t(np.ravel(p)[0]), t(precomp["PautoSum"]), precomp["numTrials"],
                            t(precomp["difSq"]), epsNoise)
    return np.asarray([float(g)])


def MStepGPtimescaleCostWithPrior(p, precomp, epsNoise, binSize, oldTau,
                                  regularizer_stepsize_tau):
    """Prior-regularized tau cost (reference ``funs/learning.py:681-724``):
    adds ``0.5 (tau - oldTau)^2 / s^2`` with tau in seconds."""
    return float(O.tau_cost_with_prior(
        np.ravel(p)[0], precomp["PautoSum"], precomp["numTrials"],
        precomp["T"], binSize, oldTau, regularizer_stepsize_tau, epsNoise))


def MStepObservationCostWithPrior(vecCd, oldParams, xdim, ydim, experiment,
                                  infRes, invPriorCov):
    """Reference ``funs/learning.py:445-486``: cost plus the Gaussian prior
    term in the reference's sign convention (``invPriorCov`` negative
    definite encodes a positive proximal penalty):
    ``datacost/numTrials - 0.5 dv^T invPriorCov dv``."""
    base = MStepObservationCost(vecCd, xdim, ydim, experiment, infRes)
    dv = np.asarray(vecCd, float) - CdtoVecCd(oldParams["C"], oldParams["d"])
    return base - 0.5 * float(dv @ (np.asarray(invPriorCov) @ dv))


def MStepObservationCostWithPrior_grad(vecCd, oldParams, xdim, ydim,
                                       experiment, infRes, invPriorCov):
    """Gradient of :func:`MStepObservationCostWithPrior`
    (reference ``funs/learning.py:488-534``)."""
    g = MStepObservationCost_grad(vecCd, xdim, ydim, experiment, infRes)
    dv = np.asarray(vecCd, float) - CdtoVecCd(oldParams["C"], oldParams["d"])
    return g - np.asarray(invPriorCov) @ dv


def MStep_C_costWithPrior(vecC, oldParams, xdim, ydim, experiment, infRes,
                          invPriorCov):
    """C-only cost at fixed d (reference ``funs/learning.py:360-397``).

    Faithful to the reference: ``vecC`` is the row-major flatten of C, the
    data term is not normalized by numTrials, and ``invPriorCov`` may be
    ``None`` (no prior) or negative definite (reference sign convention).
    """
    means, vsm = _np_moments(infRes)
    Y = np.asarray(stack_experiment(experiment), dtype=float)
    R = Y.shape[0]
    C = np.asarray(vecC, float).reshape(ydim, xdim)
    d = np.ravel(np.asarray(oldParams["d"], float))
    vec = np.concatenate([C.T.reshape(-1), d])
    f = O.cd_cost(vec, Y, means, vsm) * R
    if invPriorCov is not None:
        dv = np.asarray(vecC, float) - np.asarray(oldParams["C"], float).reshape(-1)
        f = f - 0.5 * float(dv @ (np.asarray(invPriorCov) @ dv))
    return f


def MStep_C_costWithPrior_grad(vecC, oldParams, xdim, ydim, experiment,
                               infRes, invPriorCov):
    """Gradient of :func:`MStep_C_costWithPrior`
    (reference ``funs/learning.py:399-442``)."""
    means, vsm = _np_moments(infRes)
    Y = np.asarray(stack_experiment(experiment), dtype=float)
    R = Y.shape[0]
    C = np.asarray(vecC, float).reshape(ydim, xdim)
    d = np.ravel(np.asarray(oldParams["d"], float))
    vec = np.concatenate([C.T.reshape(-1), d])
    gcol = O.cd_cost_grad(vec, Y, means, vsm)[: xdim * ydim] * R
    g = gcol.reshape(xdim, ydim).T.reshape(-1)  # column-packed -> row-major
    if invPriorCov is not None:
        dv = np.asarray(vecC, float) - np.asarray(oldParams["C"], float).reshape(-1)
        g = g - np.asarray(invPriorCov) @ dv
    return g


def update_d_closedForm(oldParams, infRes, experiment, device="cuda", dtype=torch.float64):
    """Closed-form d (reference ``funs/learning.py:318-358``; the consistent
    moment-matching form of
    :func:`pgpfa_torch.learn.mstep_obs.update_d_closed_form`) on ``device``."""
    from pgpfa_torch.learn.mstep_obs import update_d_closed_form

    p, means, vsm, _, Y = _inputs(oldParams, infRes, experiment, device, dtype)
    return to_numpy(update_d_closed_form(Y, means, vsm, p.C))


# -- online drivers (reference funs/learning.py:536-676, 833-966) ------------


def updateParamsWithPrior(oldParams, infRes, experiment, CdOptimMethod=None,
                          tauOptimMethod=None, regularizer_stepsize_Cd=1.0,
                          regularizer_stepsize_tau=1.0, prevInvPriorCov=None,
                          covOpts="useDiag", verbose=False,
                          updateCdJointly=True, hessTol=None, device="cuda",
                          dtype=torch.float64):
    """Prior-regularized online M-step (reference ``funs/learning.py:833-866``)
    on ``device``.

    Returns ``(newParams, optimDetails, invPriorCov)``. As in the JAX
    package (PARITY.md): ``prevInvPriorCov`` and the returned
    ``invPriorCov`` use the standard positive precision convention (the
    reference stores the negated penalty and seeds the recursion with a
    sign-flipped identity), and the curvature for ``covOpts='useHessian'``
    is the exact Hessian instead of the reference's finite-difference
    ``approx_jacobian``.
    """
    from pgpfa_torch.learn.mstep_obs import (c_only_cost, c_only_grad_hess, cd_hessian,
                                              update_d_closed_form)
    from pgpfa_torch.models.params import pack_cd
    from pgpfa_torch.utils.optim import minimize_lbfgs

    p, means, vsm, vsm_gp, Y = _inputs(oldParams, infRes, experiment, device, dtype)
    C0, d0, tau0 = p.C, p.d, p.tau
    xdim, ydim = C0.shape[1], C0.shape[0]
    like = dict(dtype=dtype, device=C0.device)

    def prev_or_eye(n):
        if prevInvPriorCov is None:
            return torch.eye(n, **like)
        return torch.as_tensor(np.asarray(prevInvPriorCov, dtype=float), **like)

    if updateCdJointly:
        v0 = pack_cd(C0, d0)
        n = v0.shape[0]
        if covOpts == "useHessian":
            P = cd_hessian(v0, Y, means, vsm) + prev_or_eye(n)
        else:
            P = torch.eye(n, **like) / regularizer_stepsize_Cd**2
        cd = learn_cd(Y, means, vsm, C0, d0, prior=(P, v0), method="lbfgs")
        newC, newd, cost = to_numpy(cd.C), to_numpy(cd.d), float(cd.cost)
    else:
        newd_t = update_d_closed_form(Y, means, vsm, C0)
        vC0 = C0.T.reshape(-1)
        n = vC0.shape[0]
        if covOpts == "useHessian":
            P = c_only_grad_hess(vC0, newd_t, Y, means, vsm)[1] + prev_or_eye(n)
        else:
            P = torch.eye(n, **like) / regularizer_stepsize_Cd**2

        def fun(v):
            return c_only_cost(v, newd_t, Y, means, vsm) + 0.5 * (v - vC0) @ (P @ (v - vC0))

        res = minimize_lbfgs(fun, vC0, maxiter=500, tol=1e-9)
        newC = to_numpy(res.x.reshape(xdim, ydim).T)
        newd, cost = to_numpy(newd_t), float(res.fun)

    tr = learn_tau(means, vsm_gp, tau0, float(experiment.binSize),
                   prior=(tau0, regularizer_stepsize_tau))
    newParams = {"C": newC, "d": newd, "tau": to_numpy(tr.tau)}
    details = {"Cd": cost, "tau": to_numpy(tr.cost)}
    return newParams, details, to_numpy(P)


def updateParamsWithGradDescent(oldParams, infRes, experiment, stepSize,
                                cumHess=None, regularizer_stepsize_tau=1.0,
                                tauOptimMethod=None, updateCdJointly=True,
                                verbose=False, hessTol=None, device="cuda",
                                dtype=torch.float64):
    """One damped Newton step on the (C, d) cost plus the prior-regularized
    tau update (reference ``funs/learning.py:932-966``) on ``device``.
    Returns ``(newParams, optimDetails, hess)`` with the exact (positive,
    cost-convention) Hessian in place of the reference's finite-difference
    one.
    """
    from pgpfa_torch.learn.mstep_obs import (c_only_grad_hess, cd_hessian, neuron_grad_hess,
                                              update_d_closed_form)
    from pgpfa_torch.models.params import pack_cd, unpack_cd
    from pgpfa_torch.ops.blockmat import solve_psd_mixed

    p, means, vsm, vsm_gp, Y = _inputs(oldParams, infRes, experiment, device, dtype)
    C0, d0, tau0 = p.C, p.d, p.tau
    xdim, ydim = C0.shape[1], C0.shape[0]

    if updateCdJointly:
        v0 = pack_cd(C0, d0)
        g_rows, _ = neuron_grad_hess(torch.cat([C0, d0[:, None]], 1), Y, means, vsm)
        g = g_rows.T.reshape(-1)  # the packed (pack_cd) order
        H = cd_hessian(v0, Y, means, vsm)
        eye = torch.eye(v0.shape[0], dtype=dtype, device=C0.device)
        v = v0 - stepSize * solve_psd_mixed(H + 1e-10 * eye, g)
        newC_t, newd_t = unpack_cd(v, xdim, ydim)
    else:
        newd_t = update_d_closed_form(Y, means, vsm, C0)
        vC0 = C0.T.reshape(-1)
        g, H = c_only_grad_hess(vC0, newd_t, Y, means, vsm)
        eye = torch.eye(vC0.shape[0], dtype=dtype, device=C0.device)
        vC = vC0 - stepSize * solve_psd_mixed(H + 1e-10 * eye, g)
        newC_t = vC.reshape(xdim, ydim).T

    tr = learn_tau(means, vsm_gp, tau0, float(experiment.binSize),
                   prior=(tau0, regularizer_stepsize_tau))
    newParams = {"C": to_numpy(newC_t), "d": to_numpy(newd_t), "tau": to_numpy(tr.tau)}
    details = {"Cd": None, "tau": to_numpy(tr.cost)}
    return newParams, details, to_numpy(H)
