"""Shim for the reference's ``funs/inference.py`` public surface (port of
``pgpfa/compat/inference.py``).

The reference functions operate on dense ``C_big``/``K_bigInv``
materializations; :func:`laplace` and :func:`dualVariational` accept the
same experiment and params inputs and run the port's batched
block-structured E-steps on ``device``. The dense objectives are NumPy
(:mod:`pgpfa_torch.compat._dense`), and so is the bounded-lambda dual
(``optimizeLogLambda=False``), which runs on the host with SciPy.
"""

import numpy as np
import torch

from pgpfa_torch.compat import _dense as O
from pgpfa_torch.convert import params_from_numpy
from pgpfa_torch.data.synthetic import stack_experiment
from pgpfa_torch.infer.laplace import laplace_estep_from_arrays
from pgpfa_torch.infer.variational import vi_estep_from_arrays


def _unpack(experiment, params, device, dtype):
    Y = stack_experiment(experiment)
    p = params_from_numpy(params, device, dtype)
    return p.C, p.d, p.tau, torch.as_tensor(Y, dtype=dtype, device=p.C.device), Y.shape[-1]


# -- public objective surface (reference funs/inference.py:12-65,186-256) ----


def negLogPosteriorUnNorm(xbar, ybar, C_big, d_big, K_bigInv, xdim=None, ydim=None):
    """Negative unnormalized log posterior over flattened latents
    (reference ``funs/inference.py:12-32``). Dense-argument form for user
    code that builds ``C_big``/``K_bigInv`` via :mod:`pgpfa_torch.compat.util`."""
    return float(O.nlp(np.ravel(np.asarray(xbar, float)), np.ravel(np.asarray(ybar, float)),
                       np.asarray(C_big, float), np.ravel(np.asarray(d_big, float)),
                       np.asarray(K_bigInv, float)))


def negLogPosteriorUnNorm_grad(xbar, ybar, C_big, d_big, K_bigInv, xdim=None, ydim=None):
    """Analytic gradient (reference ``funs/inference.py:34-48``)."""
    return O.nlp_grad(np.ravel(np.asarray(xbar, float)), np.ravel(np.asarray(ybar, float)),
                      np.asarray(C_big, float), np.ravel(np.asarray(d_big, float)),
                      np.asarray(K_bigInv, float))


def negLogPosteriorUnNorm_hess(xbar, ybar, C_big, d_big, K_bigInv, xdim=None, ydim=None):
    """Analytic Hessian (reference ``funs/inference.py:50-65``; returned
    dense)."""
    return O.nlp_hess(np.ravel(np.asarray(xbar, float)), np.ravel(np.asarray(ybar, float)),
                      np.asarray(C_big, float), np.ravel(np.asarray(d_big, float)),
                      np.asarray(K_bigInv, float))


def VIPostCov(K_bigInv, C_big, lamb):
    """Variational posterior covariance/precision with the reference's
    relative diagonal ridge (``funs/inference.py:188-191``)."""
    prec = (np.asarray(K_bigInv, float)
            + (np.asarray(C_big, float) * np.ravel(lamb)[None, :]) @ np.asarray(C_big, float).T)
    cov = np.linalg.inv(prec + 1e-6 * np.diag(np.diag(prec)))
    return cov, prec


def VIPostMean(K_big, C_big, y_bar, lamb):
    """``-K C_big (lambda - ybar)`` (reference ``funs/inference.py:193-194``)."""
    return -np.asarray(K_big, float) @ (np.asarray(C_big, float)
                                        @ (np.ravel(lamb) - np.ravel(y_bar)))


def dualProblem(lamb, ybar, C_big, K_big, K_bigInv, d_big):
    """Dual VI objective over ``lambda`` (reference ``funs/inference.py:196-213``)."""
    return float(O.vi_dual_cost(np.log(np.ravel(np.asarray(lamb, float))),
                                np.ravel(np.asarray(ybar, float)),
                                np.asarray(C_big, float), np.ravel(np.asarray(d_big, float)),
                                np.asarray(K_big, float), np.asarray(K_bigInv, float)))


def dualProblem_grad(lamb, ybar, C_big, K_big, K_bigInv, d_big):
    """Dual gradient over ``lambda`` (reference ``funs/inference.py:215-219``;
    like the reference, the tiny ridge's own lambda-dependence is neglected)."""
    lamb = np.ravel(np.asarray(lamb, float))
    ybar = np.ravel(np.asarray(ybar, float))
    Cb = np.asarray(C_big, float)
    cov, _ = VIPostCov(K_bigInv, Cb, lamb)
    lmy = lamb - ybar
    return (Cb.T @ (np.asarray(K_big, float) @ (Cb @ lmy))
            - np.ravel(np.asarray(d_big, float)) + np.log(lamb)
            - 0.5 * np.einsum("ki,kl,li->i", Cb, cov, Cb))


def dualProblemRho(rho, ybar, C_big, K_big, K_bigInv, d_big):
    """Dual objective over ``rho = log lambda``
    (reference ``funs/inference.py:222-244``)."""
    return float(O.vi_dual_cost(np.ravel(np.asarray(rho, float)),
                                np.ravel(np.asarray(ybar, float)),
                                np.asarray(C_big, float), np.ravel(np.asarray(d_big, float)),
                                np.asarray(K_big, float), np.asarray(K_bigInv, float)))


def dualProblemRho_grad(rho, ybar, C_big, K_big, K_bigInv, d_big):
    """Dual gradient over ``rho`` (reference ``funs/inference.py:246-256``)."""
    rho = np.ravel(np.asarray(rho, float))
    return dualProblem_grad(np.exp(rho), ybar, C_big, K_big, K_bigInv, d_big) * np.exp(rho)


def laplace(experiment, params, prevOptimRes=None, returnOptimRes=True, verbose=False,
            device="cuda", dtype=torch.float64, **kw):
    """Reference signature (``funs/inference.py:67``): returns
    ``(infRes, -post_lik[, optimRes])`` with the reference's dict format.
    The batched Laplace E-step of all trials on ``device``."""
    C, d, tau, Y, T = _unpack(experiment, params, device, dtype)
    x_init = None
    if prevOptimRes is not None:
        x_init = torch.as_tensor(np.stack([np.reshape(x, (C.shape[1], T)) for x in prevOptimRes]),
                                 dtype=dtype, device=C.device)
    inf, pll = laplace_estep_from_arrays(C, d, tau, Y, T, float(experiment.binSize),
                                         x_init=x_init)
    res = inf.to_reference_dict()
    if returnOptimRes:
        modes = [m.reshape(-1) for m in res["post_mean"]]
        return res, float(pll), modes
    return res, float(pll)


def dualVariational(experiment, params, optimizeLogLambda=False, prevOptimRes=None,
                    returnOptimRes=True, verbose=False, device="cuda", dtype=torch.float64,
                    **kw):
    """Reference signature and default (``funs/inference.py:259``).

    * ``optimizeLogLambda=True``: the port's batched L-BFGS dual in
      ``rho = log lambda`` on ``device`` (the reference's own variant at
      ``funs/inference.py:352-399``).
    * ``optimizeLogLambda=False`` (the reference's default,
      ``funs/inference.py:315-324``): per-trial box-bounded L-BFGS-B over
      ``lambda in (1e-10, inf)`` with ``factr=1e7``, on the host with NumPy
      and SciPy whatever ``device`` says, as in the JAX package: a compat
      path for users comparing lambda-space iterates, not a card path.

    Both paths agree on converged bounds to the VI parity envelope
    (``tests/test_torch_compat.py``).
    """
    if not optimizeLogLambda:
        return _dual_variational_bounded(experiment, params, prevOptimRes,
                                         returnOptimRes, verbose)
    C, d, tau, Y, T = _unpack(experiment, params, device, dtype)
    rho_init = None
    if prevOptimRes is not None:
        rho_init = torch.as_tensor(np.stack([np.reshape(r, (C.shape[0], T)) for r in prevOptimRes]),
                                   dtype=dtype, device=C.device)
    inf, pll, vlb, rho = vi_estep_from_arrays(C, d, tau, Y, T, float(experiment.binSize),
                                              rho_init=rho_init)
    res = inf.to_reference_dict()
    if returnOptimRes:
        rhos = list(rho.reshape(rho.shape[0], -1).cpu().numpy())
        return res, float(pll), float(vlb), rhos
    return res, float(pll), float(vlb)


def _dual_variational_bounded(experiment, params, prevOptimRes=None,
                              returnOptimRes=True, verbose=False):
    """Bounded-lambda dual VI (reference ``funs/inference.py:288-418``):
    per-trial ``scipy.optimize.fmin_l_bfgs_b`` with the reference's bounds
    ``(1e-10, None)``, ``factr=1e7``, init ``lambda = 0.5``, and the
    reference's ridge-regularized posterior packing, on the host (dense
    ``C_big``/``K_big`` algebra via the shims above; inverses by
    ``np.linalg.inv``)."""
    import scipy.optimize as op

    from pgpfa_torch.compat import util

    ydim, T = np.shape(experiment.data[0]["Y"])
    xdim = np.shape(np.asarray(params["C"]))[1]
    n_trials = len(experiment.data)

    # same (xdim*T, ydim*T) orientation as the reference's makeCd_big
    C_big, d_big = util.makeCd_big(params, T)
    K_big, _ = util.makeK_big(params, experiment.trialDur, experiment.binSize)
    K_bigInv = np.linalg.inv(K_big)

    post_mean, post_cov, vsm, vsm_gp, optim_res = [], [], [], [], []
    post_lik = 0.0
    vlb = 0.0
    for tr in range(n_trials):
        if verbose:
            print(f"bounded dual variational inference, trial {tr + 1}...")
        ybar = np.reshape(np.asarray(experiment.data[tr]["Y"], float), ydim * T)
        lamb0 = (np.zeros(ydim * T) + 0.5 if prevOptimRes is None
                 else np.ravel(prevOptimRes[tr]))
        x_opt, f_opt, _ = op.fmin_l_bfgs_b(
            func=dualProblem,
            x0=lamb0,
            fprime=dualProblem_grad,
            args=(ybar, C_big, K_big, K_bigInv, d_big),
            bounds=[(1e-10, None)] * (ydim * T),
            factr=1e7,
            disp=False,
        )
        optim_res.append(x_opt)
        mean = VIPostMean(K_big, C_big, ybar, x_opt)
        # the reference's bounded branch does not add the extra ridge*I it
        # adds in the rho branch (funs/inference.py:335-337 vs 400-402); the
        # relative diagonal ridge inside VIPostCov is the only regularizer
        cov, _ = VIPostCov(K_bigInv, C_big, x_opt)
        post_mean.append(np.reshape(mean, (xdim, T)))
        post_cov.append(cov)
        # per-time (xdim, xdim) and per-latent (T, T) covariance views
        # (reference funs/inference.py:407-418)
        vsm_gp.append(np.stack(
            [cov[k * T:(k + 1) * T, k * T:(k + 1) * T] for k in range(xdim)],
            axis=-1))
        vsm.append(np.stack([cov[t::T, t::T] for t in range(T)]))
        post_lik += negLogPosteriorUnNorm(mean, ybar, C_big, d_big, K_bigInv,
                                          xdim, ydim)
        vlb += f_opt

    res = {"post_mean": post_mean, "post_cov": post_cov,
           "post_vsm": vsm, "post_vsmGP": vsm_gp}
    post_lik /= n_trials
    vlb /= n_trials
    if returnOptimRes:
        return res, -float(post_lik), float(vlb), optim_res
    return res, -float(post_lik), float(vlb)
