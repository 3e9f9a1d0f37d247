"""Shim for the reference's ``funs/util.py`` public surface (port of
``pgpfa/compat/util.py``)."""

import numpy as np
import torch

from pgpfa_torch.data.batching import seen_trials as seenTrials  # noqa: F401
from pgpfa_torch.data.batching import subsample_trials as subsampleTrials  # noqa: F401
from pgpfa_torch.data.init import initialize_params as initializeParams  # noqa: F401
from pgpfa_torch.data.loaders import (  # noqa: F401
    load_crcns_data,
    loadDataForGPFA_CV_comparison,
    loadDataHighData,
    MATLABdataset,
)
from pgpfa_torch.data.synthetic import dataset  # noqa: F401
from pgpfa_torch.diag.crossval import crossValidation  # noqa: F401
from pgpfa_torch.diag.crossval import split_train_test as splitTrainingTestDataset  # noqa: F401
from pgpfa_torch.diag.loo import leave_one_out_prediction as leaveOneOutPrediction  # noqa: F401
from pgpfa_torch.diag.metrics import js_logdet_div as JSLogdetDiv  # noqa: F401
from pgpfa_torch.diag.metrics import mean_cov_y_from_params as getMeanCovYfromParams  # noqa: F401
from pgpfa_torch.diag.metrics import mvnpdf, mvnpdf_use_inv_cov  # noqa: F401
from pgpfa_torch.diag.metrics import subspace_angle as subspaceAngle  # noqa: F401
from pgpfa_torch.diag.plotting import plot_loo_prediction as plotLeaveOneOutPrediction  # noqa: F401
from pgpfa_torch.diag.plotting import raster, simple_axis as simpleaxis  # noqa: F401
from pgpfa_torch.utils.io import Printer, open_variables as openVariables  # noqa: F401
from pgpfa_torch.utils.io import save_variables as saveVariables  # noqa: F401
from pgpfa_torch.utils.io import stars, tic, toc  # noqa: F401


def makeCd_big(params, T):
    """Dense lifted (C, d) operators — reference ``funs/util.py:594-597``.

    Provided for compatibility only: the compute paths never materialize
    these."""
    C = np.asarray(params["C"])
    d = np.ravel(np.asarray(params["d"]))
    C_big = np.kron(C, np.eye(T)).T
    d_big = np.repeat(d, T)
    return C_big, d_big


def makeK_big(params, trialDur, binSize, epsNoise=0.001):
    """Dense block-diagonal GP covariance — reference ``funs/util.py:599-619``.

    Compatibility and plotting helper on the host; the compute paths use
    the per-latent block form (:func:`pgpfa_torch.models.params.rbf_kernel`)."""
    import scipy.linalg as sla

    from pgpfa_torch.models.params import rbf_kernel

    T = int(trialDur // binSize)
    tau = torch.as_tensor(np.ravel(np.asarray(params["tau"], dtype=float)))
    K = rbf_kernel(tau, T, float(binSize), epsNoise).numpy()
    return sla.block_diag(*K), K


def getCdErrorBars(params, experiment, infRes, device="cuda", dtype=torch.float64):
    """Inverse-Hessian standard errors for the packed (C, d) estimate —
    reference signature (``funs/util.py:436-447``).

    The reference numerically differentiates the M-step gradient; here the
    exact Hessian is used (:func:`pgpfa_torch.cd_error_bars`, on ``device``).

    Args:
        params: dict with ``C (ydim, xdim)`` and ``d (ydim,)``.
        experiment: reference-style experiment (``data[tr]['Y']``).
        infRes: reference-format inference result (``post_mean`` list of
            ``(xdim, T)``, ``post_vsm`` list of ``(T, xdim, xdim)``).
    """
    from pgpfa_torch.data.synthetic import stack_experiment
    from pgpfa_torch.diag.metrics import cd_error_bars

    Y = stack_experiment(experiment)
    means = np.stack([np.asarray(m) for m in infRes["post_mean"]])
    vsms = np.stack([np.asarray(v) for v in infRes["post_vsm"]])
    return cd_error_bars(params, Y, means, vsms, device, dtype)


def approx_jacobian(x, func, epsilon, *args):
    """Fourth-order central-difference Jacobian of ``func`` at ``x`` —
    reference signature (``funs/util.py:377-434``).

    Kept for API parity with user code; inside the port every Jacobian and
    Hessian the reference approximated numerically is exact (e.g.
    :func:`getCdErrorBars` above). ``epsilon=None`` selects the
    rounding-optimal step ``(eps_f64)^(1/3) * max(|x|, 0.1)`` per coordinate.
    """
    x0 = np.atleast_1d(np.asarray(x, dtype=float))
    n = x0.size
    if epsilon is None:
        eps = np.finfo(float).eps ** (1.0 / 3.0) * np.maximum(np.abs(x0), 0.1) / 2.0
    else:
        eps = np.full(n, epsilon, dtype=float) / 2.0
    f0 = np.atleast_1d(np.asarray(func(x0, *args), dtype=float))
    jac = np.zeros([n, f0.size])
    dx = np.zeros(n)
    for i in range(n):
        dx[i] = eps[i]
        jac[i] = (
            -np.asarray(func(x0 + 2 * dx, *args))
            + 8 * np.asarray(func(x0 + dx, *args))
            - 8 * np.asarray(func(x0 - dx, *args))
            + np.asarray(func(x0 - 2 * dx, *args))
        ) / (12 * dx[i])
        dx[i] = 0.0
    return jac.T


def CdtoVecCd(C, d):
    """Pack (reference ``funs/util.py:560-574``; :func:`pgpfa_torch.pack_cd`
    order)."""
    return np.concatenate([np.asarray(C, dtype=float).T.reshape(-1), np.ravel(np.asarray(d))])


def vecCdtoCd(vecCd, xdim, ydim):
    """Unpack (reference ``funs/util.py:576-592``)."""
    v = np.asarray(vecCd)
    return v[: xdim * ydim].reshape(xdim, ydim).T, v[xdim * ydim:]
