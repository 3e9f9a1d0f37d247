"""Synthetic Poisson-GPFA datasets, NumPy only.

Twin of the ``backend="numpy"`` path of ``pgpfa/data/synthetic.py``: the same
calls on the same ``numpy.random.Generator`` in the same order, so a seed gives
the same spike counts in both packages. The RBF kernel is computed here in
NumPy (the JAX package computes it with ``pgpfa.models.params.rbf_kernel``),
so nothing in this module imports JAX.
"""

from __future__ import annotations

import numpy as np


def rbf_kernel_numpy(tau, T: int, bin_size_ms: float, eps_noise: float = 0.001) -> np.ndarray:
    """``(xdim, T, T)`` RBF kernel blocks, the same expression as
    :func:`pgpfa_torch.models.params.rbf_kernel` evaluated in NumPy."""
    tau = np.asarray(tau, dtype=np.float64).reshape(-1)
    t = np.arange(T, dtype=np.float64)
    dt = t[:, None] - t[None, :]
    sq = dt * dt * (float(bin_size_ms) ** 2)
    tau_ms = tau * 1000.0
    base = (1.0 - eps_noise) * np.exp(-0.5 * sq[None, :, :] / (tau_ms**2)[:, None, None])
    return base + eps_noise * np.eye(T)[None, :, :]


def sample_params_numpy(rng, xdim, ydim, d_offset=-1.0, fixed_tau=None):
    """Ground-truth ``{'C', 'd', 'tau'}``: ``C ~ U(-0.5, 0.5)``,
    ``d ~ U(-2, 0) + d_offset``, ``tau ~ U(0, 1) + 0.01`` s unless fixed."""
    C = rng.uniform(-0.5, 0.5, size=(ydim, xdim))
    d = rng.uniform(0.0, 1.0, size=ydim) * (-2.0) + d_offset
    tau = (
        np.ravel(np.asarray(fixed_tau))
        if fixed_tau is not None
        else rng.uniform(0.0, 1.0, size=xdim) + 0.01
    )
    return {"C": C, "d": d, "tau": tau}


def sample_trials_numpy(rng, params, num_trials, T, bin_size_ms, draw_same_x=False,
                        eps_noise=0.001):
    """Latents ``(R, xdim, T)`` and spike counts ``(R, ydim, T)`` for all trials."""
    C = np.asarray(params["C"])
    d = np.asarray(params["d"])
    L = np.linalg.cholesky(rbf_kernel_numpy(params["tau"], T, bin_size_ms, eps_noise))
    xdim = C.shape[1]
    n_draws = 1 if draw_same_x else num_trials
    z = rng.standard_normal((n_draws, xdim, T))
    X = np.einsum("ktu,rku->rkt", L, z)
    if draw_same_x:
        X = np.broadcast_to(X, (num_trials, xdim, T))
    rates = np.exp(np.einsum("nk,rkt->rnt", C, X) + d[None, :, None])
    Y = rng.poisson(rates).astype(float)
    return X, Y


class dataset:
    """Multi-trial synthetic spike-count dataset.

    The attributes of ``pgpfa.dataset``: ``X``, ``Y`` (stacked
    ``(R, ., T)`` arrays), ``data`` (per-trial dicts), ``params``, ``T``,
    ``binSize``, ``trialDur``, ``numTrials``, ``xdim``, ``ydim``, and the
    count statistics its constructor computes (``avgFR``, ``totalSpkCt``,
    ``all_raster``, ``means``, ``variances``, ``curve_p``, ``curve_p_cov``).
    """

    def __init__(
        self,
        trialDur: int = 1000,
        binSize: int = 10,
        drawSameX: bool = False,
        numTrials: int = 20,
        xdim: int = 3,
        ydim: int = 30,
        seed: int = 12,
        dOffset: float = -1.0,
        fixTau: bool = False,
        fixedTau=None,
        params=None,
    ):
        self.trialDur = int(trialDur)
        self.binSize = int(binSize)
        self.drawSameX = bool(drawSameX)
        self.numTrials = int(numTrials)
        self.xdim = int(xdim)
        self.ydim = int(ydim)
        self.seed = int(seed)
        self.T = int(trialDur // binSize)

        rng = np.random.default_rng(self.seed)
        if params is None:
            params = sample_params_numpy(
                rng, xdim, ydim, d_offset=dOffset, fixed_tau=fixedTau if fixTau else None,
            )
        self.params = {
            "C": np.asarray(params["C"]),
            "d": np.asarray(params["d"]).reshape(-1),
            "tau": np.asarray(params["tau"]).reshape(-1),
        }
        X, Y = sample_trials_numpy(
            rng, self.params, self.numTrials, self.T, float(self.binSize), drawSameX
        )
        self.X = np.asarray(X)
        self.Y = np.asarray(Y)
        self.data = [{"X": self.X[r], "Y": self.Y[r]} for r in range(self.numTrials)]

        self.getAvgFiringRate()
        self.getAllRaster()
        self.getMeanAndVariance()
        try:
            self.fitPolynomialToMeanVar()
        except (RuntimeError, TypeError, ValueError):  # too few or degenerate points; diagnostic only
            self.curve_p = None
            self.curve_p_cov = None

    # -- statistics ----------------------------------------------------------

    def getAvgFiringRate(self):
        """Per-neuron firing rate in Hz (``avgFR``) and the total count."""
        totals = self.Y.sum(axis=(0, 2))
        self.avgFR = totals / self.numTrials / (self.trialDur / 1000.0)
        self.totalSpkCt = float(self.Y.sum())
        return self.avgFR

    def getAllRaster(self):
        """``(ydim, R*T)``: the trials concatenated along time."""
        self.all_raster = np.concatenate([self.Y[r] for r in range(self.numTrials)], axis=1)
        return self.all_raster

    def getMeanAndVariance(self):
        """Per-(neuron, trial) mean and variance over time bins, ``(ydim, R)``."""
        self.means = self.Y.mean(axis=2).T
        self.variances = self.Y.var(axis=2).T

    def fitPolynomialToMeanVar(self):
        """Least-squares ``variance = a mean^b`` over the (neuron, trial)
        pairs (``curve_p = (a, b)``, ``curve_p_cov``)."""
        import scipy.optimize as sopt

        m = self.means.reshape(-1)
        v = self.variances.reshape(-1)
        p, cov = sopt.curve_fit(lambda x, a, b: a * x**b, m, v, maxfev=100000)
        self.curve_p = p
        self.curve_p_cov = cov

    # -- plots (matplotlib, imported when drawn) --------------------------------

    def plotTrajectory(self, trialToShow: int = 0):
        from pgpfa_torch.diag.plotting import plot_dataset_trajectory

        return plot_dataset_trajectory(self, trialToShow)

    def plotParams(self):
        from pgpfa_torch.diag.plotting import plot_dataset_params

        return plot_dataset_params(self)

    def plotMeanVsVariance(self):
        from pgpfa_torch.diag.plotting import plot_mean_vs_variance

        return plot_mean_vs_variance(self)


def stack_experiment(experiment) -> np.ndarray:
    """Stack any reference-style experiment (``.data[r]['Y']``) to ``(R, ydim, T)``."""
    if isinstance(getattr(experiment, "Y", None), np.ndarray):
        return experiment.Y
    return np.stack([np.asarray(tr["Y"]) for tr in experiment.data], axis=0)
