"""Plotting suite (matplotlib, host-side; port of ``pgpfa/diag/plotting.py``).

Dataset plots, fit plots, raster and axis helpers and the leave-one-out
prediction plot. Every function returns its figure so callers can save or
show it. matplotlib is imported only when a plot is drawn, so the port
imports and fits without it; a fit's tensors are copied to the host first.
"""

from __future__ import annotations

import numpy as np

from pgpfa_torch.convert import to_numpy
from pgpfa_torch.data.synthetic import rbf_kernel_numpy


def _plt():
    import matplotlib.pyplot as plt

    return plt


def simple_axis(ax):
    """Hide the top and right spines."""
    ax.spines["top"].set_visible(False)
    ax.spines["right"].set_visible(False)
    ax.get_xaxis().tick_bottom()
    ax.get_yaxis().tick_left()


def raster(event_times_list, color="k"):
    """Spike-time raster plot."""
    plt = _plt()
    ax = plt.gca()
    for i, trial in enumerate(event_times_list):
        plt.vlines(trial, i + 0.5, i + 1.5, color=color)
    plt.ylim(0.5, len(event_times_list) + 0.5)
    return ax


# ---------------------------------------------------------------- dataset


def plot_dataset_trajectory(ds, trial: int = 0):
    plt = _plt()
    fig, (ax0, ax1) = plt.subplots(nrows=2, sharex=True, figsize=(5, 4))
    ax0.imshow(ds.data[trial]["Y"], interpolation="nearest", aspect="auto", cmap="gray_r")
    ax0.set_ylabel("Neuron Index")
    ax0.set_title("Binned Spike Counts")
    ax1.plot(np.arange(ds.T), ds.data[trial]["X"].T, linewidth=2)
    ax1.set_xlabel(f"Time ({ds.binSize} ms bins)")
    ax1.set_title("Ground Truth Latent Trajectory")
    ax1.set_xlim([0, ds.T])
    ax1.grid(which="both")
    fig.tight_layout()
    return fig


def plot_dataset_params(ds):
    plt = _plt()
    import scipy.linalg as sla

    fig = plt.figure(figsize=(6, 4))
    gs = fig.add_gridspec(2, 2)
    ax_c = fig.add_subplot(gs[0, 0])
    ax_d = fig.add_subplot(gs[1, 0])
    ax_k = fig.add_subplot(gs[:, 1])
    ax_c.imshow(np.asarray(ds.params["C"]).T, interpolation="nearest", aspect="auto")
    ax_c.set_title("$C_{true}$")
    ax_c.set_xlabel("Neuron Index")
    ax_c.set_ylabel("Latent Index")
    ax_d.plot(np.asarray(ds.params["d"]))
    ax_d.set_title("$d_{true}$")
    ax_d.set_xlabel("Neuron Index")
    K = rbf_kernel_numpy(ds.params["tau"], ds.T, float(ds.binSize))
    ax_k.imshow(sla.block_diag(*K), interpolation="nearest")
    ax_k.set_title(r"$K(\tau_{true})$")
    fig.tight_layout()
    return fig


def plot_mean_vs_variance(ds):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(4, 4))
    m, v = ds.means.reshape(-1), ds.variances.reshape(-1)
    hi = max(m.max(), v.max())
    ax.plot(m, v, ".")
    line = np.linspace(1e-2, hi, 20)
    ax.plot(line, line, "g", linewidth=1)
    if getattr(ds, "curve_p", None) is not None:
        ax.plot(line, ds.curve_p[0] * line ** ds.curve_p[1], "r", linewidth=1)
        ax.legend(
            ["Neuron/Trial", "x=y", f"$ax^b$, a={ds.curve_p[0]:.2f} b={ds.curve_p[1]:.2f}"],
            frameon=False, fontsize=9,
        )
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlim([1e-2, hi])
    ax.set_ylim([1e-2, hi])
    ax.set_xlabel("Mean Spike Count")
    ax.set_ylabel("Variance of Spike Count")
    ax.grid(which="major")
    simple_axis(ax)
    fig.tight_layout()
    return fig


# -------------------------------------------------------------------- fit


def plot_fit_trajectory(fit, trial: int = 0):
    """Inferred trajectory (+/- posterior sd), ground truth if simulated,
    and the trial's spike counts."""
    plt = _plt()
    has_truth = hasattr(fit.experiment, "xdim") and "X" in getattr(
        fit.experiment, "data", [{}]
    )[0]
    nrows = 3 if has_truth else 2
    fig, axes = plt.subplots(nrows=nrows, figsize=(4, 2 * nrows), sharex=True)
    ax0, rest = axes[0], axes[1:]
    mean = to_numpy(fit._inf.post_mean[trial])  # (xdim, T)
    sd = np.sqrt(np.diagonal(to_numpy(fit._inf.post_vsm_gp[trial]), axis1=1, axis2=2))
    t = np.arange(fit.T)
    for k in range(fit.xdim):
        ax0.plot(t, mean[k])
        ax0.fill_between(t, mean[k] - sd[k], mean[k] + sd[k], alpha=0.15)
    ax0.set_title(f"Latent trajectory ({fit.inferenceMethod})")
    ax0.grid(which="both")
    if has_truth:
        rest[0].plot(np.asarray(fit.experiment.data[trial]["X"]).T)
        rest[0].set_title("Ground truth trajectory")
        rest[0].grid(which="both")
    ax2 = rest[-1]
    im = ax2.imshow(fit._Y[trial], interpolation="nearest", aspect="auto", cmap="Greys")
    ax2.set_title("Spike counts")
    ax2.set_ylabel("Neuron Index")
    ax2.set_xlabel(f"Time ({fit.binSize:g} ms bin)")
    fig.tight_layout()
    return fig


def plot_fit_trajectories(fit):
    """All trials' inferred trajectories, per latent (+3-D if xdim>=3)."""
    plt = _plt()
    means = getattr(fit, "x_tilde", None)
    if means is None:
        means = to_numpy(fit._inf.post_mean)
    figs = []
    if fit.xdim == 1:
        fig, ax = plt.subplots(figsize=(5, 5))
        for r in range(means.shape[0]):
            ax.plot(means[r, 0], "k")
        ax.set_title("xdim 1")
        ax.set_xlabel("Time")
        figs.append(fig)
    else:
        fig, axes = plt.subplots(ncols=fit.xdim, sharey=True, figsize=(5, 5))
        for r in range(means.shape[0]):
            for k in range(fit.xdim):
                axes[k].plot(means[r, k], "k")
                axes[k].set_title(f"xdim {k}")
                axes[k].set_xlabel("Time")
        fig.tight_layout()
        figs.append(fig)
        if fit.xdim >= 3:
            fig3 = plt.figure(figsize=(5, 5))
            ax3 = fig3.add_subplot(projection="3d")
            for r in range(means.shape[0]):
                ax3.plot(means[r, 0], means[r, 1], means[r, 2], "k.-")
            ax3.set_xlabel("xdim1")
            ax3.set_ylabel("xdim2")
            ax3.set_zlabel("xdim3")
            figs.append(fig3)
    return figs[0] if len(figs) == 1 else figs


def plot_param_seq(fit):
    """2x2 fit-progress grid."""
    plt = _plt()
    simulated = hasattr(fit.experiment, "params")
    if simulated:
        fig, ax = plt.subplots(ncols=2, nrows=2, figsize=(9, 6))
        ax[0][0].plot(fit.meanSquaredErrorOverTrueVariance_SM, linewidth=3, alpha=0.7, color="g")
        ax[0][0].set_ylabel("MSE(true-est)/Var(true)")
        ax[0][0].set_xlabel("EM iteration")
        ax[0][0].set_title("Error in Spike Count")
        ax[0][0].set_yscale("log")
        ax[0][0].grid(which="both")
        ax[0][1].plot(fit.subspaceAngleC, linewidth=3, alpha=0.7, color="g")
        ax[0][1].set_ylabel("Angle")
        ax[0][1].set_xlabel("EM iteration")
        ax[0][1].set_title("Error in Subspace")
        ax[0][1].grid(which="both")
        ax[1][0].plot(fit.expectedSpikeCountsEst[:, -1], linewidth=3, alpha=0.5)
        ax[1][0].plot(fit.sampleMeanSpikeCounts, linewidth=3, alpha=0.5)
        ax[1][0].set_title("Estimated & True Spike Counts")
        ax[1][0].set_xlabel("Neuron index")
        ax[1][0].legend(["$E[y|C,d]$", "Mean spike count"], fontsize=10)
        ax[1][0].grid(which="both")
        ax[1][1].plot(np.arange(fit.maxEMiter), fit.tauSeq.T, linewidth=3, alpha=0.9)
        if fit.experiment.xdim == fit.xdim:
            ax[1][1].plot(
                np.ones((fit.maxEMiter, fit.experiment.xdim)) * np.ravel(fit.experiment.params["tau"]),
                "k--",
            )
        ax[1][1].set_xlabel("EM Iteration")
        ax[1][1].set_title("Tau history")
        ax[1][1].set_ylim([0, None])
        ax[1][1].set_ylabel("Time [sec]")
        ax[1][1].grid(which="both")
    else:
        fig, (ax0, ax1, ax2) = plt.subplots(ncols=3, figsize=(12, 3))
        ax0.plot(fit.meanSquaredErrorOverTrueVariance_SM, linewidth=3, alpha=0.7, color="g")
        ax0.set_yscale("log")
        ax0.set_title("Error in Spike Count")
        ax0.grid(which="both")
        ax1.plot(fit.expectedSpikeCountsEst[:, -1], linewidth=3, alpha=0.5)
        ax1.plot(fit.sampleMeanSpikeCounts, linewidth=3, alpha=0.5)
        ax1.set_title("Estimated & Observed Spike Counts")
        ax1.grid(which="both")
        ax2.plot(np.arange(fit.maxEMiter), fit.tauSeq.T, linewidth=3, alpha=0.9)
        ax2.set_title("Tau history")
        ax2.set_ylim([0, None])
        ax2.grid(which="both")
    fig.tight_layout()
    return fig


def plot_fit_details(fit):
    """Likelihood/VLB + M-step cost curves."""
    plt = _plt()
    n_extra = 1 if fit.inferenceMethod == "variational" else 0
    fig = plt.figure(figsize=(5, 8))
    gs = fig.add_gridspec(3 + n_extra, fit.xdim)
    ax_pll = fig.add_subplot(gs[0, :])
    ax_pll.plot(fit.posteriorLikelihood, linewidth=3, alpha=0.7)
    ax_pll.set_title("Posterior log-likelihood")
    ax_pll.set_xlabel("EM iteration")
    ax_pll.grid(which="both")
    row = 1
    if n_extra:
        ax_vlb = fig.add_subplot(gs[1, :])
        ax_vlb.plot(fit.variationalLowerBound, linewidth=3, alpha=0.7)
        ax_vlb.set_title("Variational bound")
        ax_vlb.grid(which="both")
        row = 2
    ax_cd = fig.add_subplot(gs[row, :])
    ax_cd.plot([ld["Cd"] for ld in fit.learningDetails], linewidth=3, alpha=0.7)
    ax_cd.set_title("C,d learning cost")
    ax_cd.set_xlabel("EM iteration")
    ax_cd.grid(which="both")
    for k in range(fit.xdim):
        axk = fig.add_subplot(gs[row + 1, k])
        axk.plot([ld["tau"][k] for ld in fit.learningDetails], linewidth=3, alpha=0.7)
        axk.set_title(f"Tau xdim {k + 1} cost")
        axk.grid(which="both")
    fig.tight_layout()
    return fig


def plot_optim_params(fit):
    plt = _plt()
    import scipy.linalg as sla

    fig = plt.figure(figsize=(6, 4))
    gs = fig.add_gridspec(2, 2)
    ax_c = fig.add_subplot(gs[0, 0])
    ax_d = fig.add_subplot(gs[1, 0])
    ax_k = fig.add_subplot(gs[:, 1])
    ax_c.plot(fit.optimParams["C"], linewidth=2)
    ax_c.set_title("$C_{est}$")
    ax_c.set_xlabel("Neuron Index")
    ax_c.grid(which="both")
    ax_d.plot(fit.optimParams["d"])
    ax_d.set_title("$d_{est}$")
    ax_d.set_xlabel("Neuron Index")
    ax_d.grid(which="both")
    K = rbf_kernel_numpy(fit.optimParams["tau"], fit.T, float(fit.binSize))
    im = ax_k.imshow(sla.block_diag(*K), interpolation="nearest")
    ax_k.set_title(r"$K(\tau_{est})$")
    fig.colorbar(im, ax=ax_k, fraction=0.046)
    fig.tight_layout()
    return fig


def plot_param_comparison(fit):
    plt = _plt()
    fig, (ax_c, ax_d, ax_tau) = plt.subplots(nrows=3, figsize=(4.5, 8))
    ax_c.plot(fit.optimParams["C"], linewidth=3, alpha=0.6)
    if hasattr(fit.experiment, "params"):
        ax_c.plot(np.asarray(fit.experiment.params["C"]), linewidth=1, alpha=0.2)
    ax_c.set_title("Estimated C")
    ax_d.plot(fit.optimParams["d"], linewidth=3, alpha=0.6)
    if hasattr(fit.experiment, "params"):
        ax_d.plot(np.ravel(fit.experiment.params["d"]), linewidth=2, alpha=0.3)
    ax_d.set_title("Estimated d")
    ax_tau.bar(np.arange(1, fit.xdim + 1) - 0.25, np.ravel(fit.optimParams["tau"]), width=0.5)
    ax_tau.set_title("Estimated Taus")
    ax_tau.set_xlabel("Latent Dimension")
    ax_tau.set_ylabel("Timescale (seconds)")
    fig.tight_layout()
    return fig


def plot_cov_analysis(fit):
    """Observed vs model-implied spike-count covariance grids."""
    plt = _plt()
    mats = [("obs", fit.E_yy_obs), ("init", fit.E_yy_init_params), ("optim", fit.E_yy_optim_params)]
    if hasattr(fit, "E_yy_true_params"):
        mats.insert(1, ("true", fit.E_yy_true_params))
    vmin = min(m.min() for _, m in mats)
    vmax = max(m.max() for _, m in mats)
    fig, axes = plt.subplots(ncols=len(mats), figsize=(3 * len(mats), 3))
    for ax, (name, m) in zip(axes, mats):
        im = ax.matshow(m, vmin=vmin, vmax=vmax)
        ax.set_title(rf"$\mathbf{{Cov}}[y_{{{name}}}]$")
        simple_axis(ax)
    fig.colorbar(im, ax=list(axes), fraction=0.02)
    return fig


def plot_lno_prediction(fit, trial: int = 0, neuron: int = 0):
    plt = _plt()
    fig = plt.figure(figsize=(5, 4))
    plt.plot(fit.y_pred_mode[trial, neuron], linewidth=3)
    plt.stem(fit._Y[trial][neuron])
    plt.title(f"Leave One Out Prediction: trial {trial + 1} neuron {neuron + 1}")
    plt.xlabel(f"Time ({fit.binSize:g} ms bin)")
    plt.ylabel("Spike Counts")
    fig.tight_layout()
    return fig


def plot_loo_prediction(pred, Y, bin_size_ms, trial: int = 0, neuron: int = 0):
    """Standalone leave-one-out prediction plot."""
    plt = _plt()
    fig = plt.figure(figsize=(5, 4))
    plt.plot(pred[trial][neuron], linewidth=2)
    plt.plot(np.asarray(Y)[trial][neuron], ".", markersize=10)
    plt.xlabel(f"Time ({bin_size_ms:g} ms bins)")
    plt.ylabel("Spike Counts")
    plt.legend(["Prediction", "True"])
    plt.title(f"LNO prediction, trial {trial}, neuron {neuron}")
    plt.grid(which="both")
    fig.tight_layout()
    return fig


def plot_cv_prediction_error(cv):
    """Latent-dim vs prediction error."""
    plt = _plt()
    fig = plt.figure(figsize=(5, 4))
    plt.plot(np.arange(1, cv.maxXdim + 1), cv.errs, "b.-", markersize=5, linewidth=2)
    plt.legend([cv.learningMethod], fontsize=9, framealpha=0.2)
    plt.xlabel("Latent Dimensionality")
    plt.ylabel("Error")
    plt.title("Latent Dimension vs. Prediction Error")
    plt.grid(which="both")
    fig.tight_layout()
    return fig
