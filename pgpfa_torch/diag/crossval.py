"""Cross-validated latent-dimensionality selection (PyTorch port of
``pgpfa/diag/crossval.py``).

Split the trials into a training and a test set, fit every ``xdim`` in
``1..maxXdim`` on the training trials (:func:`pgpfa_torch.fit`), score each
fit by the leave-one-neuron-out prediction error on the test trials, and
pick the argmin. The class surface is the JAX package's (``optimXdim``,
``errs``, ``fits``, ``plotPredictionError``).

``pad_xdim=True`` (the default, as in the JAX package) embeds every sweep
point in the ``maxXdim`` shape with zero trailing columns of ``C`` and dummy
timescales, so the port's default sweep computes what the JAX package's
computes. The embedding is exact: with ``C[:, k:] = 0`` and zero starting
modes the extra latents decouple. The Hessian's cross blocks are exact
zeros, and so are the cross blocks of its f32 factor (zeros propagate
exactly through the factorization, ``chol32``'s register-tiled update
included) and the extra latents' gradients, modes and (C, d) Newton steps;
the extra latents' posterior second moment is their prior, a fixed point of
the timescale M-step. The recorded fits have the padding stripped.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from pgpfa_torch.data.init import initialize_params
from pgpfa_torch.data.synthetic import stack_experiment
from pgpfa_torch.diag.loo import leave_one_out_prediction
from pgpfa_torch.em.fit import FitConfig, fit
from pgpfa_torch.models.params import Params


def split_train_test(experiment, num_training: int, num_test: int):
    """The first ``num_training`` trials and the next ``num_test``, as two
    shallow copies of ``experiment``."""
    if num_training + num_test > experiment.numTrials:
        raise ValueError(
            "numTrainingTrials + numTestTrials must not exceed the number of trials"
        )
    train = copy.copy(experiment)
    test = copy.copy(experiment)
    train.data = experiment.data[:num_training]
    train.numTrials = num_training
    if hasattr(train, "Y"):
        train.Y = experiment.Y[:num_training]
    test.data = experiment.data[num_training : num_training + num_test]
    test.numTrials = num_test
    if hasattr(test, "Y"):
        test.Y = experiment.Y[num_training : num_training + num_test]
    return train, test


def _pad_init(init, ydim: int, pad_to: int):
    """Embed an xdim-k init in the ``pad_to`` shape: zero C columns, dummy
    timescales of 0.1 s."""
    C = np.asarray(init["C"])
    k = C.shape[1]
    if k == pad_to:
        return init
    return {
        "C": np.concatenate([C, np.zeros((ydim, pad_to - k), dtype=C.dtype)], axis=1),
        "d": np.asarray(init["d"]),
        "tau": np.concatenate(
            [np.ravel(np.asarray(init["tau"])), np.full(pad_to - k, 0.1)]
        ),
    }


class crossValidation:
    """Sweep xdim = 1..maxXdim; score by the leave-one-neuron-out prediction
    error on the held-out trials.

    ``learningMethod`` is ``'batch'`` or an online update rule (``'diag'``,
    ``'hess'``, ``'grad'``, ...); an online fit draws its minibatches with
    :func:`pgpfa_torch.draw_batch_indices` from ``seed``, not with the JAX
    package's ``jax.random`` stream. ``device`` and ``dtype`` are
    :func:`pgpfa_torch.fit`'s: the card unless the caller passes
    ``device="cpu"``.
    """

    def __init__(
        self,
        experiment,
        numTrainingTrials: int = 10,
        numTestTrials: int = 2,
        maxXdim: int = 6,
        maxEMiter: int = 3,
        batchSize: int = 5,
        inferenceMethod: str = "laplace",
        learningMethod: str = "batch",
        seed: int = 0,
        verbose: bool = False,
        pad_xdim: bool = True,
        device="cuda",
        dtype=torch.float64,
    ):
        train, test = split_train_test(experiment, numTrainingTrials, numTestTrials)
        Y_train = stack_experiment(train)
        Y_test = stack_experiment(test)
        bin_ms = float(experiment.binSize)

        errs, fits = [], []
        for xdim in range(1, maxXdim + 1):
            if verbose:
                print(f"crossValidation: fitting xdim={xdim}/{maxXdim}")
            init = initialize_params(xdim, train.ydim, train, seed=seed)
            if pad_xdim:
                init = _pad_init(init, train.ydim, maxXdim)
            if learningMethod == "batch":
                cfg = FitConfig(
                    inference_method=inferenceMethod, em_mode="batch",
                    max_em_iter=maxEMiter,
                )
            else:
                cfg = FitConfig(
                    inference_method=inferenceMethod, em_mode="online",
                    online_update=learningMethod, max_em_iter=maxEMiter,
                    batch_size=min(batchSize, numTrainingTrials),
                )
            res = fit(init, Y_train, bin_ms, cfg, device=device, dtype=dtype, seed=seed)
            # scored at the padded shape: the zero columns predict nothing
            _, err = leave_one_out_prediction(Params(res.C, res.d, res.tau), Y_test, bin_ms)
            errs.append(err)
            if pad_xdim and xdim < maxXdim:
                res = res._replace(
                    C=res.C[:, :xdim], tau=res.tau[:xdim],
                    C_seq=res.C_seq[:, :, :xdim], tau_seq=res.tau_seq[:, :xdim],
                    tau_cost=res.tau_cost[:, :xdim], tau_niter=res.tau_niter[:, :xdim],
                )
            fits.append(res)

        self.inferenceMethod = inferenceMethod
        self.learningMethod = learningMethod
        self.errs = errs
        self.fits = fits
        self.maxXdim = maxXdim
        self.optimXdim = int(np.argmin(errs)) + 1

    def plotPredictionError(self):
        from pgpfa_torch.diag.plotting import plot_cv_prediction_error

        return plot_cv_prediction_error(self)
