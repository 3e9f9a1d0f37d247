"""pgpfa_torch — Poisson Gaussian-Process Factor Analysis in PyTorch for NVIDIA Hopper.

A port of the JAX package ``pgpfa`` (which stays the reference): batch and
online EM (all six online update rules, ``FitConfig(em_mode="online")``)
with the Laplace or the dual variational E-step (dual-Newton or L-BFGS
solver), dense or, for long trials, on banded block-tridiagonal algebra
(``FitConfig(time_block=...)``), with checkpoint and resume
(``fit_loop``), on one process or with the trials split over processes
(``fit_sharded``, :mod:`pgpfa_torch.parallel`, batch and online); the
reference-compatible class driver ``PPGPFAfit`` with its fit diagnostics,
leave-one-neuron-out prediction (``leave_one_out_prediction``) and the
cross-validated latent-dimension sweep (``crossValidation``);
elliptical-slice MCMC of the latent posterior (``posterior_mcmc*``); the
real-data loaders (:mod:`pgpfa_torch.data.loaders`); and the reference's
module layout (:mod:`pgpfa_torch.compat`, imported on its own). The f32 factorization and the
f32 Newton-Schulz step of its mixed-precision solvers are hand-written CUDA
kernels (``pgpfa_torch/csrc/``). Every function works on tensors of one
device: on a CUDA device the kernels run, on the CPU their plain PyTorch
versions. The entry points that take arrays (``fit``, ``fit_loop``,
``PPGPFAfit``, ``crossValidation``, ``leave_one_out_prediction``,
``cd_error_bars``, ``posterior_mcmc_from_arrays``, ``posterior_mcmc_batched``,
``params_from_numpy``, ``convert.to_tensor``) put them on the card unless
the caller passes ``device="cpu"``; nothing falls back to the CPU when there
is no card. The default dtype is float64. Nothing here imports JAX, and
matplotlib is imported only when a plot is drawn.

Model::

    x ~ GP(0, K(tau))           per-latent RBF kernel over time bins
    y ~ Poisson(exp(C x + d))   exponential-link spike counts
"""

import torch as _torch

# Full-f32 matmuls on the card: at TF32 precision the f32 Newton-Schulz and
# correction products of the mixed-precision solvers would floor at ~1e-3
# instead of ~1e-7 (the counterpart of pgpfa's "highest" matmul precision).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from pgpfa_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from pgpfa_torch.data.batching import seen_trials, subsample_trials  # noqa: E402
from pgpfa_torch.data.init import initialize_params  # noqa: E402
from pgpfa_torch.data.surrogate import stevenson_surrogate  # noqa: E402
from pgpfa_torch.data.synthetic import dataset  # noqa: E402
from pgpfa_torch.diag.crossval import crossValidation, split_train_test  # noqa: E402
from pgpfa_torch.diag.loo import leave_one_out_prediction  # noqa: E402
from pgpfa_torch.diag.metrics import (  # noqa: E402
    cd_error_bars,
    js_logdet_div,
    mean_cov_y_from_params,
    mvnpdf,
    mvnpdf_use_inv_cov,
    orthonormalized_trajectories,
    subspace_angle,
)
from pgpfa_torch.em.fit import (  # noqa: E402
    ONLINE_UPDATE_METHODS,
    FitConfig,
    FitResult,
    PPGPFAfit,
    draw_batch_indices,
    fit,
    fit_loop,
)
from pgpfa_torch.infer.laplace import laplace_estep, laplace_estep_from_arrays  # noqa: E402
from pgpfa_torch.infer.mcmc import (  # noqa: E402
    ESSResult,
    posterior_mcmc,
    posterior_mcmc_batched,
    posterior_mcmc_from_arrays,
)
from pgpfa_torch.infer.variational import vi_estep, vi_estep_from_arrays  # noqa: E402
from pgpfa_torch.models.params import Params, pack_cd, rbf_kernel, unpack_cd  # noqa: E402
from pgpfa_torch.parallel.sharded import fit_sharded  # noqa: E402
from pgpfa_torch.utils.io import (  # noqa: E402
    load_checkpoint,
    open_variables,
    save_checkpoint,
    save_variables,
)

# reference-API aliases (the reference's funs/util.py names)
initializeParams = initialize_params
subsampleTrials = subsample_trials
seenTrials = seen_trials
saveVariables = save_variables
openVariables = open_variables
leaveOneOutPrediction = leave_one_out_prediction
subspaceAngle = subspace_angle
JSLogdetDiv = js_logdet_div
getMeanCovYfromParams = mean_cov_y_from_params
splitTrainingTestDataset = split_train_test

__all__ = [
    "dataset",
    "initialize_params",
    "initializeParams",
    "stevenson_surrogate",
    "subsample_trials",
    "subsampleTrials",
    "seen_trials",
    "seenTrials",
    "Params",
    "pack_cd",
    "unpack_cd",
    "rbf_kernel",
    "FitConfig",
    "FitResult",
    "ONLINE_UPDATE_METHODS",
    "draw_batch_indices",
    "fit",
    "fit_loop",
    "fit_sharded",
    "PPGPFAfit",
    "laplace_estep",
    "laplace_estep_from_arrays",
    "vi_estep",
    "vi_estep_from_arrays",
    "leave_one_out_prediction",
    "leaveOneOutPrediction",
    "crossValidation",
    "split_train_test",
    "splitTrainingTestDataset",
    "subspace_angle",
    "subspaceAngle",
    "js_logdet_div",
    "JSLogdetDiv",
    "mean_cov_y_from_params",
    "getMeanCovYfromParams",
    "cd_error_bars",
    "mvnpdf",
    "mvnpdf_use_inv_cov",
    "orthonormalized_trajectories",
    "ESSResult",
    "posterior_mcmc",
    "posterior_mcmc_batched",
    "posterior_mcmc_from_arrays",
    "params_from_numpy",
    "params_to_numpy",
    "save_variables",
    "open_variables",
    "save_checkpoint",
    "load_checkpoint",
]
