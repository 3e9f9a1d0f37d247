"""pgpfa_torch — Poisson Gaussian-Process Factor Analysis in PyTorch for NVIDIA Hopper.

A port of the JAX package ``pgpfa`` (which stays the reference): batch and
online EM (all six online update rules, ``FitConfig(em_mode="online")``)
with the Laplace or the dual variational E-step (dual-Newton or L-BFGS
solver), with checkpoint and resume (``fit_loop``), and elliptical-slice
MCMC of the latent posterior (``posterior_mcmc*``), with the f32 factorization and the f32 Newton-Schulz step of its
mixed-precision solvers as hand-written CUDA kernels
(``pgpfa_torch/csrc/``). Every function works on tensors of one device:
on a CUDA device the kernels run, on the CPU their plain PyTorch versions.
The entry points that take arrays (``fit``, ``fit_loop``,
``posterior_mcmc_from_arrays``, ``posterior_mcmc_batched``,
``params_from_numpy``, ``convert.to_tensor``) put them on the card unless the caller passes
``device="cpu"``; nothing falls back to the CPU when there is no card. The
default dtype is float64. Nothing here imports JAX.

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
from pgpfa_torch.data.init import initialize_params  # noqa: E402
from pgpfa_torch.data.surrogate import stevenson_surrogate  # noqa: E402
from pgpfa_torch.data.synthetic import dataset  # noqa: E402
from pgpfa_torch.em.fit import (  # noqa: E402
    ONLINE_UPDATE_METHODS,
    FitConfig,
    FitResult,
    draw_batch_indices,
    fit,
    fit_loop,
)
from pgpfa_torch.infer.mcmc import (  # noqa: E402
    ESSResult,
    posterior_mcmc,
    posterior_mcmc_batched,
    posterior_mcmc_from_arrays,
)
from pgpfa_torch.models.params import Params  # noqa: E402

__all__ = [
    "dataset",
    "initialize_params",
    "stevenson_surrogate",
    "Params",
    "FitConfig",
    "FitResult",
    "ONLINE_UPDATE_METHODS",
    "draw_batch_indices",
    "fit",
    "fit_loop",
    "ESSResult",
    "posterior_mcmc",
    "posterior_mcmc_batched",
    "posterior_mcmc_from_arrays",
    "params_from_numpy",
    "params_to_numpy",
]
