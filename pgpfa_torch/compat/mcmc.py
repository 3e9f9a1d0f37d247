"""Shim for the reference's ``funs/mcmc.py``."""

import numpy as np
import torch


def PosteriorMCMC(experiment, params, maxSampleIter, trial, seed: int = 0, device="cuda",
                  dtype=torch.float64):
    """Reference signature (``funs/mcmc.py:9``): returns the raw sample array
    ``(maxSampleIter, xdim*T)`` for one trial's latent posterior.

    The chain is :func:`pgpfa_torch.posterior_mcmc_from_arrays` on
    ``device``, its draws from the port's stream seeded with ``seed``, not
    from ``jax.random``: it matches the JAX package's chain in shape and
    moments, and the port's own exactly."""
    from pgpfa_torch.data.synthetic import stack_experiment
    from pgpfa_torch.infer.mcmc import posterior_mcmc_from_arrays

    Y = stack_experiment(experiment)
    C, d, tau = (torch.as_tensor(np.asarray(params[k], dtype=float), dtype=dtype, device=device)
                 for k in ("C", "d", "tau"))
    res = posterior_mcmc_from_arrays(
        C, d.reshape(-1), tau.reshape(-1), torch.as_tensor(Y[trial], dtype=dtype, device=device),
        Y.shape[-1], float(experiment.binSize), n_samples=maxSampleIter, seed=seed,
        device=device)
    n = res.samples.shape[0]
    return res.samples.reshape(n, -1).cpu().numpy()
