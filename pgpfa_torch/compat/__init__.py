"""Reference-compatible module layout (port of ``pgpfa/compat``).

``mackelab/poisson-gpfa`` exposes ``funs.engine`` / ``funs.util`` /
``funs.inference`` / ``funs.learning`` / ``funs.mcmc`` / ``funs.datamanager``;
these shims mirror that layout and its public names, so reference user code
runs on the card with an import swap::

    # before:  import funs.util as util;  import funs.engine as engine
    from pgpfa_torch.compat import util, engine

    train = util.dataset(xdim=2, ydim=20, numTrials=5, ...)
    fit = engine.PPGPFAfit(experiment=train, initParams=util.initializeParams(2, 20, train))

NumPy in, NumPy out, the reference's dict-of-lists ``infRes``. Every shim
that runs an E-step, an M-step, a fit or MCMC takes ``device`` (the card
unless the caller passes ``device="cpu"``) and ``dtype`` (``torch.float64``
by default) and runs the port's functions; the objectives over the
reference's dense ``C_big`` / ``K_big`` arguments are NumPy, as there.
"""

from pgpfa_torch.compat import datamanager, engine, inference, learning, mcmc, util  # noqa: F401

__all__ = ["engine", "util", "inference", "learning", "mcmc", "datamanager"]
