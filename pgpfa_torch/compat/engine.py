"""Shim for the reference's ``funs/engine.py`` (the fit class; ``device``
and ``dtype`` keywords as :func:`pgpfa_torch.fit`)."""

from pgpfa_torch.em.fit import PPGPFAfit  # noqa: F401
