"""Shim for the reference's ``funs/datamanager.py``."""

from pgpfa_torch.data.loaders import MATLABdataset, StevensonDataset  # noqa: F401
