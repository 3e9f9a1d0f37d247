"""Conversions between NumPy arrays (the JAX package's ``Params.to_dict()``
form, or any ``{'C','d','tau'}`` dict) and the port's tensors."""

from __future__ import annotations

import numpy as np
import torch

from pgpfa_torch.models.params import Params


def to_tensor(a, device="cuda", dtype=torch.float64) -> torch.Tensor:
    """An array (e.g. warm-start modes ``x_init``) as a tensor on ``device``
    (the card unless the caller asks for the CPU)."""
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on any device as a NumPy array."""
    return t.detach().cpu().numpy()


def params_from_numpy(p, device="cuda", dtype=torch.float64) -> Params:
    """``{'C', 'd', 'tau'}`` arrays -> :class:`Params` on ``device`` (the
    card unless the caller asks for the CPU)."""
    return Params(
        C=to_tensor(p["C"], device, dtype),
        d=to_tensor(p["d"], device, dtype).reshape(-1),
        tau=to_tensor(p["tau"], device, dtype).reshape(-1),
    )


def params_to_numpy(p: Params) -> dict:
    """:class:`Params` -> ``{'C', 'd', 'tau'}`` NumPy arrays."""
    return {"C": to_numpy(p.C), "d": to_numpy(p.d), "tau": to_numpy(p.tau)}
