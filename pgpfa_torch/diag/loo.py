"""Leave-one-neuron-out prediction (PyTorch port of ``pgpfa/diag/loo.py``).

For every (trial, neuron) pair the latent posterior mode is refit with that
neuron left out, and the held-out neuron's rate ``exp(C_n x_hat + d_n)`` is
its prediction. As in the JAX package, the neuron is left out by a zero in a
per-neuron likelihood weight, not by deleting its row (the objective is the
same), so every pair is one lane of the Laplace E-step's masked Newton solve
from zero modes, with ``K^{-1}`` from ``blocks_inv``.

The JAX package solves all ``R * ydim`` lanes at once; here they run in
chunks of whole lanes, one masked Newton solve per chunk, sized up front so
that a chunk's ``(lanes, xdim*T, xdim*T)`` f32 Hessians and factors stay
under half the device's free memory. Lanes are independent (a finished lane
keeps its state), so the result does not depend on the chunk size. A chunk
gathers each lane's ``(ydim, T)`` counts from its trial (a chunk's lanes span
several trials, which no strided view of ``Y`` can map), ``ydim * T`` values
per lane against the ``(xdim*T)^2`` of each of its factors.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from pgpfa_torch.convert import params_from_numpy, to_numpy
from pgpfa_torch.data.synthetic import stack_experiment
from pgpfa_torch.infer.laplace import _newton_solve
from pgpfa_torch.models.params import Params, rbf_kernel
from pgpfa_torch.ops.blockmat import blocks_inv

# f32 (D, D) arrays per lane reckoned for a chunk's peak: at a Newton body's
# peak three are alive (the carried factor, the new Hessian or the
# torch.where copy that keeps a finished lane's factor, and the new factor);
# the rest covers the lane's (ydim, T) f64 arrays (its gathered counts, the
# rates and their line-search copies) and the allocator's rounding.
_LANE_D2_ARRAYS = 5


def _free_bytes(device: torch.device) -> int:
    """Memory free for new tensors on ``device``: on the card the CUDA driver's
    free memory plus what PyTorch's allocator holds unused; on the CPU the
    available physical memory."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def chunk_lanes(D: int, device) -> int:
    """Lanes per chunk at latent width ``D = xdim * T``: the most whose
    ``_LANE_D2_ARRAYS`` f32 ``(D, D)`` arrays each fit in half the free
    memory of ``device``, at least one."""
    per_lane = _LANE_D2_ARRAYS * 4 * D * D
    return max(1, _free_bytes(torch.device(device)) // 2 // per_lane)


def _loo_lanes(C, d, Kinv, Y, lanes, gtol: float = 1e-8, maxiter: int = 100):
    """Predictions ``(len(lanes), T)`` of the lanes ``lanes`` (a tensor of
    lane indices; lane ``l`` is trial ``l // ydim``, neuron ``l % ydim``) as
    one masked Newton solve from zero modes."""
    ydim, xdim = C.shape
    r, n = lanes // ydim, lanes % ydim
    w = 1.0 - torch.nn.functional.one_hot(n, ydim).to(C.dtype)  # leaves neuron n out
    X0 = torch.zeros((lanes.shape[0], xdim, Y.shape[-1]), dtype=C.dtype, device=C.device)
    X = _newton_solve(Y[r], X0, C, d, Kinv, w, gtol, maxiter)[0]
    return torch.exp(torch.einsum("bk,bkt->bt", C[n], X) + d[n][:, None])


def _loo_predict(C, d, tau, Y, T: int, bin_size_ms: float, gtol: float = 1e-8,
                 maxiter: int = 100, lanes_per_chunk: Optional[int] = None):
    """Predictions ``(R, ydim, T)`` and the summed squared error (a 0-d
    tensor), on the device and in the dtype of ``C``, all lanes in chunks of
    ``lanes_per_chunk`` (default :func:`chunk_lanes`)."""
    R, ydim, _ = Y.shape
    Kinv = blocks_inv(rbf_kernel(tau, T, bin_size_ms))
    n_lanes = R * ydim
    chunk = lanes_per_chunk or chunk_lanes(C.shape[1] * T, C.device)
    preds = torch.cat([
        _loo_lanes(C, d, Kinv, Y, torch.arange(l0, min(l0 + chunk, n_lanes), device=C.device),
                   gtol, maxiter)
        for l0 in range(0, n_lanes, chunk)
    ]).reshape(R, ydim, T)
    return preds, ((Y - preds) ** 2).sum()


def leave_one_out_prediction(params, Y, bin_size_ms: float, device="cuda",
                             dtype=torch.float64, _lanes_per_chunk: Optional[int] = None):
    """Leave-one-neuron-out rate predictions and their total squared error.

    Args:
        params: ``{'C', 'd', 'tau'}`` arrays (put on ``device`` in
            ``dtype``), or a :class:`Params` (run where its tensors are).
        Y: counts ``(R, ydim, T)`` (array or tensor), or a reference-style
            experiment.
        device, dtype: where and in what precision (see
            :func:`pgpfa_torch.fit`); the card unless the caller passes
            ``device="cpu"``.
        _lanes_per_chunk: lanes per Newton solve instead of
            :func:`chunk_lanes`'s (for tests).

    Returns:
        ``(y_pred, pred_err)``: NumPy ``(R, ydim, T)`` and a float.
    """
    if not isinstance(Y, (np.ndarray, torch.Tensor)):
        Y = stack_experiment(Y)
    p = params if isinstance(params, Params) else params_from_numpy(params, device, dtype)
    Yt = torch.as_tensor(Y, dtype=p.C.dtype, device=p.C.device)
    preds, err = _loo_predict(p.C, p.d, p.tau, Yt, Yt.shape[-1], float(bin_size_ms),
                              lanes_per_chunk=_lanes_per_chunk)
    return to_numpy(preds), float(err)
