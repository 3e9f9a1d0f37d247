"""Hand-written CUDA kernels of the f32 stages of the mixed-precision stack.

Counterpart of ``pgpfa/ops/pallas_kernels.py`` (and of the Cholesky probe in
``scripts/exp_pallas_chol.py``). Each kernel has

* a wrapper (:func:`ns_step`, :func:`chol32`) that checks its inputs and
  launches the kernel on PyTorch's current stream for a CUDA tensor, or runs
  the plain version for a CPU tensor; on CUDA it launches or raises, there is
  no fallback;
* a plain PyTorch version (:func:`ns_step_plain`, :func:`chol32_plain`), used
  by the CPU path and by the tests that hold the kernel against it;
* a count of launches, ``<wrapper>.launches``, raised by one for each kernel
  launch and by nothing else, and the same count by shape,
  ``<wrapper>.launches_by_shape[(B, D)]``.

The kernels compute in full f32 FFMA, never TF32.
"""

from __future__ import annotations

from collections import Counter

import torch

# Shared memory one H100 block may use (227 KB). Each kernel has a narrow
# path, used while its footprint at width D fits, and a wide path above:
# ns_step: each block of a cluster holds its RB x 64 slice of G = H X and a
# ring of load stages (ns_step_smem_bytes); wider, G goes to a workspace in
# device memory. chol32: one nbw-column f32 panel over nbw + 32 * ceil((D -
# nbw) / 32) rows, 4 rows of padding per column, and 64 reciprocal pivots,
# with nbw = 64 where that fits (D <= 896) and 32 above; wider, 64-wide
# panels whose rows are taken in chunks (chol32_smem_bytes).
_SMEM_LIMIT = 232448


def _ns_step_micro_rows(D: int) -> int:
    return 2 if D <= 256 else 8


def ns_step_block_rows(D: int) -> int:
    """Rows of ``G`` each block of an ns_step cluster owns: one tile of
    ``16 * TM`` rows, or ``ceil(D / 8)`` rounded up to 4 where eight tiles do
    not cover ``D``; the cluster has ``ceil(D / RB) <= 8`` blocks."""
    eighth = -(-D // 8)
    return max(16 * _ns_step_micro_rows(D), 4 * -(-eighth // 4))


def ns_step_smem_bytes(D: int) -> int:
    """Dynamic shared memory of an ns_step cluster block at width ``D``
    (mirrors ``smem_floats`` in ``csrc/ns_step.cu``): the ``RB x 64`` slice
    of G plus 3 or 6 stages (TM = 8 or 2) of a ``16 TM x 36`` A chunk and a
    ``32 x 64`` X or G chunk."""
    tm = _ns_step_micro_rows(D)
    stages = 6 if tm == 2 else 3
    return 4 * (ns_step_block_rows(D) * 64 + stages * (16 * tm * 36 + 32 * 64))


# The widest D of ns_step's narrow path; wider steps take the wide path.
NS_STEP_SWITCH_D = max(D for D in range(1, 8192) if ns_step_smem_bytes(D) <= _SMEM_LIMIT)


def _chol32_panel_bytes(D: int, nbw: int) -> int:
    rows = nbw + 32 * -(-max(D - nbw, 0) // 32)
    return 4 * (nbw * (rows + 4) + 64)


# The wide chol32 path's chunk: the most rows (a multiple of 32) whose two
# chunk slots and 64-row diagonal block, 64 columns each, fit with the 64
# pivots (mirrors wide_chunk_rows in csrc/chol32.cu).
CHOL32_WIDE_CHUNK = ((_SMEM_LIMIT // 4 - 64) // 64 - 64 - 4) // 2 // 32 * 32
# The widest D of chol32's narrow path; wider matrices take the wide path.
CHOL32_SWITCH_D = max(D for D in range(1, 4096) if _chol32_panel_bytes(D, 32) <= _SMEM_LIMIT)


def chol32_panel_width(D: int) -> int:
    """Panel width of the chol32 kernel at width ``D``: 64 where the panel
    fits one block's shared memory, else 32 up to ``CHOL32_SWITCH_D``, and
    64 on the wide path above."""
    if D > CHOL32_SWITCH_D:
        return 64
    return 64 if _chol32_panel_bytes(D, 64) <= _SMEM_LIMIT else 32


def chol32_smem_bytes(D: int) -> int:
    """Dynamic shared memory of the chol32 kernel at width ``D``."""
    if D > CHOL32_SWITCH_D:
        return 4 * (64 * (64 + 2 * CHOL32_WIDE_CHUNK + 4) + 64)
    return _chol32_panel_bytes(D, chol32_panel_width(D))


# CUDA caps a grid's y and z extents at 65535; ns_step puts the batch on z
# (csrc/ns_step.cu), so its wrapper launches once per slice of at most this
# many matrices.
MAX_GRID_Z = 65535


def ns_step_plain(H32: torch.Tensor, X32: torch.Tensor) -> torch.Tensor:
    """``X + X (I - H X)``: the two-matmul form of ``maybe_ns_step``."""
    eye = torch.eye(H32.shape[-1], dtype=H32.dtype, device=H32.device)
    return X32 + X32 @ (eye - H32 @ X32)


def chol32_plain(A32: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor with NaN in the whole lower triangle of every
    matrix that is not positive definite (no host sync)."""
    L, info = torch.linalg.cholesky_ex(A32)
    bad = (info > 0) | ~torch.isfinite(L).all(dim=-1).all(dim=-1)
    D = A32.shape[-1]
    lower = torch.ones(D, D, dtype=torch.bool, device=A32.device).tril()
    return torch.where(bad[..., None, None] & lower, torch.nan, L)


def _check_batch(name: str, *ts: torch.Tensor):
    """Validate ``(B, D, D)`` or ``(D, D)`` contiguous f32 CUDA tensors of one
    shape on one device."""
    t0 = ts[0]
    for t in ts:
        if t.device != t0.device or t.device.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if t.shape != t0.shape:
            raise ValueError(f"{name}: shape mismatch {tuple(t.shape)} vs {tuple(t0.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if t0.dim() not in (2, 3) or t0.shape[-1] != t0.shape[-2]:
        raise ValueError(f"{name}: expected (B, D, D) or (D, D), got {tuple(t0.shape)}")


def _launch(name: str, fn: str, device: torch.device, *args):
    """Call the library's ``fn(*args, stream)`` on ``device`` and PyTorch's
    current stream there; raise on a CUDA error. The raw stream handle is
    read without building a ``torch.cuda.Stream`` object, whose host cost
    exceeded the launch's own at the path's small shapes."""
    from pgpfa_torch.ops._build import library

    with torch.cuda.device(device):
        err = getattr(library(), fn)(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def ns_step(H32: torch.Tensor, X32: torch.Tensor) -> torch.Tensor:
    """One Newton-Schulz step ``2 X - X (H X)`` for ``(B, D, D)`` or
    ``(D, D)`` float32 matrices, any ``D`` and any ``B``: one launch per
    slice of at most ``MAX_GRID_Z`` matrices."""
    if H32.device.type == "cpu" and X32.device.type == "cpu":
        return ns_step_plain(H32, X32)
    _check_batch("ns_step", H32, X32)
    squeeze = H32.dim() == 2
    H3, X3 = (H32[None], X32[None]) if squeeze else (H32, X32)
    B, D = H3.shape[0], H3.shape[-1]
    out = torch.empty_like(X3)
    if B and D:
        # the wide path keeps G = H X in a workspace in device memory; freed
        # on return, it is reused only in this stream's order, after the launches
        G = torch.empty_like(X3[:MAX_GRID_Z]) if D > NS_STEP_SWITCH_D else None
        for lo in range(0, B, MAX_GRID_Z):
            b = min(MAX_GRID_Z, B - lo)
            _launch("ns_step", "pgpfa_ns_step", H3.device, H3[lo].data_ptr(), X3[lo].data_ptr(),
                    None if G is None else G.data_ptr(), out[lo].data_ptr(), b, D)
            ns_step.launches += 1
            ns_step.launches_by_shape[(b, D)] += 1
    return out[0] if squeeze else out


ns_step.launches = 0
ns_step.launches_by_shape = Counter()


def chol32(A32: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of ``(B, D, D)`` or ``(D, D)`` float32 SPD
    matrices, any ``D``: a fresh tensor, zeros above the diagonal, NaN in the lower
    triangle of a matrix that is not positive definite. Reads only the lower
    triangle of ``A32``."""
    if A32.device.type == "cpu":
        return chol32_plain(A32)
    _check_batch("chol32", A32)
    squeeze = A32.dim() == 2
    A3 = A32[None] if squeeze else A32
    B, D = A3.shape[0], A3.shape[-1]
    out = torch.empty_like(A3)
    if B and D:
        _launch("chol32", "pgpfa_chol32", A3.device, A3.data_ptr(), out.data_ptr(), B, D)
        chol32.launches += 1
        chol32.launches_by_shape[(B, D)] += 1
    return out[0] if squeeze else out


chol32.launches = 0
chol32.launches_by_shape = Counter()
