"""Multi-process entry points (PyTorch port of ``pgpfa/parallel/distributed.py``).

Under a launcher that starts one process per card, for example::

    torchrun --nproc-per-node 4 my_fit.py

each process runs::

    from pgpfa_torch.parallel import fit_multihost, init_distributed

    init_distributed()                      # NCCL, from torchrun's environment
    res = fit_multihost(init, Y_local, bin_ms, cfg)

with ``Y_local`` its own trials. The collectives are those of
:mod:`pgpfa_torch.parallel.sharded`.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from pgpfa_torch.em.fit import FitConfig, FitResult, fit_loop
from pgpfa_torch.parallel.sharded import (
    all_reduce_sum,
    default_device,
    fit_sharded,
    in_process_group,
)

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(backend: str = "nccl", **kw) -> bool:
    """Initialize the default process group from a launcher's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` and
    ``LOCAL_RANK``, as ``torchrun`` sets them); returns ``True``.

    Without that environment and without keyword arguments it does nothing
    and returns ``False``. Keyword arguments go to
    ``torch.distributed.init_process_group`` (e.g. ``init_method``,
    ``rank``, ``world_size``). The backend is the caller's: ``"nccl"`` for
    one process per card, ``"gloo"`` for CPU processes or several processes
    on one card. With NCCL the process's card is ``cuda:{LOCAL_RANK}``. A
    failed initialization raises; nothing changes backend or device on its
    own.
    """
    launched = all(k in os.environ for k in _LAUNCHER_ENV)
    if not (launched or kw):
        return False
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if launched:
        kw.setdefault("init_method", "env://")
    dist.init_process_group(backend, **kw)
    return True


def fit_multihost(
    init_params,
    Y_local,
    bin_size_ms: float,
    config: Optional[FitConfig] = None,
    device=None,
    dtype=torch.float64,
    group=None,
    **loop_kw,
) -> FitResult:
    """Batch or online EM with each rank of ``group`` passing its own trials
    ``Y_local (R_local, ydim, T)``; the global fit sees all ranks' trials.

    The local counts may differ, and a rank may hold none: every statistic
    is a sum over trials, so the split need not divide evenly (the JAX
    package needs the global count divisible by its mesh). Online EM numbers
    the trials of all ranks in rank order (rank 0's first); one collective
    of the local counts gives each rank its offset. ``loop_kw`` are
    :func:`~pgpfa_torch.parallel.sharded.fit_sharded`'s. With one process
    this is :func:`~pgpfa_torch.parallel.sharded.fit_sharded`. The result is
    the same on every rank, as there.
    """
    cfg = config or FitConfig()
    if not in_process_group() or dist.get_world_size(group) == 1:
        return fit_sharded(init_params, Y_local, bin_size_ms, cfg, device, dtype, group,
                           **loop_kw)
    reduce = all_reduce_sum(group)
    device = default_device(device)
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    counts = torch.zeros(world, dtype=dtype, device=device)
    counts[rank] = len(Y_local)
    counts = [int(c) for c in reduce(counts).tolist()]
    if sum(counts) == 0:
        raise ValueError("fit_multihost: no rank holds a trial")
    return fit_loop(init_params, Y_local, bin_size_ms, cfg, device, dtype, reduce=reduce,
                    trial_offset=sum(counts[:rank]), write_checkpoint=rank == 0,
                    **loop_kw)
