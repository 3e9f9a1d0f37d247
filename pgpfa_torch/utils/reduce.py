"""Trial sums across processes, behind an optional hook.

The E-step and M-step functions take ``reduce``: ``None`` in one process,
or a callable that returns the elementwise sum of a tensor over all ranks
(:func:`pgpfa_torch.parallel.sharded.all_reduce_sum`). It replaces each
sum over trials; with ``None`` every function computes what it computes
without the argument. Nothing here imports ``torch.distributed``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

Reduce = Optional[Callable[[torch.Tensor], torch.Tensor]]


def trial_mean(x: torch.Tensor, reduce: Reduce) -> torch.Tensor:
    """Mean of ``x (R, ...)`` over the trials of all ranks: the local sums
    and the local trial count go through one ``reduce``."""
    if reduce is None:
        return x.mean(0)
    tot = reduce(torch.cat([x.sum(0).reshape(-1), x.new_full((1,), x.shape[0])]))
    return (tot[:-1] / tot[-1]).reshape(x.shape[1:])


def trial_count(R: int, like: torch.Tensor, reduce: Reduce) -> float:
    """The trial count over all ranks (``R`` itself without ``reduce``)."""
    if reduce is None:
        return float(R)
    return float(reduce(like.new_full((1,), R))[0])
