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


def gathered(x: torch.Tensor, offset: int, total: int, reduce: Reduce) -> torch.Tensor:
    """The trials of all ranks in rank order, ``(total, ...)``, from this
    rank's ``x (R, ...)``, whose first trial is the global ``offset``: each
    rank puts its rows into zeros and one ``reduce`` sums them, which adds
    only zeros to every row, so the rows are exact. ``x`` without
    ``reduce``."""
    if reduce is None:
        return x
    buf = x.new_zeros((total,) + tuple(x.shape[1:]))
    buf[offset:offset + x.shape[0]] = x
    return reduce(buf)


class _SummedOverRanks(torch.autograd.Function):
    """``fn(x)`` summed over ranks, with the gradient summed the same way:
    the local value and its autograd gradient go through one ``reduce``
    (an all-reduce is not differentiable), and the backward pass returns
    the summed gradient."""

    @staticmethod
    def forward(ctx, x, fn, reduce):
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            f = fn(xr)
            (g,) = torch.autograd.grad(f, xr, allow_unused=True)
        if g is None:  # no local term depends on x
            g = torch.zeros_like(x)
        tot = reduce(torch.cat([f.detach().reshape(1), g.reshape(-1)]))
        ctx.save_for_backward(tot[1:].reshape(x.shape))
        return tot[0]

    @staticmethod
    def backward(ctx, grad_out):
        (g,) = ctx.saved_tensors
        return grad_out * g, None, None


def summed_over_ranks(fn: Callable[[torch.Tensor], torch.Tensor],
                      reduce: Callable[[torch.Tensor], torch.Tensor]
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The scalar function ``x -> sum over ranks of fn(x)``, differentiable
    in ``x``: each evaluation is one ``reduce`` of the local value and
    gradient together, so every rank gets the same value and gradient."""
    return lambda x: _SummedOverRanks.apply(x, fn, reduce)
