"""The banded path's block-cyclic-reduction solve with its block axis split
over processes (PyTorch port of ``pgpfa/parallel/timeshard.py``).

:func:`pgpfa_torch.ops.blocktridiag.btd_solve_cr` has O(log nb) sequential
depth: each level eliminates the odd blocks with batched ``m x m`` inverses
and products. Here each rank of a time group holds a contiguous range of
blocks and runs the levels on it; the only coupling across ranks is one
boundary block per level, passed to the neighbour by an ``all_reduce`` of a
zeroed buffer of per-rank slots (gloo has no point-to-point on CUDA
tensors). Once a rank's surviving count is odd, the ranks sum their blocks
into one buffer and each finishes the small remaining system alone.

Composition (the JAX package's 2-D ``(trials, time)`` mesh): trials stay the
exact data-parallel axis, and within a trial group the blocks of a very long
trial spread over the time axis (:func:`make_mesh_2d`). As in the JAX
package, only the solve is split: the posterior moments' selected inverse
(the Takahashi recursion) stays sequential.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from pgpfa_torch.ops.blocktridiag import _inv, btd_solve_cr


class Mesh2D(NamedTuple):
    """This rank's place on a ``(n_trial, n_time)`` grid of ranks (rank
    ``r`` at row ``r // n_time``, column ``r % n_time``), the group of its
    column (``trial_group``: the ranks that hold other trials of the same
    time range) and of its row (``time_group``: the ranks that share its
    trials' blocks)."""

    n_trial: int
    n_time: int
    trial_index: int
    time_index: int
    trial_group: object
    time_group: object


def mesh_2d_shape(world_size: int, n_trial: Optional[int] = None):
    """``(n_trial, n_time)`` by ``pgpfa.parallel.timeshard.make_mesh_2d``'s
    rule: by default the most square split, trials taking the larger factor
    (the trial axis is exact data parallelism and should take most ranks)."""
    n = int(world_size)
    if n_trial is None:
        n_trial = 1
        for f in range(math.isqrt(n), 0, -1):
            if n % f == 0:
                n_trial = max(f, n // f)
                break
    if n % n_trial:
        raise ValueError(f"{n} ranks not divisible by n_trial={n_trial}")
    return n_trial, n // n_trial


def make_mesh_2d(world_size: Optional[int] = None, n_trial: Optional[int] = None) -> Mesh2D:
    """Split the default process group's ranks into a ``(trials, time)``
    grid. Every rank must call it: each group is made by
    ``torch.distributed.new_group`` on every rank, in one order."""
    world = dist.get_world_size() if world_size is None else int(world_size)
    nt, ns = mesh_2d_shape(world, n_trial)
    rank = dist.get_rank()
    trial_groups = [dist.new_group([i * ns + j for i in range(nt)]) for j in range(ns)]
    time_groups = [dist.new_group([i * ns + j for j in range(ns)]) for i in range(nt)]
    ti, si = divmod(rank, ns)
    return Mesh2D(nt, ns, ti, si, trial_groups[si], time_groups[ti])


def _pass(t: torch.Tensor, shift: int, group, world: int, rank: int) -> torch.Tensor:
    """Send ``t`` to rank ``rank + shift`` of ``group``; return what rank
    ``rank - shift`` sent (zeros where there is none). One ``all_reduce`` of
    a buffer of per-rank slots, called by every rank."""
    buf = t.new_zeros((world,) + t.shape)
    if 0 <= rank + shift < world:
        buf[rank + shift] = t
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf[rank]


def btd_solve_cr_timesharded(D: torch.Tensor, B: torch.Tensor, rhs: torch.Tensor, group=None):
    """:func:`~pgpfa_torch.ops.blocktridiag.btd_solve_cr` with the block
    axis split over the ranks of ``group`` (a time group of
    :func:`make_mesh_2d`, or the default group).

    Rank ``j`` of ``P`` holds the same number ``n`` of consecutive blocks,
    ``j n .. (j+1) n - 1``: its diagonal blocks ``D (..., n, m, m)``, its
    right-hand sides ``rhs (..., n, m[, k])`` and its subdiagonal blocks
    ``B (..., n, m, m)``, ``B[i] = A[i+1, i]`` for its blocks ``i``, the last
    rank's last one zero (the JAX package pads ``B`` so). Leading axes (a
    trial axis) batch. Returns this rank's blocks of the solution. Without a
    process group it is ``btd_solve_cr(D, B[..., :-1, :, :], rhs)``.
    """
    if not (dist.is_available() and dist.is_initialized()):
        return btd_solve_cr(D, B[..., :-1, :, :], rhs)
    vec = rhs.dim() == D.dim() - 1
    if vec:
        rhs = rhs[..., None]
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    n, m = D.shape[-3], D.shape[-1]
    counts = D.new_zeros(world)
    counts[rank] = n
    dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=group)
    if not bool((counts == n).all()):
        raise ValueError(f"every rank must hold the same number of blocks, got {counts.tolist()}")
    tr = lambda a: a.transpose(-1, -2)  # noqa: E731

    levels = []
    while n % 2 == 0:
        De, Do = D[..., 0::2, :, :], D[..., 1::2, :, :]
        re, ro = rhs[..., 0::2, :, :], rhs[..., 1::2, :, :]
        # odd block 2t+1 couples to 2t through B[2t] and to 2t+2 through
        # B[2t+1]; the last 2t+2 is the next rank's first block
        Lo_left, Lo_right = B[..., 0::2, :, :], B[..., 1::2, :, :]
        Do_inv = _inv(Do)
        levels.append((Lo_left, Lo_right, Do_inv, ro))
        KR = tr(Lo_left) @ Do_inv
        KL = Lo_right @ Do_inv
        # even block 2t+2 loses its left odd neighbour 2t+1: the last of
        # these terms belongs to the next rank's first block
        dD, dr = KL @ tr(Lo_right), KL @ ro
        got = _pass(torch.cat([dD[..., -1, :, :], dr[..., -1, :, :]], -1), 1, group, world, rank)
        dD = torch.cat([got[..., None, :, :m], dD[..., :-1, :, :]], -3)
        dr = torch.cat([got[..., None, :, m:], dr[..., :-1, :, :]], -3)
        D = De - KR @ Lo_left - dD
        rhs = re - KR @ ro - dr
        # new subdiagonal: x_{2t+2} couples to x_{2t} through 2t+1
        B = -(KL @ Lo_left)
        n //= 2

    # the surviving blocks of all ranks, summed into one buffer of slots;
    # every rank solves the whole reduced system and keeps its blocks
    parts = (D, B, rhs)
    flat = torch.cat([p.reshape(*p.shape[:-3], -1) for p in parts], -1)
    buf = flat.new_zeros((world,) + flat.shape)
    buf[rank] = flat
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    full, lo = [], 0
    for p in parts:
        size = n * p.shape[-2] * p.shape[-1]
        slots = buf[..., lo:lo + size].reshape(world, *p.shape)
        full.append(torch.cat(slots.unbind(0), -3))
        lo += size
    Dg, Bg, rg = full
    x = btd_solve_cr(Dg, Bg[..., :-1, :, :], rg)[..., rank * n:(rank + 1) * n, :, :]

    for Lo_left, Lo_right, Do_inv, ro in reversed(levels):
        # x_odd[t] = Dinv (r_odd[t] - B[2t] x_{2t} - B[2t+1]^T x_{2t+2}),
        # the last x_{2t+2} the next rank's first block
        first = _pass(x[..., 0, :, :], -1, group, world, rank)
        nxt = torch.cat([x[..., 1:, :, :], first[..., None, :, :]], -3)
        x_odd = Do_inv @ (ro - Lo_left @ x - tr(Lo_right) @ nxt)
        x = torch.stack([x, x_odd], -3).reshape(*x.shape[:-3], 2 * x.shape[-3], *x.shape[-2:])
    return x[..., 0] if vec else x
