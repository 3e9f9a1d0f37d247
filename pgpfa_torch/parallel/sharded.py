"""Trial-sharded EM over ``torch.distributed`` (PyTorch port of
``pgpfa/parallel/sharded.py``).

The JAX package runs its fused EM program with the trial axis sharded over a
device mesh and lets GSPMD insert the all-reduces. Here each process (one per
card) runs :func:`pgpfa_torch.em.fit.fit_loop` on its own trials with a
``reduce`` hook, :func:`all_reduce_sum`, at every sum over trials: the
E-steps' nPLL and bound, the per-neuron cost, gradient and Hessian of every
(C, d) Newton step, ``PautoSum`` (dense) or the banded covariance blocks and
each secant evaluation's quadratic term (banded). Every collective sits where
the trip count is the same on every process (the fixed (C, d) Newton, the
secant's evaluations), never inside the per-trial Newton loops of the
E-steps, whose trip counts differ by process; so every process takes the
same steps and ends with the same parameters.

Online EM draws one minibatch stream over the global trial numbering on
every process; each process E-steps the rows of each minibatch that it
holds (possibly none) and every M-step statistic of the update rules is
reduced the same way, the penalties added once after the reduce.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from pgpfa_torch.em.fit import FitConfig, FitResult, fit_loop
from pgpfa_torch.infer.laplace import laplace_estep_from_arrays
from pgpfa_torch.learn.mstep_gp import pauto_sum
from pgpfa_torch.parallel.mesh import trial_slice


def in_process_group() -> bool:
    """Whether ``torch.distributed`` has a default process group."""
    return dist.is_available() and dist.is_initialized()


def all_reduce_sum(group=None):
    """The ``reduce`` hook of :mod:`pgpfa_torch.utils.reduce`: a copy of its
    tensor summed over the ranks of ``group`` by one ``all_reduce``."""

    def reduce(t: torch.Tensor) -> torch.Tensor:
        buf = t.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        return buf

    return reduce


def default_device(device=None) -> torch.device:
    """``device``, or the launcher's card ``cuda:{LOCAL_RANK}`` (``cuda:0``
    without a launcher); never the CPU unless asked."""
    if device is not None:
        return torch.device(device)
    return torch.device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")


def fit_sharded(
    init_params,
    Y,
    bin_size_ms: float,
    config: Optional[FitConfig] = None,
    device=None,
    dtype=torch.float64,
    group=None,
    **loop_kw,
) -> FitResult:
    """Batch or online EM with the trials split over the ranks of ``group``
    (the default process group when ``None``).

    Every rank passes the whole ``Y (R, ydim, T)``, as the JAX package's
    single process does, and fits its :func:`~pgpfa_torch.parallel.mesh.trial_slice`;
    ranks beyond ``mesh_for_trials(R, world_size)`` hold no trials and still
    take part in every collective. Both E-steps, dense and banded, in f64 or
    f32; online EM with all six update rules, joint or C-only (C, d). The
    result is the same on every rank: ``post_loglik``, the bound and the
    parameters are global, ``newton_iters`` covers the rank's own trials
    (online: ``(iters, batch_size)``, -1 at other ranks' rows). Without an
    initialized process group this is :func:`pgpfa_torch.fit_loop`, bit for
    bit.

    ``loop_kw`` are :func:`~pgpfa_torch.em.fit.fit_loop`'s keywords: the
    online stream's ``seed`` or ``batch_indices`` (over all ``R`` trials,
    the same on every rank), ``checkpoint_path`` (written by rank 0 alone,
    with the warm starts of all ranks' trials, batch EM's too),
    ``checkpoint_every``, ``resume_from`` (read by every rank),
    ``stop_after`` and ``record_iter_sec``.

    ``device=None`` is the card ``cuda:{LOCAL_RANK}`` (``cuda:0`` without a
    launcher), never the CPU unless asked (``device="cpu"``, with the gloo
    backend).
    """
    cfg = config or FitConfig()
    device = default_device(device)
    if not in_process_group():
        return fit_loop(init_params, Y, bin_size_ms, cfg, device, dtype, **loop_kw)
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    sl = trial_slice(rank, len(Y), world)
    return fit_loop(init_params, Y[sl], bin_size_ms, cfg, device, dtype,
                    reduce=all_reduce_sum(group), trial_offset=sl.start,
                    write_checkpoint=rank == 0, **loop_kw)


def sharded_estep_stats(C, d, tau, Y_local, T: int, bin_size_ms: float, group=None,
                        gtol: float = 1e-8, maxiter: int = 100, eps_noise: float = 0.001):
    """A Laplace E-step of this rank's trials ``Y_local`` and the M-step's
    statistics summed over ranks (``pgpfa.parallel.sharded.sharded_estep_stats``;
    one ``all_reduce``, none without a process group).

    Returns ``(X, vsm, vsm_gp, pauto, obj_sum, n)``: the local modes
    ``(R_local, xdim, T)`` and posterior views, then summed over ranks
    ``PautoSum`` ``(xdim, T, T)``, the trial objectives and the trial count.
    """
    inf, _ = laplace_estep_from_arrays(C, d, tau, Y_local, T, bin_size_ms, gtol=gtol,
                                       maxiter=maxiter, compute_cov=False, eps_noise=eps_noise)
    pauto = pauto_sum(inf.post_mean, inf.post_vsm_gp)
    buf = torch.cat([pauto.reshape(-1), inf.trial_obj.sum().reshape(1),
                     pauto.new_full((1,), Y_local.shape[0])])
    if in_process_group():
        buf = all_reduce_sum(group)(buf)
    return (inf.post_mean, inf.post_vsm, inf.post_vsm_gp, buf[:-2].reshape(pauto.shape),
            buf[-2], buf[-1])
