"""Trial-parallel EM over ``torch.distributed`` (PyTorch port of ``pgpfa/parallel``).

One process per card, each fitting its own trials: the E-step factorizes
over trials and every M-step statistic is a sum over trials, so the split is
exact. The processes meet only in ``all_reduce`` (and ``broadcast``)
collectives at those sums (:mod:`pgpfa_torch.utils.reduce`), in the same
order on every process. Online EM draws one minibatch stream over all
processes' trials; each process E-steps the rows it holds.

* :mod:`~pgpfa_torch.parallel.mesh`: how trials are split over processes.
* :mod:`~pgpfa_torch.parallel.sharded`: :func:`fit_sharded` (every process
  holds all trials and fits its slice) and :func:`sharded_estep_stats`.
* :mod:`~pgpfa_torch.parallel.distributed`: :func:`init_distributed` from a
  launcher's environment and :func:`fit_multihost` (each process passes its
  own trials).
* :mod:`~pgpfa_torch.parallel.timeshard`: the block-cyclic-reduction solve
  of the banded path with its block axis split over processes.
"""

from pgpfa_torch.parallel.distributed import fit_multihost, init_distributed
from pgpfa_torch.parallel.mesh import mesh_for_trials, trial_slice
from pgpfa_torch.parallel.sharded import all_reduce_sum, fit_sharded, sharded_estep_stats
from pgpfa_torch.parallel.timeshard import btd_solve_cr_timesharded, make_mesh_2d

__all__ = [
    "all_reduce_sum",
    "btd_solve_cr_timesharded",
    "fit_multihost",
    "fit_sharded",
    "init_distributed",
    "make_mesh_2d",
    "mesh_for_trials",
    "sharded_estep_stats",
    "trial_slice",
]
