"""How trials are split over processes (port of ``pgpfa/parallel/mesh.py``'s
rule, NumPy-free plain Python).

Trial data parallelism is exact for P-GPFA EM: the E-step factorizes over
trials and every M-step statistic is a sum over trials. The JAX package
shards the trial axis over a device mesh and needs it divisible by the
mesh; the port keeps that rule, so a fit uses the largest process count that
divides the trial count and the processes beyond it hold no trials (they
still take part in every collective, with zeros).
"""

from __future__ import annotations


def mesh_for_trials(n_trials: int, world_size: int) -> int:
    """The largest process count not above ``world_size`` that divides
    ``n_trials`` (``pgpfa.parallel.mesh.mesh_for_trials``'s rule: 7 trials on
    8 processes use 7; a prime count falls back to 1)."""
    n = int(world_size)
    while n > 1 and n_trials % n:
        n -= 1
    return n


def trial_slice(rank: int, n_trials: int, world_size: int) -> slice:
    """The contiguous trials of process ``rank``: ``n_trials / n`` each on the
    first ``n = mesh_for_trials(n_trials, world_size)`` ranks, an empty slice
    on the others."""
    n = mesh_for_trials(n_trials, world_size)
    if rank >= n:
        return slice(n_trials, n_trials)
    per = n_trials // n
    return slice(rank * per, (rank + 1) * per)
