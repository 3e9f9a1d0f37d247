"""Trial minibatching helpers, NumPy only.

Twin of ``pgpfa/data/batching.py``: views of a reference-style experiment
holding a subset of its trials. The port's online EM draws its own
minibatches (:func:`pgpfa_torch.draw_batch_indices`); these helpers serve
user code structured like the reference.
"""

from __future__ import annotations

import copy

import numpy as np


def subsample_trials(experiment, batch_size: int, rng=None):
    """Random without-replacement minibatch of trials (``batchTrIdx`` holds
    the drawn indices)."""
    rng = rng or np.random.default_rng()
    n = len(experiment.data)
    idx = rng.choice(n, size=batch_size, replace=False)
    sub = copy.copy(experiment)
    sub.data = [experiment.data[i] for i in idx]
    sub.numTrials = batch_size
    sub.batchTrIdx = idx
    if hasattr(sub, "Y"):
        sub.Y = experiment.Y[idx]
    return sub


def seen_trials(experiment, seen_idx):
    """The trials ``seen_idx`` (in that order, repeats kept) as an experiment."""
    idx = np.asarray(seen_idx).reshape(-1)
    sub = copy.copy(experiment)
    sub.data = [experiment.data[i] for i in idx]
    sub.numTrials = len(idx)
    if hasattr(sub, "Y"):
        sub.Y = experiment.Y[idx]
    return sub


# reference-API aliases
subsampleTrials = subsample_trials
seenTrials = seen_trials
