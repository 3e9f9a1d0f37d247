"""Shared helpers for the PyTorch-port tests (``tests/test_torch_*.py``).

The same NumPy inputs, made from a seed, go to the JAX package and to the
port; results come back as NumPy arrays and are compared with a stated
tolerance. Sizes stay small (xdim 2-3, ydim <= 20, T <= 50, R <= 5).
"""

import functools
import os
import tempfile
import time

import numpy as np
import pytest
import torch

# six xdist workers share the CPU
torch.set_num_threads(2)


def requires_cuda(test):
    """Mark a test that needs the card (marker ``requires_cuda``). Whether
    there is one is decided when the test runs, never when the module is
    imported, so every xdist worker collects the same tests; without a card
    the test skips with its reason."""

    @functools.wraps(test)
    def run(*args, **kwargs):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        return test(*args, **kwargs)

    return pytest.mark.requires_cuda(run)


def t64(a) -> torch.Tensor:
    """NumPy/JAX array -> f64 CPU tensor."""
    return torch.from_numpy(np.array(a, dtype=np.float64))  # a writable copy


def npy(x) -> np.ndarray:
    """Tensor or JAX array -> NumPy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rel_err(a, b) -> float:
    """max |a - b| / max |b|."""
    a, b = npy(a), npy(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def spd_batch(rng, B: int, D: int, dtype=np.float64, ridge: float = 0.5) -> np.ndarray:
    """``M M^T / D + ridge I``: SPD with eigenvalues in about ``[ridge, 4 + ridge]``."""
    M = rng.normal(size=(B, D, D)) / np.sqrt(D)
    return (M @ np.swapaxes(M, 1, 2) + ridge * np.eye(D)).astype(dtype)


def small_problem(seed: int = 3, xdim: int = 2, ydim: int = 15, R: int = 4,
                  trial_dur: int = 400, bin_ms: int = 10):
    """A NumPy dataset and Poisson-PCA init, built by the port's NumPy data
    path (bit-identical to ``pgpfa.dataset(backend="numpy")``)."""
    from pgpfa_torch import dataset, initialize_params

    ds = dataset(xdim=xdim, ydim=ydim, numTrials=R, trialDur=trial_dur, binSize=bin_ms,
                 seed=seed)
    return ds, initialize_params(xdim, ydim, ds, seed=0)


def longt_problem():
    """tests/test_longt.py's long-trial problem (xdim 2, ydim 12, T 64, R 4,
    20 ms bins, blocks of 16: 320 ms >> 6 x 40 ms), an init and per-neuron
    weights, for the banded-path tests."""
    rng = np.random.default_rng(11)
    xdim, ydim, T, R, bin_ms = 2, 12, 64, 4, 20.0
    tau = np.array([0.03, 0.04])
    C = rng.uniform(-0.5, 0.5, (ydim, xdim))
    d = rng.uniform(-1.0, 0.0, ydim)
    X = rng.standard_normal((R, xdim, T)) * 0.7
    Y = rng.poisson(np.exp(np.einsum("nk,rkt->rnt", C, X) + d[None, :, None])).astype(float)
    init = {"C": C + 0.1, "d": d, "tau": np.array([0.035, 0.035])}
    w = np.random.default_rng(4).uniform(0.2, 1.0, ydim)
    return dict(C=C, d=d, tau=tau, Y=Y, T=T, bin_ms=bin_ms, s=16, init=init, w=w)


def _rank_main(rank, world, tmp, fn, args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world)
    try:
        torch.save(fn(rank, world, *args), os.path.join(tmp, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, fn, *args, timeout: float = 120.0):
    """Run ``fn(rank, world, *args)`` in ``world`` forked CPU processes joined
    by a gloo process group (a ``file://`` store); returns each rank's return
    value, in rank order. A rank that raises fails the call, and so does one
    that is still running after ``timeout`` seconds (all are then killed)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank_main, args=(world, tmp, fn, args), nprocs=world,
                                 join=False, start_method="fork")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"ranks still running after {timeout} s")
        return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
                for r in range(world)]


def parallel_problem():
    """tests/test_parallel.py's problem: 16 trials x 16 neurons, 30 bins of
    20 ms, xdim 2, seed 4, init seed 0 (the port's NumPy data path)."""
    from pgpfa_torch import dataset, initialize_params

    ds = dataset(xdim=2, ydim=16, numTrials=16, trialDur=600, binSize=20, dOffset=0.5,
                 fixTau=True, fixedTau=np.array([0.15, 0.3]), seed=4)
    return ds, initialize_params(2, 16, ds, seed=0)
