#!/usr/bin/env python3
"""Where the device time of the port's fit goes, on one NVIDIA GPU.

    python3 pgpfa_torch/tools/profile_fit.py [laplace|variational|online|mcmc|mcmc1|longt] [f64|f32]

1. fit, under ``torch.profiler``, on the Stevenson-shaped surrogate (100
   trials x 90 neurons x 140 bins, xdim 5, Poisson-PCA init with seed 0),
   in f64 (the default) or the f32 fast mode. ``laplace`` (the default): a 2-iteration batch Laplace fit after a
   one-iteration warm-up fit. ``variational``: one warm dual-Newton EM
   iteration (E-step, (C, d) and tau M-steps) at the parameters of a
   2-iteration variational fit, its dual warm-started from the solution at
   the parameters one M-step earlier. ``online``: a 2-iteration online
   ``'diag'`` fit at batch 10 (minibatches drawn with seed 0) after a
   one-iteration warm-up fit. ``mcmc``: 20 samples of the 100 batched
   adaptive ESS chains; ``mcmc1``: 100 samples of one speculative chain on
   bench.py's synthetic data; each after a warm-up call. ``longt`` (f64
   only): one warm banded Laplace EM iteration (E-step warm-started from a
   cold E-step's modes, (C, d) and tau M-steps) of the long-trial workload
   at T = 1000 (``pgpfa_torch.data.longt``, blocks of 50 bins). Prints the wall time (profiler on),
   the summed device time of every kernel and copy, so the device's busy
   and idle share of the wall, the device time by the ATen op that
   launched it (the hand-written kernels, which no ATen op launches, by
   kernel name), largest first.
2. ns_step: the kernel's device time against the two cuBLAS SGEMMs that
   compute the same function (``baddbmm(X, X, bmm(H, X), beta=2,
   alpha=-1)``), mean over 10 calls each, at the path's (5, 140, 140) and at
   (100, 700, 700); and the host time of one wrapper call (median of 200,
   each after a synchronisation, so no launch waits for the card).

Prints the card's ``nvidia-smi`` name and power limit first.
"""

import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from pgpfa_torch import (  # noqa: E402
    FitConfig,
    dataset,
    fit,
    initialize_params,
    posterior_mcmc_batched,
    posterior_mcmc_from_arrays,
    stevenson_surrogate,
)
from pgpfa_torch.em.fit import _estep, _learn_tau_from_inf  # noqa: E402
from pgpfa_torch.infer import variational as V  # noqa: E402
from pgpfa_torch.infer.laplace_longt import laplace_estep_banded  # noqa: E402
from pgpfa_torch.learn.mstep_gp import learn_tau  # noqa: E402
from pgpfa_torch.learn.mstep_obs import learn_cd  # noqa: E402
from pgpfa_torch.models.params import rbf_kernel  # noqa: E402
from pgpfa_torch.ops.blockmat import blocks_inv  # noqa: E402
from pgpfa_torch.ops.cuda_kernels import ns_step  # noqa: E402

OWN_KERNELS = ("ns_step_kernel", "chol32_kernel")


def device_events(prof):
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def kernel_us(prof, pattern):
    """Mean device time and count of the kernels whose name holds ``pattern``."""
    ts = [e.time_range.elapsed_us() for e in device_events(prof) if pattern in e.name]
    return (float(np.mean(ts)) if ts else float("nan")), len(ts)


def laplace_run(ds, init, dtype):
    """Warm-up fit; returns the profiled run and its label."""
    fit(init, ds.Y, ds.binSize, FitConfig(max_em_iter=1), device="cuda", dtype=dtype)

    def run():
        fit(init, ds.Y, ds.binSize, FitConfig(max_em_iter=2), device="cuda", dtype=dtype)
    return run, "2 EM iterations"


def variational_run(ds, init, dtype):
    """A 2-iteration variational fit and the dual solved at its first
    parameters; returns one warm EM iteration at its final parameters."""
    b, cfg = float(ds.binSize), FitConfig(inference_method="variational", max_em_iter=2)
    res = fit(init, ds.Y, b, cfg, device="cuda", dtype=dtype)
    Y = torch.as_tensor(ds.Y, dtype=dtype, device="cuda")
    K1 = rbf_kernel(res.tau_seq[0], ds.T, b)
    rho1, _ = V._solve_dual(res.C_seq[0], res.d_seq[0], K1, blocks_inv(K1), Y,
                            torch.zeros_like(Y), cfg.vi_maxiter, cfg.vi_gtol, 1e-6, "newton")

    def run():
        inf, _, _, _ = V.vi_estep_from_arrays(
            res.C, res.d, res.tau, Y, ds.T, b, rho_init=rho1, gtol=cfg.vi_gtol,
            maxiter=cfg.vi_maxiter_warm, compute_cov=False, solver="newton")
        learn_cd(Y, inf.post_mean, inf.post_vsm, res.C, res.d, maxiter=cfg.cd_newton_iters)
        learn_tau(inf.post_mean, inf.post_vsm_gp, res.tau, b, maxiter=cfg.tau_maxiter)
    return run, "1 warm variational EM iteration"


def online_run(ds, init, dtype):
    """Warm-up online fit; returns the profiled run and its label."""
    def cfg(n):
        return FitConfig(em_mode="online", online_update="diag", batch_size=10, max_em_iter=n)

    fit(init, ds.Y, ds.binSize, cfg(1), device="cuda", dtype=dtype)

    def run():
        fit(init, ds.Y, ds.binSize, cfg(2), device="cuda", dtype=dtype)
    return run, "2 online 'diag' EM iterations, batch 10"


def mcmc_run(ds, init, dtype):
    """Warm-up; returns 20 samples of the 100 adaptive ESS chains."""
    def run():
        posterior_mcmc_batched(*(np.asarray(init[k], dtype=np_dtype(dtype)) for k in ("C", "d", "tau")),
                               ds.Y, ds.T, float(ds.binSize), n_samples=20, seed=1)
    run()
    return run, "20 samples of 100 batched adaptive ESS chains"


def mcmc1_run(ds, init, dtype):
    """Warm-up; returns 100 samples of one speculative ESS chain (n_spec 8)
    on bench.py's synthetic data (xdim 2, 20 neurons, T 50), its init."""
    synth = dataset(xdim=2, ydim=20, numTrials=5, trialDur=1000, binSize=20, dOffset=1,
                    fixTau=True, fixedTau=np.linspace(0.1, 0.5, 2), seed=123)
    p = initialize_params(2, 20, synth, seed=0)

    def run():
        posterior_mcmc_from_arrays(*(np.asarray(p[k], dtype=np_dtype(dtype)) for k in ("C", "d", "tau")),
                                   synth.Y[0], synth.T, float(synth.binSize), n_samples=100, seed=1)
    run()
    return run, "100 samples of one speculative ESS chain (n_spec 8), synthetic"


def longt_run(ds, init, dtype):
    """A cold banded E-step; returns one warm banded Laplace EM iteration of
    the long-trial workload at T = 1000 from its modes (``ds`` and ``init``,
    the surrogate's, are not used)."""
    from pgpfa_torch.data.longt import BIN_MS, BLOCK, long_trial_problem

    T = 1000
    C, d, tau, Y = (torch.as_tensor(a, dtype=dtype, device="cuda") for a in long_trial_problem(T))
    cfg = FitConfig(time_block=BLOCK)
    x0 = laplace_estep_banded(C, d, tau, Y, T, BIN_MS, BLOCK)[0].post_mean

    def run():
        inf, _, _, _ = _estep(C, d, tau, Y, T, BIN_MS, x0, cfg)
        learn_cd(Y, inf.post_mean, inf.post_vsm, C, d, maxiter=cfg.cd_newton_iters)
        _learn_tau_from_inf(inf, tau, BIN_MS, cfg)
    run()
    return run, "1 warm banded Laplace EM iteration, T = 1000, blocks of 50"


def np_dtype(dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def profile_fit(method, dtype):
    ds = stevenson_surrogate(xdim=5, seed=2011)
    init = initialize_params(5, ds.ydim, ds, seed=0)
    runs = {"laplace": laplace_run, "variational": variational_run, "online": online_run,
            "mcmc": mcmc_run, "mcmc1": mcmc1_run, "longt": longt_run}
    run, label = runs[method](ds, init, dtype)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.time_range.elapsed_us() for e in device_events(prof)) / 1e6
    print(f"fit ({method}, {str(dtype)[6:]}): {label}, wall {wall:.4f} s (profiler on), device busy {busy:.4f} s "
          f"= {100 * busy / wall:.1f}% of the wall, idle {100 * (1 - busy / wall):.1f}%")

    by_op = defaultdict(float)
    counts = defaultdict(int)
    # ATen ops only: a hand-written kernel launched inside another CPU range
    # (an autograd Function's forward, a runtime call) would be counted twice
    for e in prof.key_averages():
        if (e.device_type == DeviceType.CPU and e.self_device_time_total > 0
                and e.key.startswith("aten::")):
            by_op[e.key] += e.self_device_time_total / 1e6
            counts[e.key] += e.count
    for e in device_events(prof):
        for name in OWN_KERNELS:
            if name in e.name:
                by_op[f"{name} (hand-written)"] += e.time_range.elapsed_us() / 1e6
                counts[f"{name} (hand-written)"] += 1
    print(f"{'op':<48} {'device ms':>10} {'share':>7} {'calls':>6}")
    ranked = sorted(by_op.items(), key=lambda kv: -kv[1])
    for key, s in [kv for i, kv in enumerate(ranked) if i < 14 or "hand-written" in kv[0]]:
        print(f"{key[:48]:<48} {1e3 * s:>10.3f} {100 * s / busy:>6.1f}% {counts[key]:>6}")


def spd(B, D, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    M = torch.randn(B, D, D, generator=g, device="cuda", dtype=torch.float64) / D**0.5
    return M @ M.transpose(1, 2) + torch.eye(D, device="cuda", dtype=torch.float64)


def profile_ns_step():
    for B, D in [(5, 140), (100, 700)]:
        H64 = spd(B, D, D + 1)
        H = H64.float().contiguous()
        X = (0.9 * torch.cholesky_inverse(torch.linalg.cholesky(H64))).float().contiguous()

        def library():
            return torch.baddbmm(X, X, torch.bmm(H, X), beta=2.0, alpha=-1.0)

        for _ in range(3):
            ns_step(H, X)
            library()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                ns_step(H, X)
                torch.cuda.synchronize()
                library()
                torch.cuda.synchronize()
        k_us, k_n = kernel_us(prof, "ns_step_kernel")
        gemm = [e.time_range.elapsed_us() for e in device_events(prof) if "gemm" in e.name]
        host = []
        for _ in range(200):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ns_step(H, X)
            host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        print(f"ns_step ({B}, {D}, {D}): kernel {k_us:.2f} us device ({k_n} calls); "
              f"two cuBLAS SGEMMs {2 * float(np.mean(gemm)):.2f} us device ({len(gemm)} kernels); "
              f"wrapper host {1e6 * float(np.median(host)):.2f} us per call")


def main():
    method = sys.argv[1] if len(sys.argv) > 1 else "laplace"
    precision = sys.argv[2] if len(sys.argv) > 2 else "f64"
    if method not in ("laplace", "variational", "online", "mcmc", "mcmc1", "longt"):
        raise SystemExit(f"profile_fit: unknown method {method!r}; choose laplace, variational, "
                         "online, mcmc, mcmc1 or longt")
    dtypes = {"f64": torch.float64, "f32": torch.float32}
    if precision not in dtypes:
        raise SystemExit(f"profile_fit: unknown precision {precision!r}; choose f64 or f32")
    if not torch.cuda.is_available():
        raise SystemExit("profile_fit: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}; torch {torch.__version__}")
    profile_fit(method, dtypes[precision])
    profile_ns_step()


if __name__ == "__main__":
    main()
