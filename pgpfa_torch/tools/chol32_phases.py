#!/usr/bin/env python3
"""Where the chol32 kernel's time goes, phase by phase, on the card.

    python3 pgpfa_torch/tools/chol32_phases.py

Builds an instrumented copy of ``pgpfa_torch/csrc/chol32.cu`` into
``build/chol32_phases/`` (the committed source is not changed): thread 0 of
each block reads ``clock64()`` at the start and after every block barrier of
the panel loop. Each panel has seven barriers (a ragged last panel of at
most 32 columns skips three), so each interval is one phase of the block:
staging, the first diagonal factor, its row solves, the second sub-panel's
update, the second diagonal factor, its row solves, and the write-back with
the trailing update. Prints, per shape, each phase's share of the block's
cycles (mean over blocks, summed over panels) and that share of the
kernel's time by CUDA events (median of 10), with the card's ``nvidia-smi``
name and power limit.

Then times the kernel itself (``cuda_kernels.chol32``, not instrumented) on
inputs whose rows are 16-byte aligned and on the same inputs offset by one
float in their buffer, which only 4-byte accesses can read.
"""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from pgpfa_torch.ops import _build  # noqa: E402

PHASES = ["stage", "diag 1", "row solve 1", "sub-panel update", "diag 2", "row solve 2",
          "write-back + trailing update"]
MAXS = 128  # stamp slots per block: 1 + 7 per panel, 14 panels at most
SHAPES = [(100, 700), (4, 260), (5, 140), (90, 6)]  # all 64-wide panels (D <= 896)
OUT = REPO / "build" / "chol32_phases"


def instrument(src: str) -> str:
    """Stamp after every barrier of the kernel and at its start."""
    head, body = src.split("chol32_kernel(const float*", 1)
    body, tail = body.split("int launch(", 1)
    if body.count("__syncthreads();") != len(PHASES):
        raise RuntimeError("chol32.cu's panel loop no longer has one barrier per phase")
    stamp = "if (threadIdx.x == 0) g_stamp[blockIdx.x * %d + %s] = clock64();"
    parts = body.split("__syncthreads();")
    body = parts[0] + "".join(
        "__syncthreads(); " + stamp % (MAXS, f"1 + {len(PHASES)} * (k0 / nbw) + {i}") + part
        for i, part in enumerate(parts[1:]))
    body = body.replace("if (tid == 0) failed = 0;", "if (tid == 0) failed = 0;\n  " + stamp % (MAXS, 0), 1)
    glob = "__device__ long long* g_stamp;\n"
    setter = ('extern "C" int pgpfa_chol32_set_stamps(long long* p) {\n'
              "  return (int)cudaMemcpyToSymbol(g_stamp, &p, sizeof(p));\n}\n")
    head = re.sub(r"namespace \{", glob + "namespace {", head, count=1)
    return head + "chol32_kernel(const float*" + body + "int launch(" + tail + setter


def build():
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / "chol32_phases.cu"
    cu.write_text(instrument((_build.CSRC / "chol32.cu").read_text()))
    so = OUT / "libchol32_phases.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          check=True, capture_output=True, text=True)
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    lib = ctypes.CDLL(str(so))
    lib.pgpfa_chol32.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.pgpfa_chol32_set_stamps.argtypes = [ctypes.c_void_p]
    lib.pgpfa_chol32.restype = lib.pgpfa_chol32_set_stamps.restype = ctypes.c_int
    return lib


def spd(B, D, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    M = torch.randn(B, D, D, generator=g, device="cuda", dtype=torch.float64) / D**0.5
    return (M @ M.transpose(1, 2) + 0.5 * torch.eye(D, device="cuda", dtype=torch.float64)).float()


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("chol32_phases: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    phases(build())
    alignment()


def median_ms(fn, reps=10):
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def alignment():
    """The kernel on 16-byte aligned rows against the same matrices offset by
    one float, in turns (aligned, offset, offset, aligned)."""
    from pgpfa_torch.ops.cuda_kernels import chol32

    for B, D in SHAPES:
        A = spd(B, D, B * 1000 + D)
        buf = torch.empty(A.numel() + 1, device="cuda")
        Aoff = buf[1:].view_as(A)
        Aoff.copy_(A)
        if Aoff.data_ptr() % 16 == 0:
            raise RuntimeError("the offset view is 16-byte aligned")
        if not torch.equal(chol32(Aoff), chol32(A)):
            raise RuntimeError(f"chol32 differs on the offset input at ({B}, {D}, {D})")
        t = [median_ms(lambda: chol32(X)) for X in (A, Aoff, Aoff, A)]
        print(f"chol32 ({B}, {D}, {D}) through cuda_kernels.chol32: aligned {t[0]:.4f} / "
              f"{t[3]:.4f} ms, offset by one float {t[1]:.4f} / {t[2]:.4f} ms")


def phases(lib):
    for B, D in SHAPES:
        A = spd(B, D, B * 1000 + D)
        L = torch.empty_like(A)
        stamps = torch.zeros(B, MAXS, dtype=torch.int64, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            err = lib.pgpfa_chol32(A.data_ptr(), L.data_ptr(), B, D, stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")

        if lib.pgpfa_chol32_set_stamps(stamps.data_ptr()):
            raise RuntimeError("cudaMemcpyToSymbol failed")
        ms = median_ms(run)  # the stamps are the last run's
        if not torch.allclose(L, torch.linalg.cholesky(A), rtol=2e-5, atol=2e-5):
            raise RuntimeError("instrumented kernel disagrees with cuSOLVER")
        s = stamps.cpu().numpy()[:, : 1 + len(PHASES) * -(-D // 64)]
        for j in range(1, s.shape[1]):  # a phase a ragged last panel skips takes no time
            s[:, j] = np.where(s[:, j] == 0, s[:, j - 1], s[:, j])
        npanel = -(-D // 64)
        d = np.diff(s, axis=1).reshape(B, npanel, len(PHASES)).astype(np.float64)
        per_phase = d.sum(1).mean(0)
        total = per_phase.sum()
        print(f"chol32 ({B}, {D}, {D}): {ms:.4f} ms by events; block {total:.0f} cycles "
              f"(mean over blocks), {npanel} panels")
        for name, c, first, last in zip(PHASES, per_phase, d[:, 0].mean(0), d[:, -1].mean(0)):
            print(f"  {name:30s} {100 * c / total:5.1f}%  {ms * c / total:.4f} ms  "
                  f"(first panel {first:.0f} cycles, last {last:.0f})")


if __name__ == "__main__":
    main()
