"""Build and load the port's CUDA kernels (``pgpfa_torch/csrc/*.cu``).

One ``nvcc`` per source, all started together, compiles for ``sm_90a``
(Hopper); a last ``nvcc`` links the objects into one shared library with a
plain C interface, in ``build/pgpfa_torch/`` at the root of the checkout.
The file name carries a hash of the sources and flags, so an edited source is
rebuilt at its next use and an unchanged one is loaded as it is. The library
is loaded with ``ctypes``; nothing here includes PyTorch's headers, which
keeps a cold build to seconds.

Nothing is built at import time: :func:`library` builds on its first call.
A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "pgpfa_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> (argtypes, restype)
_SIGNATURES = {
    "pgpfa_ns_step": ([_P, _P, _P, _P, _I, _I, _P], _I),
    "pgpfa_chol32": ([_P, _P, _I, _I, _P], _I),
}


def _nvcc() -> str:
    """``nvcc`` from ``PATH``, else from ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``, the toolkit's standard prefix)."""
    nvcc = shutil.which("nvcc")
    fallback = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if nvcc is None and os.path.exists(fallback):
        nvcc = fallback
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpgpfa_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the sources if their library is missing; return the library's
    path and the compiler's output (``-Xptxas -v`` register and
    shared-memory report; empty when nothing was compiled)."""
    so = library_path()
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tmp = _nvcc(), so.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_suffix(f".{src.stem}.o") for src in _sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
            for src, o in zip(_sources(), objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    link = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
    runs = list(zip(cmds, [p.returncode for p in procs], outs))
    if all(rc == 0 for _, rc, _ in runs):
        proc = subprocess.run(link, capture_output=True, text=True)
        runs.append((link, proc.returncode, proc.stdout + proc.stderr))
    for o in objs:
        o.unlink(missing_ok=True)
    for cmd, rc, out in runs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
    os.replace(tmp, so)
    return so, "".join(out for _, _, out in runs)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
