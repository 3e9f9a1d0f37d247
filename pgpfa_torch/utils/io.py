"""Persistence (pickled variables and fit checkpoints) and console helpers,
NumPy only.

Twin of ``pgpfa/utils/io.py`` (kept here so that nothing in the port imports
the JAX package): the same ``.npz`` keys, so a checkpoint written by either
package loads in the other. ``params`` ``C``, ``d``, ``tau``; ``em_iter``;
optional ``warm`` and ``rng_key``; each entry ``k`` of ``extra`` as
``extra_k``. The port never writes ``rng_key``, which holds a JAX key.
"""

from __future__ import annotations

import os
import pickle
import sys
import time
from typing import Any, Optional

import numpy as np


def save_variables(variable: Any, filename: str) -> None:
    """Pickle any object."""
    with open(filename, "wb") as f:
        pickle.dump(variable, f)


def open_variables(filename: str) -> Any:
    """Unpickle a file written by :func:`save_variables` (unpickling runs
    code: open only files this program wrote)."""
    with open(filename, "rb") as f:
        return pickle.load(f)


def save_checkpoint(filename: str, params, em_iter: int, warm=None, rng_key=None, extra=None):
    """Checkpoint a fit's resumable state as an ``.npz``, atomically: written
    to a temporary file, then moved over ``filename`` with ``os.replace``, so
    a write cut short leaves the previous checkpoint whole."""
    payload = {
        "C": np.asarray(params["C"]),
        "d": np.asarray(params["d"]),
        "tau": np.asarray(params["tau"]),
        "em_iter": np.asarray(em_iter),
    }
    if warm is not None:
        payload["warm"] = np.asarray(warm)
    if rng_key is not None:
        payload["rng_key"] = np.asarray(rng_key)
    for k, v in (extra or {}).items():
        payload["extra_" + k] = np.asarray(v)
    final = filename if filename.endswith(".npz") else filename + ".npz"
    tmp = final + ".tmp.npz"  # np.savez appends .npz unless already suffixed
    np.savez(tmp, **payload)
    os.replace(tmp, final)


def load_checkpoint(filename: str) -> dict:
    """Load a checkpoint written by :func:`save_checkpoint` (of either package):
    ``{'params': {'C', 'd', 'tau'}, 'em_iter', 'warm', 'rng_key', 'extra'}``,
    ``None`` for an absent ``warm`` or ``rng_key``."""
    with np.load(filename) as blob:
        return {
            "params": {"C": blob["C"], "d": blob["d"], "tau": blob["tau"]},
            "em_iter": int(blob["em_iter"]),
            "warm": blob["warm"] if "warm" in blob else None,
            "rng_key": blob["rng_key"] if "rng_key" in blob else None,
            "extra": {k[6:]: blob[k] for k in blob.files if k.startswith("extra_")},
        }


def print_options_banner(title: str, rows) -> None:
    """ASCII options box of ``(label, value)`` rows."""
    width = 55
    print("+" + f" {title} ".center(width, "-") + "+")
    for label, value in rows:
        body = f" {label}: "
        val = f"{value} "
        pad = width - len(body) - len(val)
        print("|" + body + " " * max(pad, 1) + val + "|")
    print("+" + "-" * width + "+")


class Printer:
    """One-line-rewrite progress printer."""

    def __init__(self, data):
        sys.stdout.write("\r\x1b[K" + str(data))
        sys.stdout.flush()

    @staticmethod
    def stdout(message: str):
        sys.stdout.write(message)
        sys.stdout.write("\b" * len(message))


_TIC: Optional[float] = None


def tic():
    """Start the :func:`toc` clock."""
    global _TIC
    _TIC = time.time()


def toc():
    """Print the seconds since :func:`tic`."""
    if _TIC is None:
        print("Toc: start time not set")
    else:
        print(f"Elapsed time is {time.time() - _TIC} seconds.")


def stars(p: float) -> str:
    """Significance glyphs of a p-value."""
    if p < 0.0001:
        return "****"
    if p < 0.001:
        return "***"
    if p < 0.01:
        return "**"
    if p < 0.05:
        return "*"
    return "-"
