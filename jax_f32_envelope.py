#!/usr/bin/env python3
"""The JAX package's own f32-against-f64 difference on the Stevenson
surrogate, the source of ``chip_smoke.py``'s f32 envelope.

    python3 jax_f32_envelope.py [n_trials]

Runs ``pgpfa.em.fit.fit`` (3 EM iterations; Laplace, and dual-Newton VI) on
the first ``n_trials`` (default 10) trials of the surrogate (xdim 5, seed
2011; Poisson-PCA init with seed 0 from all 100 trials, as ``chip_smoke.py``
builds it), once with ``PGPFA_X64=1`` and once with ``PGPFA_X64=0``, each in
its own CPU process (x64 is a process-global JAX flag), and prints the
largest difference over the iterations of the nPLL, the bound and tau, and
the JSON of both runs. Imports JAX; the port (``pgpfa_torch``) never does.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent

_RUN = r'''
import json, os, sys
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from pgpfa.data.init import initialize_params
from pgpfa.data.surrogate import stevenson_surrogate
from pgpfa.em.fit import FitConfig, fit

ds = stevenson_surrogate(xdim=5, seed=2011)
init = initialize_params(5, ds.ydim, ds, seed=0)
dt = np.float64 if os.environ["PGPFA_X64"] == "1" else np.float32
out = {{}}
for m in ("laplace", "variational"):
    r = fit({{k: np.asarray(v, dt) for k, v in init.items()}}, np.asarray(ds.Y[:{n}], dt),
            float(ds.binSize), FitConfig(inference_method=m, vi_solver="newton", max_em_iter=3))
    out[m] = {{"pll": np.asarray(r.post_loglik).tolist(), "vlb": np.asarray(r.var_lower_bound).tolist(),
               "tau_seq": np.asarray(r.tau_seq).tolist(), "dtype": str(r.C.dtype)}}
print(json.dumps(out))
'''


def run(flag: str, n: int) -> dict:
    env = dict(os.environ, PGPFA_X64=flag, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _RUN.format(repo=str(REPO), n=n)], env=env,
                          capture_output=True, text=True, check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    r64, r32 = run("1", n), run("0", n)
    for m in ("laplace", "variational"):
        a, b = r64[m], r32[m]
        assert b["dtype"] == "float32" and a["dtype"] == "float64"
        diff = {k: max(abs(x - y) for x, y in zip(a[k], b[k])) for k in ("pll", "vlb")}
        diff["tau"] = max(abs(x - y) for ra, rb in zip(a["tau_seq"], b["tau_seq"])
                          for x, y in zip(ra, rb))
        print(f"{m}, first {n} trials, 3 EM iterations, max |f32 - f64|: nPLL {diff['pll']:.4e}, "
              f"bound {diff['vlb']:.4e}, tau {diff['tau']:.4e} s")
    print(json.dumps({"f64": r64, "f32": r32}))


if __name__ == "__main__":
    main()
