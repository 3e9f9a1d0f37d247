"""The JAX package's multi-device and f32 banded outputs, recorded.

    python tests/torch_parallel_reference.py

runs the JAX package on the CPU and writes ``tests/torch_parallel_reference.npz``,
which ``tests/test_torch_parallel.py`` and ``tests/test_torch_longt_f32.py``
hold the port against:

* ``pgpfa.parallel.mesh.mesh_for_trials`` for 1..20 trials on 8 devices;
* ``pgpfa.parallel.sharded.fit_sharded`` on the 8-device virtual CPU mesh,
  on ``tests/test_parallel.py``'s problem (16 trials x 16 neurons, 30 bins
  of 20 ms, xdim 2, seed 4, init seed 0): batch Laplace (4 iterations),
  L-BFGS VI (3 iterations, ``vi_maxiter=60``, ``vi_maxiter_warm=40``) and
  banded Laplace (``time_block=6``, init tau (0.015, 0.02) s, 2 iterations);
* ``sharded_estep_stats`` on that problem at the init;
* ``pgpfa.parallel.timeshard.btd_solve_cr_timesharded`` on a 2 x 4 mesh,
  on ``tests/test_parallel.py:45-66``'s system;
* the banded fits of ``tests/test_f32_mode.py``'s ``"banded"`` configuration
  (5 trials x 20 neurons, 1000 ms of 20 ms bins, taus (0.05, 0.08) s, seed
  123, init seed 0, ``time_block=25``, 4 iterations), Laplace and VI, each
  in f32 (``PGPFA_X64=0``) and in f64, in subprocesses.

Why recorded: these JAX programs (the sharded ones on 8 virtual devices,
the banded ones in two precisions) take minutes to compile and run beside
the rest of the suite on six workers, which the suite's time limit cannot
hold; so they run here, once, and the tests run only the port. Rerun this
script after a change to the JAX package's parallel or banded paths, or to
the inputs. The port's inputs are remade from the same seeds by the port's
NumPy data path (``tests/torch_helpers.py``), which draws the same numbers.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

PATH = Path(__file__).with_name("torch_parallel_reference.npz")
REPO = Path(__file__).resolve().parents[1]
HIST = ("post_loglik", "var_lower_bound", "C", "d", "tau", "C_seq", "tau_seq")
BANDED_TAU = np.array([0.015, 0.02])
F32_CFG = dict(max_em_iter=4, time_block=25)
F32_BIN = 20.0


def cr_system():
    """tests/test_parallel.py:51-56's block-tridiagonal system."""
    rng = np.random.default_rng(7)
    R, nb, m = 2, 16, 4
    Ds = rng.standard_normal((R, nb, m, m))
    D = np.einsum("rnij,rnkj->rnik", Ds, Ds) + 4 * m * np.eye(m)
    B = 0.4 * rng.standard_normal((R, nb - 1, m, m))
    return D, B, rng.standard_normal((R, nb, m, 2))


def sharded_configs(FitConfig):
    return {
        "laplace": (FitConfig(max_em_iter=4), None),
        "vi": (FitConfig(max_em_iter=3, inference_method="variational", vi_maxiter=60,
                         vi_maxiter_warm=40, vi_solver="lbfgs"), None),
        "banded": (FitConfig(max_em_iter=2, time_block=6), BANDED_TAU),
    }


def f32_problem():
    """tests/test_f32_mode.py's "banded" data and init (the port's NumPy
    data path, the same draws as ``pgpfa.dataset(backend="numpy")``)."""
    sys.path.insert(0, str(REPO))
    from pgpfa_torch import dataset, initialize_params

    ds = dataset(xdim=2, ydim=20, numTrials=5, trialDur=1000, binSize=20, dOffset=1,
                 fixTau=True, fixedTau=np.array([0.05, 0.08]), seed=123)
    return ds, initialize_params(2, 20, ds, seed=0)


def logdet_matrices():
    """SPD ``(4, 50, 50)`` matrices, condition ~1e3, for the f32 block
    inverse and logdet."""
    rng = np.random.default_rng(9)
    M = rng.normal(size=(4, 50, 50)) / np.sqrt(50)
    return M @ np.swapaxes(M, 1, 2) + 4e-3 * np.eye(50)


def load():
    with np.load(PATH) as f:
        return dict(f)


def _banded_worker(flag: str):
    """One precision's banded fits and block inverses, as JSON on the last
    line of stdout."""
    sys.path.insert(0, str(REPO))
    os.environ["PGPFA_X64"] = flag
    os.environ["PGPFA_COMPILE_CACHE"] = "0"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import pgpfa
    from pgpfa.ops.blockmat import inv_logdet_psd_mixed

    X, ld = jax.vmap(inv_logdet_psd_mixed)(jnp.asarray(logdet_matrices()))
    ds, init = f32_problem()
    out = {"inv": np.asarray(X, np.float64).tolist(), "logdet": np.asarray(ld, np.float64).tolist()}
    for method in ("laplace", "variational"):
        res = pgpfa.fit_loop(init, ds.Y, F32_BIN,
                             pgpfa.FitConfig(inference_method=method, **F32_CFG))
        for h in ("post_loglik", "var_lower_bound", "tau", "tau_seq"):
            out[f"{method}_{h}"] = np.asarray(getattr(res, h), np.float64).tolist()
        out[f"{method}_dtype"] = str(res.C.dtype)
    print(json.dumps(out))


def main():
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()
    os.environ.setdefault("PGPFA_X64", "1")
    os.environ["PGPFA_COMPILE_CACHE"] = "0"
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(Path(__file__).parent))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from pgpfa.em.fit import FitConfig
    from pgpfa.parallel.mesh import make_mesh, mesh_for_trials, trial_sharding
    from pgpfa.parallel.sharded import fit_sharded, sharded_estep_stats
    from pgpfa.parallel.timeshard import btd_solve_cr_timesharded, make_mesh_2d
    from torch_helpers import parallel_problem

    assert len(jax.devices()) == 8
    out = {"mesh_sizes": np.array([mesh_for_trials(n).devices.size for n in range(1, 21)])}

    ds, init = parallel_problem()
    mesh = make_mesh()
    for key, (cfg, tau) in sharded_configs(FitConfig).items():
        p = dict(init) if tau is None else {**init, "tau": tau}
        r = fit_sharded(p, ds.Y, 20.0, cfg, mesh=mesh)
        for h in HIST:
            out[f"sharded_{key}_{h}"] = np.asarray(getattr(r, h))

    C, d, tau = (jnp.asarray(init[k]) for k in ("C", "d", "tau"))
    Y = jax.device_put(jnp.asarray(ds.Y, dtype=jnp.float64), trial_sharding(mesh))
    X, _, _, pauto, obj_sum, n = sharded_estep_stats(C, d, tau, Y, ds.T, 20.0, mesh)
    out.update(stats_X=np.asarray(X), stats_pauto=np.asarray(pauto),
               stats_obj_sum=np.asarray(obj_sum), stats_n=np.asarray(n))

    D, B, rhs = cr_system()
    out["cr_timesharded"] = np.asarray(btd_solve_cr_timesharded(
        jnp.asarray(D), jnp.asarray(B), jnp.asarray(rhs), make_mesh_2d(n_trial=2)))

    for flag, tag in (("0", "f32"), ("1", "f64")):
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        r = subprocess.run([sys.executable, __file__, "--banded", flag], capture_output=True,
                           text=True, env=env, cwd=REPO, check=True)
        for k, v in json.loads(r.stdout.strip().splitlines()[-1]).items():
            out[f"banded_{tag}_{k}"] = np.asarray(v)
    np.savez_compressed(PATH, **out)
    print(f"wrote {PATH} ({PATH.stat().st_size} bytes, {len(out)} arrays)")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--banded"]:
        _banded_worker(sys.argv[2])
    else:
        main()
