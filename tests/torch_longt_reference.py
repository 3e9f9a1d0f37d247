"""The JAX package's outputs on the long-trial tests' inputs, recorded.

    python tests/torch_longt_reference.py

runs the JAX package (CPU, f64) on the inputs that ``tests/test_torch_longt.py``
and ``tests/test_torch_longt_em.py`` give the port, and writes
``tests/torch_longt_reference.npz``; the tests hold the port against it.
The banded JAX programs take ~2 CPU-minutes to compile and run alone, and
over ten times that in wall time beside the rest of the suite on six
workers, which the suite's time limit cannot hold; so they run here, once,
and the tests run only the port and the cheapest JAX functions. Rerun this
script after a change to the JAX package's banded path or to the inputs.

Every input is made from a seed with NumPy (``torch_helpers.longt_problem``,
the red ``tests/test_longt.py::test_long_trial_T1000``'s data), and stored
where the tests cannot remake it on every platform: the T = 1000 spike
counts, whose latents ``rng.multivariate_normal`` draws differently under
other NumPy builds.
"""

import os
import sys
from pathlib import Path

import numpy as np

PATH = Path(__file__).with_name("torch_longt_reference.npz")
S = 16
CR_NBS = (5, 7, 8)
ONLINE_IDX = [np.array([0, 2]), np.array([3, 1])]
N_ITER = 3


def btd_system(seed, lanes=3, nb=5, m=5, k=3):
    """Random SPD block-tridiagonal systems (diagonally dominant blocks)."""
    rng = np.random.default_rng(seed)
    Ds = rng.standard_normal((lanes, nb, m, m))
    D = np.einsum("lnij,lnkj->lnik", Ds, Ds) + 4 * m * np.eye(m)
    B = 0.4 * rng.standard_normal((lanes, nb - 1, m, m))
    return D, B, rng.standard_normal((lanes, nb, m, k))


def tau_points(tau, bin_ms, xdim):
    """Each latent's lane at three points around its log gamma."""
    pg = np.log(1.0 / (np.asarray(tau) * 1000.0 / bin_ms) ** 2)
    lanes = np.repeat(np.arange(xdim), 3)
    return pg[lanes] + np.tile([-0.3, 0.0, 0.4], xdim), lanes


def dual_rho(shape):
    return 0.3 * np.random.default_rng(5).standard_normal(shape)


def red_test_data():
    """tests/test_longt.py:166-185's data: 2 trials x 8 neurons, T = 1000,
    latents drawn from the GP prior, tau started at 0.06 s."""
    from pgpfa.oracle.oracle_np import rbf_block

    rng = np.random.default_rng(3)
    xdim, ydim, T, R, bin_ms = 2, 8, 1000, 2, 10.0
    tau = np.array([0.05, 0.08])
    C = rng.uniform(-0.4, 0.4, (ydim, xdim))
    d = rng.uniform(-1.0, -0.2, ydim)
    X = np.stack([np.stack([rng.multivariate_normal(np.zeros(T), rbf_block(tau[k], T, bin_ms))
                            for k in range(xdim)]) for _ in range(R)])
    Y = rng.poisson(np.exp(np.einsum("nk,rkt->rnt", C, X) + d[None, :, None])).astype(float)
    return {"C": C, "d": d, "tau": np.array([0.06, 0.06])}, Y, bin_ms


def load():
    with np.load(PATH) as f:
        return dict(f)


def main():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    os.environ.setdefault("PGPFA_X64", "1")
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from pgpfa.em.fit import FitConfig, fit_loop
    from pgpfa.infer import laplace_longt as JL
    from pgpfa.infer import variational_longt as JVL
    from pgpfa.learn import mstep_gp as JG
    from pgpfa.ops import blocktridiag as JBT
    from torch_helpers import longt_problem

    out = {}
    for nb in CR_NBS:
        D, B, rhs = (a[0] for a in btd_system(nb, lanes=1, nb=nb))
        out[f"cr_{nb}"] = np.asarray(JBT.btd_solve_cr(jnp.asarray(D), jnp.asarray(B),
                                                       jnp.asarray(rhs)))

    p = longt_problem()
    i = p["init"]
    args = (jnp.asarray(i["C"]), jnp.asarray(i["d"]), jnp.asarray(i["tau"]), jnp.asarray(p["Y"]),
            p["T"], p["bin_ms"])
    for key, w in (("plain", None), ("weights", jnp.asarray(p["w"]))):
        res, pll = JL.laplace_estep_banded(*args, block_size=S, weights=w)
        for f in res._fields:
            out[f"estep_{key}_{f}"] = np.asarray(getattr(res, f))
        out[f"estep_{key}_pll"] = np.asarray(pll)
        out[f"estep_{key}_pauto"] = np.asarray(JL.pauto_sum_banded(res))

    # the M-step's inputs: the plain E-step's moments
    means, vd, vo = (out[f"estep_plain_{f}"] for f in ("post_mean", "vsm_gp_diag", "vsm_gp_off"))
    R, xdim, T = means.shape
    mb = np.swapaxes(means.reshape(R, xdim, T // S, S), 0, 1)
    pts, lanes = tau_points(p["tau"], p["bin_ms"], xdim)
    vg = jax.jit(jax.vmap(jax.value_and_grad(JG.tau_cost_banded), in_axes=(0, 0, 0, 0, None)))
    f, g = vg(jnp.asarray(pts), jnp.asarray(mb[lanes]), jnp.asarray(vd.sum(0)[lanes]),
              jnp.asarray(vo.sum(0)[lanes]), float(R))
    out["taucost_f"], out["taucost_g"] = np.asarray(f), np.asarray(g)
    for key, prior in (("noprior", None), ("prior", (jnp.asarray(p["tau"] * 1.2), 0.05))):
        tr = JG.learn_tau_banded(jnp.asarray(means), jnp.asarray(vd), jnp.asarray(vo),
                                 jnp.asarray(i["tau"]), p["bin_ms"], prior=prior, maxiter=12)
        out[f"learntau_{key}_tau"], out[f"learntau_{key}_cost"] = np.asarray(tr.tau), np.asarray(tr.cost)

    cost = JVL.banded_dual_machinery(jnp.asarray(p["C"]), jnp.asarray(p["d"]),
                                     jnp.asarray(p["tau"]), p["T"], p["bin_ms"], S)[0]
    f, g = jax.jit(jax.vmap(jax.value_and_grad(cost)))(jnp.asarray(dual_rho(p["Y"].shape)),
                                                       jnp.asarray(p["Y"]))
    out["dual_f"], out["dual_g"] = np.asarray(f), np.asarray(g)
    res, pll, vlb, _ = JVL.vi_estep_banded(*args, block_size=S)
    for f in ("post_mean", "post_vsm", "vsm_gp_off"):
        out[f"vi_{f}"] = np.asarray(getattr(res, f))
    out["vi_pll"], out["vi_vlb"] = np.asarray(pll), np.asarray(vlb)

    hist = ("post_loglik", "var_lower_bound", "tau_seq", "C_seq", "d_seq")
    for method in ("laplace", "variational"):
        r = fit_loop(i, p["Y"], p["bin_ms"], FitConfig(max_em_iter=N_ITER, time_block=S,
                                                       inference_method=method))
        for h in hist:
            out[f"fit_{method}_{h}"] = np.asarray(getattr(r, h))
    r = fit_loop(i, p["Y"], p["bin_ms"], FitConfig(em_mode="online", batch_size=2, max_em_iter=2,
                                                   time_block=S), batch_indices=ONLINE_IDX)
    for h in hist:
        out[f"online_{h}"] = np.asarray(getattr(r, h))

    init, Y, bin_ms = red_test_data()
    r = fit_loop(init, Y, bin_ms, FitConfig(max_em_iter=2, time_block=50))
    out["t1000_Y"] = Y.astype(np.int16)
    out["t1000_C"], out["t1000_d"] = init["C"], init["d"]
    out["t1000_post_loglik"], out["t1000_tau_seq"] = np.asarray(r.post_loglik), np.asarray(r.tau_seq)
    np.savez_compressed(PATH, **out)
    print(f"wrote {PATH} ({PATH.stat().st_size} bytes, {len(out)} arrays)")


if __name__ == "__main__":
    main()
