"""The port's banded long-trial building blocks against the JAX package's
(f64, CPU): ``ops/blocktridiag.py``, ``inv_logdet_psd_mixed_d``'s exact
rules, the banded tau cost and the banded dual cost, on the problem of
``tests/test_longt.py`` (xdim 2, ydim 12, T 64, R 4, blocks of 16), and the
data of the red ``tests/test_longt.py::test_long_trial_T1000`` at T = 1000.
The block factor, solve and selected inverse, the banded prior and the
block inverse's derivative run through the JAX package here; the rest of
its side is its output on the same inputs, recorded by
``tests/torch_longt_reference.py`` (its programs cannot run within the
suite's time limit; see there). The E-steps, M-steps and fits:
``tests/test_torch_longt_em.py``.

Tolerances: the block algebra on well-conditioned random blocks to 1e-12
relative (the mixed-precision block inverse refines to the f64 floor
there); each other test states its tolerance and the reason.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pgpfa.ops import blockmat as JB
from pgpfa.ops import blocktridiag as JBT
from pgpfa.oracle.oracle_np import rbf_block as jax_rbf_block
from pgpfa_torch import FitConfig, fit
from pgpfa_torch.infer import variational_longt as TVL
from pgpfa_torch.learn import mstep_gp as TG
from pgpfa_torch.ops import blockmat as TB
from pgpfa_torch.ops import blocktridiag as TBT
from torch_helpers import longt_problem, npy, rel_err, requires_cuda, t64
from torch_longt_reference import CR_NBS, S, btd_system, dual_rho, load, tau_points

BLOCK_TOL = 1e-12


@pytest.fixture(scope="module")
def problem():
    return longt_problem()


@pytest.fixture(scope="module")
def ref():
    """The JAX package's outputs (tests/torch_longt_reference.py)."""
    return load()


def _targs(p):
    return t64(p["C"]), t64(p["d"]), t64(p["tau"]), t64(p["Y"]), p["T"], p["bin_ms"]


# ---------------------------------------------------------------- blocktridiag


def test_btd_factor_solve_and_selected_inverse_match_jax():
    """The factor (P, G, logdet), solves with vector and matrix right-hand
    sides and the selected inverse's diag, off1 and off2, three systems
    batched on the port's side, vmapped on JAX's."""
    D, B, rhs = btd_system(0)

    @jax.jit
    @jax.vmap
    def jax_all(D, B, rhs):
        fac = JBT.btd_factor(D, B)
        return (fac, JBT.btd_solve(fac, rhs), JBT.btd_solve(fac, rhs[..., 0]),
                JBT.btd_selected_inverse(fac))

    jfac, jx, jx1, jsel = jax_all(jnp.asarray(D), jnp.asarray(B), jnp.asarray(rhs))
    tfac = TBT.btd_factor(t64(D), t64(B))
    for f in ("P", "G", "logdet"):
        assert rel_err(getattr(tfac, f), getattr(jfac, f)) < BLOCK_TOL, f
    assert rel_err(TBT.btd_solve(tfac, t64(rhs)), jx) < BLOCK_TOL
    assert rel_err(TBT.btd_solve(tfac, t64(rhs[..., 0])), jx1) < BLOCK_TOL
    tsel = TBT.btd_selected_inverse(tfac)
    for f in ("diag", "off1", "off2"):
        assert getattr(tsel, f).shape == getattr(jsel, f).shape
        assert rel_err(getattr(tsel, f), getattr(jsel, f)) < BLOCK_TOL, f


def test_btd_solve_broadcasts_a_shared_factor():
    """A factor with a leading axis of 1 serves every lane of the right-hand
    side, as the E-steps use the prior's factor for all trials."""
    D, B, rhs = btd_system(1, lanes=1)
    fac = TBT.btd_factor(t64(D), t64(B))
    many = t64(np.concatenate([rhs[..., 0], 2 * rhs[..., 0]]))
    x = TBT.btd_solve(fac, many)
    assert torch.allclose(x[1], 2 * x[0], rtol=1e-14, atol=0)
    assert torch.equal(x[:1], TBT.btd_solve(fac, many[:1]))


@pytest.mark.parametrize("nb", CR_NBS)
def test_btd_solve_cr_matches_jax(ref, nb):
    """Block cyclic reduction against JAX's and the sequential solve, block
    counts that are and are not powers of two, vector and matrix right-hand
    sides (tests/test_longt.py holds JAX's to 1e-11)."""
    D, B, rhs = (a[0] for a in btd_system(nb, lanes=1, nb=nb))
    got = TBT.btd_solve_cr(t64(D), t64(B), t64(rhs))
    seq = TBT.btd_solve(TBT.btd_factor(t64(D), t64(B)), t64(rhs))
    np.testing.assert_allclose(npy(got), ref[f"cr_{nb}"], rtol=0, atol=1e-11)
    np.testing.assert_allclose(npy(got), npy(seq), rtol=0, atol=1e-11)
    vec = TBT.btd_solve_cr(t64(D), t64(B), t64(rhs[..., 0]))
    np.testing.assert_allclose(npy(vec), npy(got[..., 0]), rtol=0, atol=1e-13)


def test_btd_rbf_kernel_and_truncation(problem):
    p = problem
    jd, jb = JBT.btd_rbf_kernel(jnp.asarray(p["tau"]), p["T"], p["bin_ms"], S)
    td, tb = TBT.btd_rbf_kernel(t64(p["tau"]), p["T"], p["bin_ms"], S)
    np.testing.assert_allclose(npy(td), np.asarray(jd), rtol=1e-15, atol=0)
    np.testing.assert_allclose(npy(tb), np.asarray(jb), rtol=1e-15, atol=0)
    assert TBT.btd_truncation_error(p["tau"], p["bin_ms"], S) == JBT.btd_truncation_error(
        p["tau"], p["bin_ms"], S) < 1e-8
    with pytest.raises(ValueError):
        TBT.btd_rbf_kernel(t64(p["tau"]), p["T"], p["bin_ms"], 15)


def test_inv_logdet_psd_mixed_d_backward():
    """The exact rules against JAX's ``jax.grad`` through its custom JVP and
    against central finite differences, for a loss of both outputs and of
    the logdet alone (a ``None`` cotangent for the inverse)."""
    rng = np.random.default_rng(2)
    M = rng.standard_normal((3, 6, 6))
    H = M @ np.swapaxes(M, 1, 2) + 6 * np.eye(6)
    Wt = rng.standard_normal((3, 6, 6))

    def jloss(h):
        X, ld = jax.vmap(JB.inv_logdet_psd_mixed_d)(h)
        return jnp.sum(X * Wt) + jnp.sum(ld * jnp.arange(1.0, 4.0))

    def tloss(h, both=True):
        X, ld = TB.inv_logdet_psd_mixed_d(h)
        out = (ld * torch.arange(1.0, 4.0, dtype=h.dtype)).sum()
        return out + (X * t64(Wt)).sum() if both else out

    Ht = t64(H).requires_grad_(True)
    (g,) = torch.autograd.grad(tloss(Ht), Ht)
    assert rel_err(g, jax.jit(jax.grad(jloss))(jnp.asarray(H))) < 1e-12
    (g_ld,) = torch.autograd.grad(tloss(Ht, both=False), Ht)
    np.testing.assert_allclose(npy(g_ld), np.linalg.inv(H) * np.arange(1.0, 4.0)[:, None, None],
                               rtol=0, atol=1e-12)
    # central differences along a symmetric direction
    E = rng.standard_normal(H.shape)
    E = E + np.swapaxes(E, 1, 2)
    h = 1e-5
    with torch.no_grad():
        fd = (tloss(t64(H + h * E)) - tloss(t64(H - h * E))) / (2 * h)
    assert abs(float(fd) - float((g * t64(E)).sum())) < 1e-7 * abs(float(fd))


# ---------------------------------------------------------------- tau M-step


def test_tau_cost_banded_value_and_grad_match_jax(problem, ref):
    """The cost and its autograd gradient (through the block inverse's
    exact rules) against ``jax.value_and_grad``, each latent at three
    points, on the JAX E-step's moments. The tau lanes' prior blocks have
    condition numbers up to ~5e3, so the refined block inverses carry
    ~(kappa eps32)^2 and each package's cost lies off the exact f64 one
    (NumPy's dense inverse and slogdet of the banded K) by that floor:
    measured 5.8e-9 (port) and 2.9e-8 (JAX) of the largest cost; the two
    packages' costs differed by 3.5e-8 and their gradients by 2.4e-8 of the
    largest entry. Held to 3e-8 (port against exact) and 1e-7 (against
    JAX)."""
    p = problem
    means, vd, vo = (ref[f"estep_plain_{f}"] for f in ("post_mean", "vsm_gp_diag", "vsm_gp_off"))
    R, xdim, T = means.shape
    mb = means.reshape(R, xdim, T // S, S)
    Vd, Vo = vd.sum(0), vo.sum(0)
    pts, lanes = tau_points(p["tau"], p["bin_ms"], xdim)
    x = t64(pts).requires_grad_(True)
    f = TG.tau_cost_banded(x, t64(np.swapaxes(mb, 0, 1)[lanes]), t64(Vd[lanes]),
                           t64(Vo[lanes]), float(R))
    (g,) = torch.autograd.grad(f.sum(), x)
    assert rel_err(f, _exact_tau_cost(pts, mb, Vd, Vo, lanes)) < 3e-8
    assert rel_err(f, ref["taucost_f"]) < 1e-7
    assert rel_err(g, ref["taucost_g"]) < 1e-7


def _exact_tau_cost(pts, mb, Vd, Vo, lanes, eps=0.001):
    """The banded cost by NumPy's dense f64 inverse and slogdet of the
    banded K (zero past the first off-diagonal blocks)."""
    R, _, nb, s = mb.shape
    t = np.arange(s)
    out = []
    for p, k in zip(pts, lanes):
        a = np.exp(p)
        Kd = (1 - eps) * np.exp(-0.5 * a * (t[:, None] - t[None, :]) ** 2) + eps * np.eye(s)
        Kb = (1 - eps) * np.exp(-0.5 * a * ((t[:, None] + s) - t[None, :]) ** 2)
        K = np.kron(np.eye(nb), Kd) + np.kron(np.eye(nb, k=-1), Kb) + np.kron(np.eye(nb, k=1), Kb.T)
        Ki = np.linalg.inv(K)
        m = mb[:, k].reshape(R, nb * s)
        blk = lambda i, j: Ki[i * s:(i + 1) * s, j * s:(j + 1) * s]  # noqa: E731
        trv = (sum((blk(i, i) * Vd[k, i]).sum() for i in range(nb))
               + 2 * sum((blk(i + 1, i) * Vo[k, i]).sum() for i in range(nb - 1)))
        out.append(0.5 * R * np.linalg.slogdet(K)[1] + 0.5 * (np.einsum("rt,tu,ru->", m, Ki, m) + trv))
    return np.array(out)


# ---------------------------------------------------------------- banded VI


def test_banded_dual_cost_matches_jax(problem, ref):
    """The banded dual cost and its autograd gradient at a fixed rho, every
    trial: 1e-9 relative and 1e-8 of the largest entry (measured 9.1e-11
    on the cost: the two packages' f32 factors of the posterior blocks)."""
    p = problem
    tcost = TVL.banded_dual_machinery(*_targs(p)[:3], p["T"], p["bin_ms"], S)[0]
    r = t64(dual_rho(p["Y"].shape)).requires_grad_(True)
    f = tcost(r, t64(p["Y"]))
    (g,) = torch.autograd.grad(f.sum(), r)
    assert rel_err(f, ref["dual_f"]) < 1e-9
    assert rel_err(g, ref["dual_g"]) < 1e-8


# ---------------------------------------------------------------- T = 1000


def _red_test_data(ref):
    """tests/test_longt.py:166-185's data as recorded (its latents come from
    ``rng.multivariate_normal``, which other NumPy builds draw otherwise)."""
    init = {"C": ref["t1000_C"], "d": ref["t1000_d"], "tau": np.array([0.06, 0.06])}
    return init, ref["t1000_Y"].astype(float), 10.0


def test_red_test_data_T1000_falls_as_jax_does(ref):
    """The data of tests/test_longt.py::test_long_trial_T1000: 2 banded
    Laplace iterations of the port against JAX's ``fit_loop``, nPLL to 1e-8
    relative (measured 3.5e-11) and tau to 1e-8. Laplace EM's nPLL is not a
    bound: on this data it falls, in the port exactly as in the JAX package
    (and in the port's dense fit, test_red_test_data_on_the_card)."""
    init, Y, bin_ms = _red_test_data(ref)
    t = fit(init, Y, bin_ms, FitConfig(max_em_iter=2, time_block=50), device="cpu")
    pj, pt = ref["t1000_post_loglik"], npy(t.post_loglik)
    np.testing.assert_allclose(pt, pj, rtol=1e-8, atol=0)
    np.testing.assert_allclose(npy(t.tau_seq), ref["t1000_tau_seq"], rtol=0, atol=1e-8)
    assert pt[1] < pt[0] and pj[1] < pj[0]  # the triage: it falls in both


def test_long_trial_problem_matches_the_bench_script():
    """The port's NumPy copy of ``scripts/bench_longt.py:problem`` and of
    ``rbf_block`` draws the same data (at T = 200 here)."""
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    import bench_longt

    from pgpfa_torch.data.longt import long_trial_problem, rbf_block

    want = bench_longt.problem(200)
    got = long_trial_problem(200)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(rbf_block(0.08, 30, 10.0), jax_rbf_block(0.08, 30, 10.0))


# ---------------------------------------------------------------- the card


@requires_cuda
def test_red_test_data_on_the_card(ref):
    """The triage of tests/test_longt.py::test_long_trial_T1000 on the card:
    4 iterations of the port's banded and dense fits on its data give the
    same nPLL trajectory (1e-8 relative: the banding drops ~1.5e-9 at
    s = 50, tau <= 0.08 s), and it falls at every iteration."""
    init, Y, bin_ms = _red_test_data(ref)
    band = fit(init, Y, bin_ms, FitConfig(max_em_iter=4, time_block=50))
    dense = fit(init, Y, bin_ms, FitConfig(max_em_iter=4))
    pb, pd = npy(band.post_loglik), npy(dense.post_loglik)
    print(f"banded {pb.tolist()}; dense {pd.tolist()}; tau {npy(band.tau).tolist()}")
    np.testing.assert_allclose(pb, pd, rtol=1e-8, atol=0)
    assert np.all(np.diff(pb) < 0) and np.all(np.diff(pd) < 0)
