"""The port's banded E-steps, tau M-step and EM against the JAX package's
(f64, CPU), on the problem of ``tests/test_longt.py`` (xdim 2, ydim 12,
T 64, R 4, blocks of 16): ``laplace_estep_banded`` (with and without
weights) and ``pauto_sum_banded``, the port's own dense E-step,
``learn_tau_banded`` (with and without the online prior),
``vi_estep_banded``, 3-iteration banded Laplace and VI fits against
``pgpfa.em.fit.fit_loop``, online ``'diag'`` on an injected stream,
checkpoint resume and ``PPGPFAfit(config=...)``; on the card, both banded
E-steps against the CPU. The JAX side is the JAX package's output on the
same inputs, recorded by ``tests/torch_longt_reference.py`` (its programs
cannot run within the suite's time limit; see there). The block algebra
and the costs: ``tests/test_torch_longt.py``.

Tolerances. The two packages' f32 factors of each block round differently
(LAPACK's ``spotrf`` here, XLA's Cholesky there) and one f64
Newton-Schulz step leaves about (kappa eps32)^2 of that in every prior and
posterior block inverse; the fixed 12-body Newton stops at a gradient of
~2e-7 on that floor, so the modes differ by ~1e-8 (measured 1.3e-8
absolute, of entries up to 1.7) while the objectives agree to ~5e-12
relative. Each tolerance below is about ten times the difference measured
unless its test says otherwise. Fits: iteration 1 as the E-step, later
iterations within the EM-chaos envelope of ``tests/test_torch_fit.py``
(1e-6 x 5^(n-1) on the nPLL).
"""

import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import pgpfa_torch
from pgpfa_torch import FitConfig, fit, fit_loop
from pgpfa_torch.infer import laplace_longt as TL
from pgpfa_torch.infer import variational_longt as TVL
from pgpfa_torch.infer.laplace import laplace_estep_from_arrays
from pgpfa_torch.learn import mstep_gp as TG
from torch_helpers import longt_problem, npy, rel_err, requires_cuda, t64
from torch_longt_reference import N_ITER, ONLINE_IDX, S, load

PLL_REL, MEAN_TOL, VSM_TOL = 1e-10, 2e-7, 2e-8
CHAOS_ABS = 1e-6  # the fits' envelope base (tests/test_torch_fit.py)


@pytest.fixture(scope="module")
def problem():
    return longt_problem()


@pytest.fixture(scope="module")
def ref():
    """The JAX package's outputs (tests/torch_longt_reference.py)."""
    return load()


def _targs(p):
    return t64(p["C"]), t64(p["d"]), t64(p["tau"]), t64(p["Y"]), p["T"], p["bin_ms"]


# ---------------------------------------------------------------- E-step


@pytest.fixture(scope="module")
def fits(problem):
    """The port's 3-iteration banded fits, Laplace and VI, from the init."""
    p = problem
    return {m: fit(p["init"], p["Y"], p["bin_ms"],
                   FitConfig(max_em_iter=N_ITER, time_block=S, inference_method=m), device="cpu")
            for m in ("laplace", "variational")}


def _init_args(p):
    i = p["init"]
    return t64(i["C"]), t64(i["d"]), t64(i["tau"]), t64(p["Y"])


@pytest.fixture(scope="module")
def esteps(problem):
    """The port's cold banded Laplace E-step at the fits' init, without
    per-neuron weights and with them."""
    p = problem
    return {key: TL.laplace_estep_banded(*_init_args(p), p["T"], p["bin_ms"], S,
                                         weights=None if key == "plain" else t64(p["w"]))
            for key in ("plain", "weights")}


@pytest.mark.parametrize("key", ["plain", "weights"])
def test_laplace_estep_banded_matches_jax(esteps, ref, key):
    """The E-step's results and ``pauto_sum_banded`` of them."""
    t, pt = esteps[key]
    j = {f: ref[f"estep_{key}_{f}"] for f in (*TL.BandedInfRes._fields, "pll", "pauto")}
    assert abs(float(pt) - float(j["pll"])) <= PLL_REL * abs(float(j["pll"]))
    assert rel_err(t.trial_obj, j["trial_obj"]) <= PLL_REL
    np.testing.assert_allclose(npy(t.post_mean), j["post_mean"], rtol=0, atol=MEAN_TOL)
    for f in ("post_vsm", "vsm_gp_diag", "vsm_gp_off"):
        assert getattr(t, f).shape == j[f].shape
        np.testing.assert_allclose(npy(getattr(t, f)), j[f], rtol=0, atol=VSM_TOL, err_msg=f)
    # both stop at the gradient floor of the mixed-precision factors
    assert float(t.grad_norm.max()) < 1e-5 and j["grad_norm"].max() < 1e-5
    assert torch.equal(t.newton_iters, torch.zeros(4, dtype=torch.int32))
    np.testing.assert_allclose(npy(TL.pauto_sum_banded(t)), j["pauto"], rtol=0, atol=1e-6)


def test_banded_estep_matches_the_ports_dense_estep(problem, esteps):
    """The banded E-step against the port's own dense one on the same data,
    the tolerances of tests/test_longt.py:29-57 (the banding's truncation
    here is below 1e-8)."""
    p = problem
    dense, pll_d = laplace_estep_from_arrays(*_init_args(p), p["T"], p["bin_ms"])
    band, pll_b = esteps["plain"]
    assert abs(float(pll_b) - float(pll_d)) <= 1e-7
    np.testing.assert_allclose(npy(band.post_mean), npy(dense.post_mean), rtol=0, atol=1e-6)
    np.testing.assert_allclose(npy(band.post_vsm), npy(dense.post_vsm), rtol=0, atol=1e-7)
    gp, ref = npy(band.vsm_gp_dense()), npy(dense.post_vsm_gp)
    for i in range(p["T"] // S):
        sl = slice(i * S, (i + 1) * S)
        np.testing.assert_allclose(gp[:, :, sl, sl], ref[:, :, sl, sl], rtol=0, atol=1e-7)


# ---------------------------------------------------------------- tau M-step


@pytest.mark.parametrize("with_prior", [False, True])
def test_learn_tau_banded_matches_jax(problem, ref, with_prior):
    """The secant M-step from the JAX E-step's moments, without and with the
    online proximal prior, 12 iterations. The cost is fixed only to its
    ~5e-9 relative rounding floor (tests/test_torch_longt.py's cost test),
    and near the optimum the accept tests tie on it, so the two secant paths
    stop at different points of a flat minimum (accepted counts differ):
    measured 1.8e-10 s and 1.1e-9 s apart. Tau held to 1e-7 s, the cost to
    2e-8 relative."""
    p = problem
    key = "prior" if with_prior else "noprior"
    means, vd, vo = (t64(ref[f"estep_plain_{f}"]) for f in ("post_mean", "vsm_gp_diag",
                                                             "vsm_gp_off"))
    prior = (t64(p["tau"] * 1.2), 0.05) if with_prior else None
    t = TG.learn_tau_banded(means, vd, vo, t64(p["init"]["tau"]), p["bin_ms"], prior=prior,
                            maxiter=12)
    np.testing.assert_allclose(npy(t.tau), ref[f"learntau_{key}_tau"], rtol=0, atol=1e-7)
    assert rel_err(t.cost, ref[f"learntau_{key}_cost"]) < 2e-8
    assert t.niter.dtype == torch.int32 and bool((t.niter > 0).all())


# ---------------------------------------------------------------- banded VI


def test_vi_estep_banded_matches_jax(problem, ref):
    """The cold banded VI E-step at the fits' init, 150 L-BFGS iterations:
    bound and nPLL to 1e-8 relative, the moments to 1e-5 and 1e-7: the
    L-BFGS accept tests tie on rounding near the optimum, so the iterates
    differ where the bound does not (the tolerances of
    tests/test_torch_variational.py)."""
    p = problem
    t, pt, vt, _ = TVL.vi_estep_banded(*_init_args(p), p["T"], p["bin_ms"], S)
    assert abs(float(vt) - float(ref["vi_vlb"])) <= 1e-8 * abs(float(ref["vi_vlb"]))
    assert abs(float(pt) - float(ref["vi_pll"])) <= 1e-8 * abs(float(ref["vi_pll"]))
    np.testing.assert_allclose(npy(t.post_mean), ref["vi_post_mean"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(npy(t.post_vsm), ref["vi_post_vsm"], rtol=0, atol=1e-7)
    np.testing.assert_allclose(npy(t.vsm_gp_off), ref["vi_vsm_gp_off"], rtol=0, atol=1e-7)


# ---------------------------------------------------------------- EM


@pytest.mark.parametrize("method", ["laplace", "variational"])
def test_banded_fit_matches_jax(fits, ref, method):
    """Iteration 1's nPLL to 1e-9 relative (the E-step's agreement), then
    the chaos envelope ``base * 5^(n-1)``. Laplace: base 1e-6, as
    tests/test_torch_fit.py. VI: the fixed-budget L-BFGS stops farther from
    the optimum and its accept tests tie on rounding there (measured bound
    differences 4.2e-8, 6.6e-7 and 1.2e-5 over the three iterations), so
    the bound's iteration 1 within 1e-7 (tests/test_torch_variational.py's
    L-BFGS BOUND_TOL) and a base of 1e-5. Tau to 1e-7 after iteration 1 and
    1e-6 after the last."""
    t = fits[method]
    j = {h: ref[f"fit_{method}_{h}"] for h in ("post_loglik", "var_lower_bound", "tau_seq",
                                                "C_seq")}
    base = CHAOS_ABS if method == "laplace" else 1e-5
    for name in ("post_loglik", "var_lower_bound"):
        a, b = npy(getattr(t, name)), j[name]
        assert abs(a[0] - b[0]) <= max(1e-9 * abs(b[0]), 1e-7 if name == "var_lower_bound" else 0)
        for n in range(1, N_ITER):
            assert abs(a[n] - b[n]) <= base * 5.0 ** (n - 1), (name, n, a[n] - b[n])
    np.testing.assert_allclose(npy(t.tau_seq[0]), j["tau_seq"][0], rtol=0, atol=1e-7)
    np.testing.assert_allclose(npy(t.tau), j["tau_seq"][-1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(npy(t.C), j["C_seq"][-1], rtol=0, atol=1e-5)
    assert torch.equal(t.newton_iters, torch.zeros(N_ITER, 4, dtype=torch.int32))


def test_banded_online_diag_matches_jax(problem, ref):
    """Online 'diag' EM, batch 2, on an injected minibatch stream: the
    banded tau M-step with the proximal prior inside the online update.
    Iteration 1's nPLL to 1e-9 relative. The tau M-step then stops on its
    cost's rounding floor (the M-step test): after iteration 1 the JAX
    package's tau for latent 2 sits 1.7e-7 s from the port's, which lies
    within 1e-8 s of both packages' dense online fits. So tau and C are held
    to tests/test_longt.py's banded-against-dense tolerances (1e-6, 1e-5)
    and iteration 2's nPLL, which moves ~70 nats per second of tau here, to
    1e-4 (measured 1.1e-5)."""
    p = problem
    kw = dict(em_mode="online", batch_size=2, max_em_iter=2, time_block=S)
    t = fit(p["init"], p["Y"], p["bin_ms"], FitConfig(**kw), device="cpu",
            batch_indices=ONLINE_IDX)
    pj, pt = ref["online_post_loglik"], npy(t.post_loglik)
    assert abs(pt[0] - pj[0]) <= 1e-9 * abs(pj[0])
    assert abs(pt[1] - pj[1]) <= 1e-4
    np.testing.assert_allclose(npy(t.tau_seq), ref["online_tau_seq"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(npy(t.C_seq), ref["online_C_seq"], rtol=0, atol=1e-5)
    dense = fit(p["init"], p["Y"], p["bin_ms"], FitConfig(**{**kw, "time_block": None}),
                device="cpu", batch_indices=ONLINE_IDX)
    np.testing.assert_allclose(npy(t.tau_seq), npy(dense.tau_seq), rtol=0, atol=1e-7)


def test_banded_checkpoint_resume_and_class_driver(problem, fits):
    """``fit_loop`` stopped after 1 of 3 iterations and resumed equals the
    uninterrupted banded fit bit for bit; ``PPGPFAfit(config=...)`` takes
    the banded config and reproduces ``fit``'s nPLL."""
    p = problem
    cfg = FitConfig(max_em_iter=N_ITER, time_block=S)
    full = fits["laplace"]
    with tempfile.TemporaryDirectory() as tmp:
        ck = str(Path(tmp) / "ck.npz")
        fit_loop(p["init"], p["Y"], p["bin_ms"], cfg, device="cpu", checkpoint_path=ck,
                 stop_after=1)
        res = fit_loop(p["init"], p["Y"], p["bin_ms"], cfg, device="cpu", resume_from=ck)
    for f in full._fields:
        if f != "iter_sec":
            assert torch.equal(getattr(res, f), getattr(full, f)), f
    ds = pgpfa_torch.dataset(xdim=2, ydim=12, numTrials=4, trialDur=1280, binSize=20, seed=11)
    ds.Y = p["Y"]
    cls = pgpfa_torch.PPGPFAfit(ds, p["init"], config=cfg, device="cpu")
    np.testing.assert_array_equal(cls.posteriorLikelihood, npy(full.post_loglik))
    assert cls.infRes["post_vsmGP"][0].shape == (p["T"], p["T"], 2)
    assert cls.learningDetails[0]["inference_newton_iters"].tolist() == [0, 0, 0, 0]


# ---------------------------------------------------------------- the card


@requires_cuda
@pytest.mark.parametrize("method", ["laplace", "variational"])
def test_banded_estep_on_the_card_matches_the_cpu(problem, method):
    """The banded E-steps on the card (both kernels at (4, 32, 32) and
    (2, 16, 16)) against the CPU. Laplace: nPLL to 1e-9 relative, modes to
    5e-6 (the fixed Newton freezes each trial where a step's decrease falls
    below the objective's rounding, at a point that depends on the f32
    factors' rounding; chip_smoke.py's LONGT_DEV_MEAN). VI: bound and nPLL
    to 1e-8 relative, means to 1e-5 (the L-BFGS ties, as
    test_vi_estep_banded_matches_jax)."""
    from pgpfa_torch.ops.cuda_kernels import chol32, ns_step

    p = problem
    run = TL.laplace_estep_banded if method == "laplace" else TVL.vi_estep_banded
    cpu = run(*_targs(p), block_size=S)
    chol32.launches_by_shape.clear()
    ns_step.launches_by_shape.clear()
    args = [a.cuda() if isinstance(a, torch.Tensor) else a for a in _targs(p)]
    card = run(*args, block_size=S)
    torch.cuda.synchronize()
    assert chol32.launches_by_shape[(4, 2 * S)] > 0 and ns_step.launches_by_shape[(2, S)] > 0
    rel, mean_tol = (1e-9, 5e-6) if method == "laplace" else (1e-8, 1e-5)
    n_scalars = 1 if method == "laplace" else 2  # nPLL, and the VI bound
    for a, b in zip(card[1:1 + n_scalars], cpu[1:1 + n_scalars]):
        assert abs(float(a) - float(b)) <= rel * abs(float(b))
    np.testing.assert_allclose(npy(card[0].post_mean), npy(cpu[0].post_mean), rtol=0,
                               atol=mean_tol)


