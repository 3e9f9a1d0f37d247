"""Online EM of the port against ``pgpfa.em.fit.fit_loop`` and the NumPy
oracle ``pgpfa.oracle.oracle_np.online_em_fit`` (f64, CPU), on the problem of
``tests/test_online_parity.py`` with its injected minibatch stream on all
three sides.

Tolerances: iteration 0's post_loglik to 1e-9 relative (identical inputs);
post_loglik 1e-6 absolute, C, d and tau 2e-5 and cd_cost 1e-6 at every
iteration, the tolerances the JAX suite holds itself to against the oracle.
"""

import numpy as np
import pytest
import torch

from pgpfa.em.fit import FitConfig as JaxFitConfig
from pgpfa.em.fit import fit_loop
from pgpfa.oracle import oracle_np as O
import pgpfa_torch
from pgpfa_torch import FitConfig
from pgpfa_torch.em.fit import draw_batch_indices
from torch_helpers import npy, requires_cuda

N_ITER, BATCH = 4, 3
PLL0_REL, PLL_TOL, PARAM_TOL, COST_TOL = 1e-9, 1e-6, 2e-5, 1e-6


@pytest.fixture(scope="module")
def problem():
    """The data, init and index stream of tests/test_online_parity.py."""
    rng = np.random.default_rng(7)
    xdim, ydim, T, R, bin_ms = 2, 10, 15, 8, 20.0
    C = rng.uniform(-0.5, 0.5, (ydim, xdim))
    d = rng.uniform(-1.0, 0.0, ydim)
    X = rng.standard_normal((R, xdim, T)) * 0.7
    Y = rng.poisson(np.exp(np.einsum("nk,rkt->rnt", C, X) + d[None, :, None])).astype(float)
    C0 = C + 0.15 * rng.standard_normal(C.shape)
    d0 = d + 0.1 * rng.standard_normal(d.shape)
    tau0 = np.array([0.2, 0.2])
    idx_seq = [rng.choice(R, size=BATCH, replace=False) for _ in range(N_ITER)]
    return dict(Y=Y, init={"C": C0, "d": d0, "tau": tau0}, bin_ms=bin_ms, idx_seq=idx_seq)


def _config(**kw):
    return dict(em_mode="online", batch_size=BATCH, max_em_iter=N_ITER, **kw)


def _port(p, dtype=torch.float64, **kw):
    return pgpfa_torch.fit(p["init"], p["Y"], p["bin_ms"], FitConfig(**_config(**kw)),
                           device="cpu", dtype=dtype, batch_indices=p["idx_seq"])


def _jax(p, **kw):
    return fit_loop(p["init"], p["Y"], p["bin_ms"], JaxFitConfig(**_config(**kw)),
                    batch_indices=p["idx_seq"])


def _oracle(p, method, update_cd_jointly=True, fully_update_tau=False):
    i = p["init"]
    return O.online_em_fit(p["Y"], i["C"], i["d"], i["tau"], p["bin_ms"], p["idx_seq"],
                           method=method, max_em_iter=N_ITER,
                           update_cd_jointly=update_cd_jointly,
                           fully_update_tau=fully_update_tau)


def _check_shapes(t, ydim=10, xdim=2):
    assert t.C.shape == (ydim, xdim) and t.C_seq.shape == (N_ITER, ydim, xdim)
    assert t.d_seq.shape == (N_ITER, ydim) and t.tau_seq.shape == (N_ITER, xdim)
    assert t.post_loglik.shape == t.cd_cost.shape == t.cd_grad_norm.shape == (N_ITER,)
    assert t.cd_niter.shape == (N_ITER,)
    assert t.tau_cost.shape == t.tau_niter.shape == (N_ITER, xdim)
    assert t.newton_iters.shape == (N_ITER, BATCH)
    assert torch.equal(t.C, t.C_seq[-1]) and torch.equal(t.tau, t.tau_seq[-1])


def _check(t, j, hist, oracle_cost=True):
    """Port against JAX and against the oracle at the module's tolerances;
    ``oracle_cost=False`` where the oracle's cd_cost means another thing."""
    _check_shapes(t)
    pt, pj = npy(t.post_loglik), np.asarray(j.post_loglik)
    assert abs(pt[0] - pj[0]) <= PLL0_REL * abs(pj[0])
    for want in (pj, np.asarray(hist["post_loglik"])):
        np.testing.assert_allclose(pt, want, rtol=0, atol=PLL_TOL)
    for i, ph in enumerate(hist["params"]):
        for name in ("C", "d", "tau"):
            got = npy(getattr(t, name + "_seq")[i])
            np.testing.assert_allclose(got, np.asarray(getattr(j, name + "_seq")[i]),
                                       rtol=0, atol=PARAM_TOL)
            np.testing.assert_allclose(got, ph[name], rtol=0, atol=PARAM_TOL)
    np.testing.assert_allclose(npy(t.cd_cost), np.asarray(j.cd_cost), rtol=0, atol=COST_TOL)
    if oracle_cost:
        np.testing.assert_allclose(npy(t.cd_cost), np.asarray(hist["cd_cost"]), rtol=0,
                                   atol=COST_TOL)


@pytest.mark.parametrize("method", ["diag", "hess", "grad", "balancingGamma",
                                    "sequentialAverage", "fullyUpdateAll"])
def test_online_rule_joint(problem, method):
    """The six rules with the joint per-neuron (C, d) update. 'grad' runs one
    step (cd_niter 1); the mixing rules run the 8-step Newton."""
    t = _port(problem, online_update=method)
    _check(t, _jax(problem, online_update=method), _oracle(problem, method))
    if method == "grad":
        assert npy(t.cd_niter).tolist() == [1] * N_ITER


@pytest.mark.parametrize("method", ["diag", "grad", "hess"])
def test_online_c_only(problem, method):
    """Closed-form d, then C alone (the dense latent-major (xdim*ydim)^2
    prior): L-BFGS for 'diag' and 'hess', converged to cd_tol as the JAX
    package's optax run, one Newton step for 'grad'. cd_cost is the cost
    without the penalty, as in JAX; the oracle's includes it, so cd_cost is
    held to JAX only."""
    t = _port(problem, online_update=method, update_cd_jointly=False)
    j = _jax(problem, online_update=method, update_cd_jointly=False)
    _check(t, j, _oracle(problem, method, update_cd_jointly=False), oracle_cost=False)
    if method != "grad":
        assert float(t.cd_grad_norm.max()) <= FitConfig().cd_tol
        assert float(np.max(np.asarray(j.cd_grad_norm))) <= FitConfig().cd_tol


@pytest.mark.parametrize("method", ["balancingGamma", "diag"])
def test_online_fully_update_tau(problem, method):
    kw = dict(online_update=method, fully_update_tau=True)
    t = _port(problem, **kw)
    _check(t, _jax(problem, **kw), _oracle(problem, method, fully_update_tau=True))


def test_online_variational(problem):
    """Online 'diag' with the dual variational E-step, the dual-Newton solver
    named on both sides (the oracle is Laplace only): post_loglik and bound
    1e-6, parameters 2e-5, cd_cost 1e-6 against JAX."""
    kw = dict(online_update="diag", inference_method="variational", vi_solver="newton")
    t, j = _port(problem, **kw), _jax(problem, **kw)
    _check_shapes(t)
    pt, pj = npy(t.post_loglik), np.asarray(j.post_loglik)
    assert abs(pt[0] - pj[0]) <= PLL0_REL * abs(pj[0])
    np.testing.assert_allclose(pt, pj, rtol=0, atol=PLL_TOL)
    np.testing.assert_allclose(npy(t.var_lower_bound), np.asarray(j.var_lower_bound), rtol=0,
                               atol=PLL_TOL)
    for name in ("C_seq", "d_seq", "tau_seq"):
        np.testing.assert_allclose(npy(getattr(t, name)), np.asarray(getattr(j, name)), rtol=0,
                                   atol=PARAM_TOL)
    np.testing.assert_allclose(npy(t.cd_cost), np.asarray(j.cd_cost), rtol=0, atol=COST_TOL)


def test_online_drawn_stream(problem):
    """Without batch_indices the stream comes from the seed: the same seed
    draws the same stream, each row holds batch_size distinct trials, and
    injecting the drawn stream reproduces the fit exactly."""
    R = problem["Y"].shape[0]
    s = draw_batch_indices(R, BATCH, N_ITER, seed=5)
    assert torch.equal(s, draw_batch_indices(R, BATCH, N_ITER, seed=5))
    assert not torch.equal(s, draw_batch_indices(R, BATCH, N_ITER, seed=6))
    assert s.shape == (N_ITER, BATCH) and int(s.min()) >= 0 and int(s.max()) < R
    assert all(len(set(row.tolist())) == BATCH for row in s)
    cfg = FitConfig(**_config(online_update="diag"))
    p = problem
    drawn = pgpfa_torch.fit(p["init"], p["Y"], p["bin_ms"], cfg, device="cpu", seed=5)
    injected = pgpfa_torch.fit(p["init"], p["Y"], p["bin_ms"], cfg, device="cpu",
                               batch_indices=s.numpy())
    for a, b in zip(drawn, injected):
        assert (a is None and b is None) or torch.equal(a, b)  # iter_sec is None
    with pytest.raises(ValueError):
        pgpfa_torch.fit(p["init"], p["Y"], p["bin_ms"], cfg, device="cpu",
                        batch_indices=[[0, 1, R]] * N_ITER)


def test_online_f32(problem):
    """A toy f32 online 'diag' fit runs in f32 and is finite."""
    t = _port(problem, dtype=torch.float32, online_update="diag")
    _check_shapes(t)
    for x in (t.post_loglik, t.C_seq, t.d_seq, t.tau_seq, t.cd_cost):
        assert x.dtype == torch.float32 and bool(torch.isfinite(x).all())


@requires_cuda
def test_online_card_against_cpu(problem):
    """Online 'diag' on the card against the CPU: iteration 0's post_loglik
    to 1e-9 relative (the same inputs through f32 factors of the two
    devices), later ones and the parameters within the module's tolerances
    against the oracle."""
    p = problem
    cfg = FitConfig(**_config(online_update="diag"))
    runs = [pgpfa_torch.fit(p["init"], p["Y"], p["bin_ms"], cfg, device=dev,
                            batch_indices=p["idx_seq"]) for dev in ("cuda", "cpu")]
    g, c = runs
    pg, pc = npy(g.post_loglik), npy(c.post_loglik)
    assert abs(pg[0] - pc[0]) <= PLL0_REL * abs(pc[0])
    np.testing.assert_allclose(pg, pc, rtol=0, atol=PLL_TOL)
    for name in ("C_seq", "d_seq", "tau_seq"):
        np.testing.assert_allclose(npy(getattr(g, name)), npy(getattr(c, name)), rtol=0,
                                   atol=PARAM_TOL)
