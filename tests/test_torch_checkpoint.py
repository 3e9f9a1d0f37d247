"""Checkpoint and resume of the port (``pgpfa_torch.em.fit.fit_loop``,
``pgpfa_torch/utils/io.py``): the port's own resumes, and checkpoints that
pass between the port and ``pgpfa.em.fit.fit_loop`` (f64, CPU), on the
problem of ``tests/test_aux.py``.

A resume of the port's own checkpoint equals the uninterrupted fit bit for
bit. Across packages the resumed iterations are held as
``tests/test_torch_fit.py`` holds the two fits: the first iteration after
the resume sees identical inputs (post_loglik to 1e-9 relative, parameters
to 1e-7), the next within the EM chaos envelope (1e-6 absolute), tau to 1e-5
relative; the restored history is the writer's, exactly.
"""

import os

import numpy as np
import pytest
import torch

import pgpfa
from pgpfa.em.fit import FitConfig as JaxFitConfig
from pgpfa.em.fit import fit_loop as jax_fit_loop
from pgpfa.utils import io as jax_io
from pgpfa_torch import FitConfig, fit, fit_loop
from pgpfa_torch.utils import io
from torch_helpers import npy

BIN = 20.0
HIST = ("C_seq", "d_seq", "tau_seq", "post_loglik", "var_lower_bound", "cd_cost", "tau_cost",
        "cd_grad_norm", "cd_niter", "tau_niter", "newton_iters")


@pytest.fixture(scope="module")
def setup():
    train = pgpfa.dataset(xdim=2, ydim=10, numTrials=6, trialDur=400, binSize=20,
                          dOffset=0.5, fixTau=True, fixedTau=np.array([0.12, 0.3]), seed=6)
    init = pgpfa.initializeParams(2, 10, train, seed=0)
    init = {k: np.array(v, dtype=np.float64) for k, v in init.items()}
    return np.array(train.Y, dtype=np.float64), init


def _run(setup, cfg, **kw):
    Y, init = setup
    return fit_loop(init, Y, BIN, cfg, device="cpu", **kw)


def _assert_equal(a, b):
    for name in HIST + ("C", "d", "tau"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("method", ["laplace", "variational"])
def test_batch_resume_is_exact(tmp_path, setup, method):
    """A batch fit resumed from its iteration-3 checkpoint equals the
    uninterrupted 6-iteration fit, histories included (the checkpoint
    carries the warm start and the one before it, for the secant step)."""
    kw = dict(inference_method=method)
    full = _run(setup, FitConfig(max_em_iter=6, **kw))
    ck = os.path.join(tmp_path, "ck.npz")
    _run(setup, FitConfig(max_em_iter=3, **kw), checkpoint_path=ck, checkpoint_every=3)
    resumed = _run(setup, FitConfig(max_em_iter=6, **kw), resume_from=ck)
    _assert_equal(resumed, full)


@pytest.mark.parametrize("rule,joint,drawn", [
    ("diag", True, True), ("hess", True, False), ("grad", True, False), ("grad", False, True),
], ids=["diag-drawn", "hess", "grad", "grad-C-only-drawn"])
def test_online_resume_is_exact(tmp_path, setup, rule, joint, drawn):
    """An online fit resumed from its iteration-3 checkpoint equals the
    uninterrupted one: the checkpoint carries P, cumH and the seed of the
    drawn stream, which restarts at iteration 3 (``drawn``), or the caller
    passes the same ``batch_indices``."""
    Y = setup[0]
    idx = None if drawn else [np.random.default_rng(n).choice(Y.shape[0], 3, replace=False)
                              for n in range(6)]

    def cfg(n):
        return FitConfig(em_mode="online", online_update=rule, batch_size=3, max_em_iter=n,
                         update_cd_jointly=joint)

    full = _run(setup, cfg(6), seed=3, batch_indices=idx)
    ck = os.path.join(tmp_path, f"online_{rule}.npz")
    _run(setup, cfg(3), seed=3, batch_indices=idx, checkpoint_path=ck, checkpoint_every=3)
    # the stored seed, not the argument, continues the drawn stream
    resumed = _run(setup, cfg(6), seed=99, batch_indices=idx, resume_from=ck)
    _assert_equal(resumed, full)


def test_record_iter_sec(tmp_path, setup):
    """``record_iter_sec`` gives finite positive seconds per iteration
    without changing the fit; iterations restored from a checkpoint are NaN."""
    a = _run(setup, FitConfig(max_em_iter=4))
    b = _run(setup, FitConfig(max_em_iter=4), record_iter_sec=True)
    assert a.iter_sec is None
    t = b.iter_sec.numpy()
    assert t.shape == (4,) and np.all(np.isfinite(t)) and np.all(t > 0)
    _assert_equal(a, b)
    ck = os.path.join(tmp_path, "it.npz")
    _run(setup, FitConfig(max_em_iter=2), checkpoint_path=ck, checkpoint_every=2)
    r = _run(setup, FitConfig(max_em_iter=4), resume_from=ck, record_iter_sec=True)
    t = r.iter_sec.numpy()
    assert t.shape == (4,) and np.all(np.isnan(t[:2])) and np.all(np.isfinite(t[2:]))


def test_stop_after_writes_its_checkpoint(tmp_path, setup):
    """``stop_after`` ends the fit there, with the histories of the completed
    iterations and a checkpoint at the stop (not a multiple of
    ``checkpoint_every``), from which the fit finishes as the uninterrupted one."""
    ck = os.path.join(tmp_path, "stop.npz")
    part = _run(setup, FitConfig(max_em_iter=5), checkpoint_path=ck, checkpoint_every=10,
                stop_after=2)
    assert part.post_loglik.shape == (2,)
    state = io.load_checkpoint(ck)
    assert state["em_iter"] == 2 and state["rng_key"] is None
    assert state["extra"]["hist_pll"].shape == (2,)
    full = _run(setup, FitConfig(max_em_iter=5))
    _assert_equal(_run(setup, FitConfig(max_em_iter=5), resume_from=ck), full)
    assert torch.equal(part.post_loglik, full.post_loglik[:2])


def test_resume_without_warm_prev(tmp_path, setup):
    """An older checkpoint without ``warm_prev`` resumes with a plain warm
    start for its first iteration: its E-step converges from another start,
    so that iteration lands within 1e-9 relative of the uninterrupted fit and
    the later ones within the EM chaos envelope (1e-6)."""
    ck = os.path.join(tmp_path, "old.npz")
    _run(setup, FitConfig(max_em_iter=3), checkpoint_path=ck, checkpoint_every=3)
    state = io.load_checkpoint(ck)
    extra = {k: v for k, v in state["extra"].items() if k != "warm_prev"}
    io.save_checkpoint(ck, state["params"], state["em_iter"], warm=state["warm"], extra=extra)
    full = _run(setup, FitConfig(max_em_iter=5))
    r = _run(setup, FitConfig(max_em_iter=5), resume_from=ck)
    pr, pf = npy(r.post_loglik), npy(full.post_loglik)
    np.testing.assert_array_equal(pr[:3], pf[:3])
    assert abs(pr[3] - pf[3]) <= 1e-9 * abs(pf[3])
    assert np.all(np.abs(pr - pf) <= 1e-6)
    np.testing.assert_allclose(npy(r.tau), npy(full.tau), rtol=1e-5)


def _hold_to_jax(resumed, j, start):
    """The restored iterations exactly; the first resumed one to 1e-9
    relative (post_loglik) and 1e-7 (parameters); the rest within 1e-6; tau
    to 1e-5 relative."""
    pj = np.asarray(j.post_loglik)
    pt = npy(resumed.post_loglik)
    np.testing.assert_array_equal(pt[:start], pj[:start])
    np.testing.assert_array_equal(npy(resumed.C_seq[:start]), np.asarray(j.C_seq[:start]))
    assert abs(pt[start] - pj[start]) <= 1e-9 * abs(pj[start])
    for name in ("C_seq", "d_seq", "tau_seq"):
        np.testing.assert_allclose(npy(getattr(resumed, name)[start]),
                                   np.asarray(getattr(j, name)[start]), rtol=0, atol=1e-7)
    assert np.all(np.abs(pt[start + 1:] - pj[start + 1:]) <= 1e-6)
    np.testing.assert_allclose(npy(resumed.tau), np.asarray(j.tau), rtol=1e-5)


@pytest.fixture(scope="module")
def jax_batch(setup, tmp_path_factory):
    """The JAX package's uninterrupted 4-iteration batch Laplace fit and its
    checkpoint at iteration 2."""
    Y, init = setup
    ck = str(tmp_path_factory.mktemp("jax") / "batch.npz")
    jax_fit_loop(init, Y, BIN, JaxFitConfig(max_em_iter=2), checkpoint_path=ck,
                 checkpoint_every=2)
    return jax_fit_loop(init, Y, BIN, JaxFitConfig(max_em_iter=4)), ck


def test_jax_batch_checkpoint_resumes_in_port(setup, jax_batch):
    """A checkpoint of ``pgpfa.em.fit.fit_loop`` at iteration 2 of 4,
    resumed by the port, lands on the JAX package's uninterrupted fit."""
    j, ck = jax_batch
    resumed = _run(setup, FitConfig(max_em_iter=4), resume_from=ck)
    assert resumed.post_loglik.shape == (4,) and resumed.newton_iters.dtype == torch.int32
    _hold_to_jax(resumed, j, 2)


def test_port_batch_checkpoint_resumes_in_jax(tmp_path, setup, jax_batch):
    """The other way: the port's iteration-2 checkpoint (its own history,
    warm starts and seed key) loads in the JAX package, whose resumed fit
    lands on its uninterrupted one."""
    Y, init = setup
    j, _ = jax_batch
    ck = os.path.join(tmp_path, "port.npz")
    port = _run(setup, FitConfig(max_em_iter=2), checkpoint_path=ck, checkpoint_every=2)
    state = jax_io.load_checkpoint(ck)
    assert state["em_iter"] == 2 and state["rng_key"] is None
    np.testing.assert_array_equal(state["extra"]["hist_pll"], npy(port.post_loglik))
    resumed = jax_fit_loop(init, Y, BIN, JaxFitConfig(max_em_iter=4), resume_from=ck)
    pj, pr = np.asarray(j.post_loglik), np.asarray(resumed.post_loglik)
    np.testing.assert_array_equal(pr[:2], npy(port.post_loglik))
    assert np.all(np.abs(pr - pj) <= 1e-6)
    np.testing.assert_allclose(np.asarray(resumed.tau), np.asarray(j.tau), rtol=1e-5)


def test_jax_online_checkpoint_needs_batch_indices(tmp_path, setup):
    """A JAX online checkpoint carries a ``jax.random`` key: without
    ``batch_indices`` the port refuses it; with them it resumes onto the
    JAX package's uninterrupted fit on the same stream."""
    Y, init = setup
    idx = [np.random.default_rng(10 + n).choice(Y.shape[0], 3, replace=False) for n in range(4)]

    def cfg(cls, n):
        return cls(em_mode="online", online_update="diag", batch_size=3, max_em_iter=n)

    ck = os.path.join(tmp_path, "jax_online.npz")
    jax_fit_loop(init, Y, BIN, cfg(JaxFitConfig, 2), batch_indices=idx, checkpoint_path=ck,
                 checkpoint_every=2)
    assert jax_io.load_checkpoint(ck)["rng_key"] is not None
    with pytest.raises(ValueError, match="jax.random"):
        _run(setup, cfg(FitConfig, 4), resume_from=ck)
    j = jax_fit_loop(init, Y, BIN, cfg(JaxFitConfig, 4), batch_indices=idx)
    _hold_to_jax(_run(setup, cfg(FitConfig, 4), resume_from=ck, batch_indices=idx), j, 2)


def test_io_twin(tmp_path):
    """``save_checkpoint`` writes the JAX package's keys (each reads the
    other's file), atomically (no temporary file left), with or without the
    ``.npz`` suffix; ``save_variables`` round-trips."""
    params = {"C": np.arange(6.0).reshape(3, 2), "d": np.ones(3), "tau": np.array([0.1, 0.2])}
    base = os.path.join(tmp_path, "a")
    io.save_checkpoint(base, params, 4, warm=np.zeros((2, 2, 5)), extra={"P": np.eye(3)})
    assert sorted(os.listdir(tmp_path)) == ["a.npz"]
    for load in (io.load_checkpoint, jax_io.load_checkpoint):
        s = load(base + ".npz")
        assert s["em_iter"] == 4 and s["rng_key"] is None and s["warm"].shape == (2, 2, 5)
        np.testing.assert_array_equal(s["params"]["C"], params["C"])
        np.testing.assert_array_equal(s["extra"]["P"], np.eye(3))
    jax_io.save_checkpoint(base, params, 5, rng_key=np.array([0, 7], dtype=np.uint32))
    s = io.load_checkpoint(base + ".npz")
    assert s["em_iter"] == 5 and s["warm"] is None and s["extra"] == {}
    np.testing.assert_array_equal(s["rng_key"], [0, 7])
    obj = {"a": [1, 2], "b": np.arange(3)}
    io.save_variables(obj, os.path.join(tmp_path, "v.pkl"))
    back = io.open_variables(os.path.join(tmp_path, "v.pkl"))
    assert back["a"] == [1, 2] and np.array_equal(back["b"], obj["b"])


def test_fit_is_fit_loop(setup):
    """``fit`` is ``fit_loop`` without checkpoints: the same result."""
    Y, init = setup
    _assert_equal(fit(init, Y, BIN, FitConfig(max_em_iter=2), device="cpu"),
                  _run(setup, FitConfig(max_em_iter=2)))
