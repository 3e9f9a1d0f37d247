"""Elliptical-slice MCMC of the port (``pgpfa_torch/infer/mcmc.py``) against
``pgpfa/infer/mcmc.py`` (f64, CPU) on ``tests/test_components.py``'s
``small`` problem.

``jax.random`` key trees cannot be replayed in torch, so the port is handed
JAX's own draws: :class:`JaxDraws` splits the keys as ``pgpfa/infer/mcmc.py``
does and serves the normals and uniforms in the order the port's transitions
ask for them. Both sides record every log-likelihood they evaluate, the JAX
side through ``jax.debug.callback``; the accept decisions are those values
against the slice level, and must be identical, evaluation by evaluation.
Samples agree to 1e-10 and log-likelihoods to 1e-11 relative: the two
packages reduce the likelihood in different orders (~1 ULP), the class
``tests/test_components.py`` accepts for JAX's own speculative step.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pgpfa
from pgpfa.infer import mcmc as JM
from pgpfa.models.params import rbf_kernel as jax_rbf_kernel
from pgpfa_torch.infer import mcmc as TM
from pgpfa_torch.infer.laplace import laplace_estep_from_arrays
from pgpfa_torch.models.params import rbf_kernel
from pgpfa_torch.ops.blockmat import chol32
from torch_helpers import npy, requires_cuda, t64

SAMPLE_TOL, LL_REL = 1e-10, 1e-11
N_CHAIN = 150  # chained transitions per transition test
# The fixed transition evaluates 42 candidates per lane, and each JAX
# evaluation costs one host callback (~0.3 ms): 50 transitions of 3 lanes
# compare 6300 decisions.
N_FIXED = 50
BIN = 20.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The chains run thousands of tiny ops, which a second CPU thread only
    slows down (~10x measured with two); restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    """``tests/test_components.py``'s problem: xdim 2, ydim 12, 8 trials of
    600 ms at 20 ms bins (T 30), seed 7; the true parameters; JAX's prior
    factor, handed to both packages where a test compares them."""
    train = pgpfa.dataset(xdim=2, ydim=12, numTrials=8, trialDur=600, binSize=20,
                          dOffset=0.5, fixTau=True, fixedTau=np.array([0.15, 0.3]), seed=7)
    C, d, tau = (np.array(train.params[k], dtype=np.float64).reshape(np.shape(train.params[k]))
                 for k in ("C", "d", "tau"))
    d, tau = d.ravel(), tau.ravel()
    Y = np.asarray(train.Y, dtype=np.float64)
    K = jax_rbf_kernel(jnp.asarray(tau), train.T, BIN, 1e-3)
    chol = np.asarray(JM._prior_chol(K, jnp.float64))
    return dict(C=C, d=d, tau=tau, Y=Y, T=train.T, chol=chol)


# ---------------------------------------------------------------------------
# JAX's draws for the port, and the recorders


@functools.partial(jax.jit, static_argnames="shape")
def _transition_draws(key, shape):
    """``split(key, 4)`` and the draws made from the first three keys, as
    each transition of ``pgpfa/infer/mcmc.py`` makes them; ``shape`` is the
    state's, and the uniforms take its leading (lane) axes."""
    k_nu, k_h, k_phi, k_loop = jax.random.split(key, 4)
    lanes = shape[:-2]
    return (jax.random.normal(k_nu, shape, dtype=jnp.float64),
            jax.random.uniform(k_h, lanes, dtype=jnp.float64),
            jax.random.uniform(k_phi, lanes, dtype=jnp.float64), k_loop)


# the fixed transition: one key per chain, each chain's draws per key
_fixed_draws = jax.jit(jax.vmap(_transition_draws, in_axes=(0, None)), static_argnames="shape")


@functools.partial(jax.jit, static_argnames=("n", "lanes"))
def _successive(k_loop, n, lanes):
    """``n`` shrink uniforms of the rejection loop, each from
    ``k_loop, sub = split(k_loop)``; returns them and the last ``k_loop``."""

    def draw(k, _):
        k, sub = jax.random.split(k)
        return k, jax.random.uniform(sub, lanes, dtype=jnp.float64)

    k_loop, us = jax.lax.scan(draw, k_loop, None, length=n)
    return us, k_loop


@jax.jit
def _fanout(k_loops):
    """Per chain, ``split(k_loop, 40)`` and one uniform per key (the fixed
    transition), as ``(40, R)``."""
    return jax.vmap(lambda kl: jax.vmap(lambda k: jax.random.uniform(k, dtype=jnp.float64))(
        jax.random.split(kl, 40)), out_axes=1)(k_loops)


class JaxDraws:
    """Serves ``pgpfa/infer/mcmc.py``'s draws in the port's order (module
    docstring of ``pgpfa_torch/infer/mcmc.py``), f64.

    ``mode='chain'``: one key per transition, scalar lanes; each shrink
    uniform comes from ``k_loop, sub = split(k_loop)``. ``'batched'``: the
    same with ``(R,)`` draws from one key. ``'fixed'``: ``keys (R, n)``, one
    key per chain and transition, the shrinks from ``split(k_loop, 40)``.
    ``u_h`` keeps each transition's slice uniform.
    """

    def __init__(self, keys, mode):
        self.keys, self.mode, self.i = keys, mode, 0
        self.u_h = []

    def normal(self, shape, dtype, device):
        assert dtype == torch.float64
        if self.mode == "fixed":
            drawn = _fixed_draws(self.keys[:, self.i], tuple(shape[1:]))
        else:
            drawn = _transition_draws(self.keys[self.i], tuple(shape))
        z, *self.first, self.k_loop = drawn
        self.u_h.append(np.asarray(self.first[0]))
        self.i += 1
        return t64(z).to(device)

    def uniform(self, shape, dtype, device):
        assert dtype == torch.float64
        if self.first:  # the slice level, then the initial angle
            u = self.first.pop(0)
        elif self.mode == "fixed":
            u = _fanout(self.k_loop)
        elif self.mode == "batched":
            u, self.k_loop = _successive(self.k_loop, 1, tuple(shape))
        else:  # shape () or (n,): that many successive shrink draws
            u, self.k_loop = _successive(self.k_loop, math.prod(shape), ())
        return t64(u).reshape(shape).to(device)


def jax_log_lik(C, d, Y, rec):
    """The JAX package's per-chain likelihood, recording each value."""
    C, d, Y = jnp.asarray(C), jnp.asarray(d), jnp.asarray(Y)

    def f(X):
        A = C @ X + d[:, None]
        ll = jnp.vdot(Y, A) - jnp.sum(jnp.exp(A))
        jax.debug.callback(lambda v: rec.append(np.asarray(v)), ll, ordered=True)
        return ll

    return f


def jax_log_lik_batch(C, d, Y, rec):
    """The batched likelihood of ``posterior_mcmc_batched``, recording."""
    C, d, Yf = jnp.asarray(C), jnp.asarray(d), jnp.asarray(Y)

    def f(X):
        A = jnp.einsum("nk,rkt->rnt", C, X) + d[None, :, None]
        ll = jnp.einsum("rnt,rnt->r", Yf, A) - jnp.sum(jnp.exp(A), axis=(1, 2))
        jax.debug.callback(lambda v: rec.append(np.asarray(v)), ll, ordered=True)
        return ll

    return f


def port_log_lik(C, d, Y, rec):
    f = TM.poisson_log_lik(t64(C), t64(d), t64(Y))

    def g(X):
        ll = f(X)
        rec.append(npy(ll).copy())
        return ll

    return g


def _decisions(rec, log_y):
    """Each evaluated candidate against the slice level, in order."""
    vals = np.concatenate([np.reshape(v, (-1,) + np.shape(log_y)) for v in rec])
    return vals > log_y


# ---------------------------------------------------------------------------
# the transitions


@pytest.mark.parametrize("kind", ["sequential", "spec2", "spec8"])
def test_chain_transition_matches_jax(small, kind):
    """The sequential and speculative transitions (``n_spec`` 2 and 8), 150
    chained transitions of trial 0 on JAX's draws and factor: the same
    decision for every evaluated candidate (so the same shrinks per
    transition), states to 1e-10, log-likelihoods to 1e-11 relative."""
    p = small
    n_spec = {"sequential": 1, "spec2": 2, "spec8": 8}[kind]
    rec_j, rec_t = [], []
    llj = jax_log_lik(p["C"], p["d"], p["Y"][0], rec_j)
    llt = port_log_lik(p["C"], p["d"], p["Y"][0], rec_t)
    cj, ct = jnp.asarray(p["chol"]), t64(p["chol"])
    if n_spec == 1:
        jstep = jax.jit(lambda k, x, ll: JM.elliptical_slice_step(k, x, llj, cj, ll_cur=ll))
    else:
        jstep = jax.jit(lambda k, x, ll: JM.elliptical_slice_step_spec(k, x, llj, cj, ll,
                                                                       n_spec=n_spec))
    keys = jax.random.split(jax.random.PRNGKey(3), N_CHAIN)
    draws = JaxDraws(keys, "chain")
    xj = jnp.zeros((2, p["T"]))
    llj0 = jnp.asarray(float(npy(llt(torch.zeros(2, p["T"], dtype=torch.float64)))))
    xt, llt0 = torch.zeros(2, p["T"], dtype=torch.float64), t64(llj0)
    rec_t.clear()
    shrinks = []
    for i in range(N_CHAIN):
        rec_j.clear(), rec_t.clear()
        ll_prev = float(llj0)
        xj, llj0 = jstep(keys[i], xj, llj0)
        jax.effects_barrier()
        if n_spec == 1:
            xt, llt0 = TM.elliptical_slice_step(draws, xt, llt, ct, ll_cur=llt0)
        else:
            xt, llt0 = TM.elliptical_slice_step_spec(draws, xt, llt, ct, llt0, n_spec=n_spec)
        log_y = ll_prev + np.log(draws.u_h[-1])
        dj, dt = _decisions(rec_j, log_y), _decisions(rec_t, log_y)
        assert np.array_equal(dj, dt), (i, dj, dt)
        shrinks.append(len(dt))
        assert np.max(np.abs(npy(xt) - np.asarray(xj))) <= SAMPLE_TOL, i
        assert abs(float(llt0) - float(llj0)) <= LL_REL * abs(float(llj0)), i
    # the chain took more than one candidate somewhere, and (n_spec 2) more
    # than one round, so the shrink and continuation paths were compared
    assert max(shrinks) > n_spec


def test_fixed_transition_matches_jax(small):
    """The fixed (branchless) transition over 3 chains (trials 0-2), 50
    chained transitions on JAX's per-chain draws: every lane's first
    accepted candidate of its 41, states and log-likelihoods."""
    p = small
    R = 3
    rec_j, rec_t = [], []
    cj, ct = jnp.asarray(p["chol"]), t64(p["chol"])

    def lane(k, x, Y):  # one chain, vmapped over the three as the JAX driver does
        return JM.elliptical_slice_step_fixed(k, x, jax_log_lik(p["C"], p["d"], Y, rec_j), cj)

    jstep = jax.jit(jax.vmap(lane))
    llt = port_log_lik(p["C"], p["d"], p["Y"][:R], rec_t)
    keys = jnp.stack([jax.random.split(k, N_FIXED)
                      for k in jax.random.split(jax.random.PRNGKey(5), R)])
    draws = JaxDraws(keys, "fixed")
    Yj = jnp.asarray(p["Y"][:R])
    xj = jnp.zeros((R, 2, p["T"]))
    xt = torch.zeros(R, 2, p["T"], dtype=torch.float64)
    first = []
    for i in range(N_FIXED):
        rec_j.clear(), rec_t.clear()
        xj, llj0 = jstep(keys[:, i], xj, Yj)
        jax.effects_barrier()
        xt, llt0 = TM.elliptical_slice_step_fixed(draws, xt, llt, ct)
        # JAX's callbacks come lane by lane for each evaluation
        vj = np.reshape(np.asarray(rec_j), (-1, R))
        vt = np.concatenate([np.reshape(v, (-1, R)) for v in rec_t])
        assert vj.shape == vt.shape == (42, R)
        log_y = vj[0] + np.log(draws.u_h[-1])
        dj, dt = vj[1:] > log_y, vt[1:] > log_y
        assert np.array_equal(dj.argmax(0), dt.argmax(0)) and np.array_equal(dj.any(0), dt.any(0))
        first.append(dt.argmax(0))
        assert np.max(np.abs(npy(xt) - np.asarray(xj))) <= SAMPLE_TOL, i
        np.testing.assert_allclose(npy(llt0), np.asarray(llj0), rtol=LL_REL, atol=0)
    assert np.max(first) > 0


def test_batched_transition_matches_jax(small):
    """The adaptive batched transition over 3 chains, 150 chained
    transitions on JAX's draws: each lane's decision at every shrink (so the
    same shrinks), states and log-likelihoods."""
    p = small
    R = 3
    rec_j, rec_t = [], []
    llj = jax_log_lik_batch(p["C"], p["d"], p["Y"][:R], rec_j)
    llt = port_log_lik(p["C"], p["d"], p["Y"][:R], rec_t)
    cj, ct = jnp.asarray(p["chol"]), t64(p["chol"])
    jstep = jax.jit(lambda k, x, ll: JM.elliptical_slice_step_batched(k, x, llj, cj, ll))
    keys = jax.random.split(jax.random.PRNGKey(11), N_CHAIN)
    draws = JaxDraws(keys, "batched")
    xt = torch.zeros(R, 2, p["T"], dtype=torch.float64)
    llt0 = llt(xt)
    xj, llj0 = jnp.zeros((R, 2, p["T"])), jnp.asarray(npy(llt0))
    shrinks = []
    for i in range(N_CHAIN):
        rec_j.clear(), rec_t.clear()
        ll_prev = np.asarray(llj0)
        xj, llj0 = jstep(keys[i], xj, llj0)
        jax.effects_barrier()
        xt, llt0 = TM.elliptical_slice_step_batched(draws, xt, llt, ct, llt0)
        log_y = ll_prev + np.log(draws.u_h[-1])
        dj, dt = _decisions(rec_j, log_y), _decisions(rec_t, log_y)
        assert np.array_equal(dj, dt), i
        shrinks.append(len(dt))
        assert np.max(np.abs(npy(xt) - np.asarray(xj))) <= SAMPLE_TOL, i
        np.testing.assert_allclose(npy(llt0), np.asarray(llj0), rtol=LL_REL, atol=0)
    assert max(shrinks) > 2


# ---------------------------------------------------------------------------
# exhaustion: a likelihood below every slice level


def _never(X):
    """A likelihood no candidate passes: -inf for every state but zeros."""
    flat = X.reshape(X.shape[:-2] + (-1,))
    return torch.where((flat == 0).all(-1), 0.0, -math.inf).to(X.dtype)


@pytest.mark.parametrize("kind", ["sequential", "spec", "fixed", "batched"])
def test_exhaustion_keeps_the_current_state(small, kind):
    """Where no candidate reaches the slice level within the cap, every
    transition returns the current state and its log-likelihood (the JAX
    package returns a rejected candidate there). The state is not zero, so
    every candidate scores -inf against a finite slice level."""
    ct = t64(small["chol"])
    draws = TM.SeededDraws(0, "cpu")
    x = torch.ones(2, small["T"], dtype=torch.float64)
    ll = torch.tensor(-5.0, dtype=torch.float64)
    if kind == "sequential":
        out, l = TM.elliptical_slice_step(draws, x, _never, ct, ll_cur=ll)
    elif kind == "spec":
        out, l = TM.elliptical_slice_step_spec(draws, x, _never, ct, ll, n_spec=4, max_rounds=8)
    elif kind == "fixed":
        x = x.expand(3, -1, -1)
        fin = lambda X: torch.where(X.reshape(X.shape[:-2] + (-1,)).eq(1).all(-1), -5.0,  # noqa: E731
                                    -math.inf).to(X.dtype)
        out, l = TM.elliptical_slice_step_fixed(draws, x, fin, ct)
        ll = torch.full((3,), -5.0, dtype=torch.float64)
    else:
        x = x.expand(3, -1, -1)
        ll = torch.full((3,), -5.0, dtype=torch.float64)
        out, l = TM.elliptical_slice_step_batched(draws, x, _never, ct, ll, max_shrink=20)
    assert torch.equal(out, x) and torch.equal(l, ll)


def test_replayed_draws(small):
    """``SeededDraws(keep=True)`` keeps every draw; ``ReplayDraws`` serves
    them again, so a replayed chain repeats the recorded one exactly, and a
    request the recorded run did not make raises."""
    p = small
    args = [t64(a) for a in (p["C"], p["d"], t64(p["chol"]), p["Y"][:3])]
    rec = TM.SeededDraws(4, "cpu", keep=True)
    a = TM._batched_chains(*args, 25, rec)
    replay = TM.ReplayDraws(rec.kept)
    b = TM._batched_chains(*args, 25, replay)
    assert replay.used == len(rec.kept) and torch.equal(a.samples, b.samples)
    with pytest.raises(ValueError):
        TM._batched_chains(*args[:3], args[3][:2], 25, TM.ReplayDraws(rec.kept))


def test_exhaustion_counts_the_caps(small):
    """The loops stop at the JAX package's caps: 1000 shrinks (sequential),
    ``max_rounds`` rounds (speculative), ``max_shrink`` (batched), 40 fixed
    shrinks, counted in draws asked for."""

    class Counting(TM.SeededDraws):
        def __init__(self):
            super().__init__(0, "cpu")
            self.n = 0

        def uniform(self, shape, dtype, device):
            self.n += math.prod(shape) if shape else 1
            return super().uniform(shape, dtype, device)

    ct = t64(small["chol"])
    x = torch.ones(2, small["T"], dtype=torch.float64)
    ll = torch.tensor(-5.0, dtype=torch.float64)
    for run, want in [
        (lambda dr: TM.elliptical_slice_step(dr, x, _never, ct, ll_cur=ll), 2 + 1000),
        (lambda dr: TM.elliptical_slice_step_spec(dr, x, _never, ct, ll, n_spec=8), 2 + 8 * 128 - 1),
        (lambda dr: TM.elliptical_slice_step_fixed(dr, x, _never, ct), 2 + 40),
        (lambda dr: TM.elliptical_slice_step_batched(dr, x[None], _never, ct, ll[None],
                                                     max_shrink=30), 2 + 30),
    ]:
        dr = Counting()
        run(dr)
        assert dr.n == want


# ---------------------------------------------------------------------------
# the prior factor


def test_prior_chol_against_jax(small):
    """``_prior_chol`` on the problem's kernel, f64 and f32. The port's and
    JAX's f32 CPU factors are NOT bit-equal (two LAPACK factorizations round
    differently: max |dL| 2.2e-5 in f64 and 2.4e-5 in f32 of entries <= 1,
    measured): both are held to 1e-4, and each to its backward error
    ``max |L L^T - K| <= 1e-5``. The drivers' tests below therefore hand both
    packages JAX's factor."""
    p = small
    for dtype, jdt in ((torch.float64, jnp.float64), (torch.float32, jnp.float32)):
        Kj = jax_rbf_kernel(jnp.asarray(p["tau"], dtype=jdt), p["T"], BIN, 1e-3)
        K = rbf_kernel(torch.tensor(p["tau"], dtype=dtype), p["T"], BIN, 1e-3)
        L = TM._prior_chol(K, dtype)
        Lj = np.asarray(JM._prior_chol(Kj, jdt))
        assert L.dtype == dtype and bool(torch.isfinite(L).all())
        assert np.max(np.abs(npy(L) - Lj)) <= 1e-4
        rec = (L.double() @ L.double().transpose(1, 2) - K.double()).abs().max()
        assert float(rec) <= 1e-5


def test_prior_chol_guard_on_ill_conditioned_kernel():
    """The kernel of ``test_mcmc_prior_chol_guard_on_ill_conditioned_kernel``
    (T 400, tau 5 s, eps 1e-6): the raw f32 factor fails on both packages,
    the guarded one is finite and reproduces K to 1e-4 relative, as JAX's;
    both take the jitter retry (the f64 fallback would reproduce K to
    ~1e-16), and their factors differ by the f32 rounding of that retry."""
    K = rbf_kernel(torch.tensor([5.0], dtype=torch.float64), 400, 10.0, 1e-6)
    Kj = jax_rbf_kernel(jnp.asarray([5.0]), 400, 10.0, 1e-6)
    assert not bool(torch.isfinite(chol32(K)).all())
    L = TM._prior_chol(K, torch.float64)
    Lj = np.asarray(JM._prior_chol(Kj, jnp.float64))
    assert bool(torch.isfinite(L).all())
    err = float((L @ L.transpose(1, 2) - K).abs().max() / K.abs().max())
    errj = float(np.max(np.abs(Lj @ np.swapaxes(Lj, 1, 2) - np.asarray(Kj))) / np.max(np.asarray(Kj)))
    assert err < 1e-4 and errj < 1e-4
    assert err > 1e-9 and errj > 1e-9  # the retry's bump, not the exact f64 factor


def test_prior_chol_falls_back_to_f64(monkeypatch):
    """When the retry fails too, the factor is the f64 Cholesky."""
    monkeypatch.setattr(TM, "chol32", lambda K: torch.full_like(K, math.nan, dtype=torch.float32))
    K = rbf_kernel(torch.tensor([0.2, 0.3], dtype=torch.float64), 20, BIN)
    L = TM._prior_chol(K, torch.float64)
    assert torch.equal(L, torch.linalg.cholesky(K))


# ---------------------------------------------------------------------------
# the drivers


@pytest.fixture()
def jax_factor(small, monkeypatch):
    """Both packages' drivers on JAX's f32 factor (see test_prior_chol_against_jax)."""
    monkeypatch.setattr(TM, "_prior_chol", lambda K, dtype: t64(small["chol"]).to(dtype))


N_DRIVER = 40


@pytest.mark.parametrize("n_spec", [1, 8])
def test_single_chain_driver_matches_jax(small, jax_factor, n_spec):
    """``posterior_mcmc_from_arrays`` on JAX's stream (seed 2) and factor,
    trial 1: every sample to 1e-10, log-likelihoods to 1e-11 relative."""
    p = small
    j = JM.posterior_mcmc_from_arrays(jnp.asarray(p["C"]), jnp.asarray(p["d"]),
                                      jnp.asarray(p["tau"]), jnp.asarray(p["Y"][1]), p["T"],
                                      BIN, n_samples=N_DRIVER, seed=2, n_spec=n_spec)
    keys = jax.random.split(jax.random.PRNGKey(2), N_DRIVER)
    t = TM.posterior_mcmc_from_arrays(p["C"], p["d"], p["tau"], p["Y"][1], p["T"], BIN,
                                      n_samples=N_DRIVER, n_spec=n_spec,
                                      draws=JaxDraws(keys, "chain"), device="cpu")
    assert t.samples.shape == (N_DRIVER, 2, p["T"]) and t.samples.dtype == torch.float64
    assert np.max(np.abs(npy(t.samples) - np.asarray(j.samples))) <= SAMPLE_TOL
    np.testing.assert_allclose(npy(t.log_lik), np.asarray(j.log_lik), rtol=LL_REL, atol=0)


@pytest.mark.parametrize("shrink", ["adaptive", "fixed"])
def test_batched_driver_matches_jax(small, jax_factor, shrink):
    """``posterior_mcmc_batched`` over trials 0-3 on JAX's stream (seed 4)
    and factor: every sample to 1e-10, log-likelihoods to 1e-11 relative."""
    p = small
    R = 4
    j = JM.posterior_mcmc_batched(jnp.asarray(p["C"]), jnp.asarray(p["d"]),
                                  jnp.asarray(p["tau"]), jnp.asarray(p["Y"][:R]), p["T"], BIN,
                                  n_samples=N_DRIVER, seed=4, shrink=shrink)
    if shrink == "adaptive":
        draws = JaxDraws(jax.random.split(jax.random.PRNGKey(4), N_DRIVER), "batched")
    else:
        draws = JaxDraws(jnp.stack([jax.random.split(k, N_DRIVER)
                                    for k in jax.random.split(jax.random.PRNGKey(4), R)]), "fixed")
    t = TM.posterior_mcmc_batched(p["C"], p["d"], p["tau"], p["Y"][:R], p["T"], BIN,
                                  n_samples=N_DRIVER, shrink=shrink, draws=draws, device="cpu")
    assert t.samples.shape == (R, N_DRIVER, 2, p["T"])
    assert np.max(np.abs(npy(t.samples) - np.asarray(j.samples))) <= SAMPLE_TOL
    np.testing.assert_allclose(npy(t.log_lik), np.asarray(j.log_lik), rtol=LL_REL, atol=0)


def test_posterior_mcmc_takes_params_and_devices(small):
    """``posterior_mcmc`` with a CPU ``Params`` runs on the CPU in its dtype;
    arrays without a device go to the card, which without one raises."""
    from pgpfa_torch import params_from_numpy

    p = small
    prm = params_from_numpy({k: p[k] for k in ("C", "d", "tau")}, "cpu", torch.float32)
    r = TM.posterior_mcmc(prm, p["Y"][0], p["T"], BIN, n_samples=5, seed=0)
    assert r.samples.device.type == "cpu" and r.samples.dtype == torch.float32
    assert r.samples.shape == (5, 2, p["T"]) and bool(torch.isfinite(r.log_lik).all())
    a = TM.posterior_mcmc_from_arrays(p["C"], p["d"], p["tau"], p["Y"][0], p["T"], BIN,
                                      n_samples=5, seed=3, device="cpu")
    b = TM.posterior_mcmc_from_arrays(p["C"], p["d"], p["tau"], p["Y"][0], p["T"], BIN,
                                      n_samples=5, seed=3, device="cpu")
    assert torch.equal(a.samples, b.samples)
    with pytest.raises(ValueError):
        TM.posterior_mcmc_batched(p["C"], p["d"], p["tau"], p["Y"][:2], p["T"], BIN,
                                  n_samples=2, shrink="lockstep", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            TM.posterior_mcmc_from_arrays(p["C"], p["d"], p["tau"], p["Y"][0], p["T"], BIN,
                                          n_samples=2)


# ---------------------------------------------------------------------------
# the port's own chains against the Laplace moments


def _laplace(p, trials):
    inf, _ = laplace_estep_from_arrays(t64(p["C"]), t64(p["d"]), t64(p["tau"]),
                                       t64(p["Y"][trials]), p["T"], BIN)
    sd = np.sqrt(np.diagonal(npy(inf.post_vsm_gp), axis1=2, axis2=3))
    return npy(inf.post_mean), sd


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_single_chain_agrees_with_laplace(small, dtype):
    """``test_mcmc_agrees_with_laplace`` and its f32 twin on the port's
    chain (seeded draws; 4000 samples, 1000 burn-in): mean |z| < 0.5, mean
    sd ratio in (0.65, 1.35)."""
    p = small
    mean, sd = _laplace(p, [0])
    cast = lambda a: np.asarray(a, dtype=np.float32 if dtype == torch.float32 else np.float64)  # noqa: E731
    r = TM.posterior_mcmc_from_arrays(cast(p["C"]), cast(p["d"]), cast(p["tau"]), p["Y"][0],
                                      p["T"], BIN, n_samples=4000, seed=1, device="cpu")
    assert r.samples.dtype == dtype
    s = npy(r.samples)[1000:].astype(np.float64)
    z = np.abs(s.mean(0) - mean[0]) / sd[0]
    assert np.mean(z) < 0.5, np.mean(z)
    ratio = s.std(0) / sd[0]
    assert 0.65 < np.mean(ratio) < 1.35, np.mean(ratio)


@pytest.mark.parametrize("shrink", ["adaptive", "fixed"])
def test_batched_chains_agree_with_laplace(small, shrink):
    """``test_mcmc_batched_agrees_with_laplace`` on the port's chains for
    trials 0 and 1: max |z| < 0.5 and each sd within 35%, on the JAX test's
    3000 samples per trial after burn-in, pooled from independent chains to
    keep the file's time: two chains per trial of 2000 samples, 500 burn-in
    each (adaptive), or six of 600, 100 burn-in each (fixed: 41 likelihood
    evaluations per sample)."""
    p = small
    mean, sd = _laplace(p, [0, 1])
    per, n, burn = (2, 2000, 500) if shrink == "adaptive" else (6, 600, 100)
    rows = np.repeat([0, 1], per)
    r = TM.posterior_mcmc_batched(p["C"], p["d"], p["tau"], p["Y"][rows], p["T"], BIN,
                                  n_samples=n, seed=1, shrink=shrink, device="cpu")
    assert r.samples.shape[:2] == (2 * per, n)
    s = npy(r.samples)[:, burn:]
    for trial in range(2):
        pooled = s[rows == trial].reshape((-1,) + s.shape[2:])
        assert np.max(np.abs(pooled.mean(0) - mean[trial]) / sd[trial]) < 0.5
        np.testing.assert_allclose(pooled.std(0), sd[trial], rtol=0.35)


# ---------------------------------------------------------------------------
# the card


@requires_cuda
@pytest.mark.parametrize("kind", ["adaptive", "fixed", "spec8", "sequential"])
def test_drivers_on_the_card_match_the_cpu(small, kind):
    """Each driver on the card against the CPU on the card's draws and
    factor: the same samples to 1e-9 (exp and reductions round differently
    on the two devices; decisions must not differ)."""
    p = small
    K = rbf_kernel(t64(p["tau"]).cuda(), p["T"], BIN)
    chol = TM._prior_chol(K, torch.float64)
    args = [t64(a) for a in (p["C"], p["d"])]
    rec = TM.SeededDraws(9, "cuda", keep=True)
    replay = TM.ReplayDraws(rec.kept)
    if kind in ("adaptive", "fixed"):
        Y = t64(p["Y"][:4])
        g = TM._batched_chains(*(a.cuda() for a in args), chol, Y.cuda(), 30, rec, kind)
        c = TM._batched_chains(*args, chol.cpu(), Y, 30, replay, kind)
    else:
        Y = t64(p["Y"][0])
        n_spec = 8 if kind == "spec8" else 1
        g = TM._single_chain(*(a.cuda() for a in args), chol, Y.cuda(), 30, rec, n_spec)
        c = TM._single_chain(*args, chol.cpu(), Y, 30, replay, n_spec)
    assert replay.used == len(rec.kept)  # the same decisions: every draw, in order
    assert float((g.samples.cpu() - c.samples).abs().max()) <= 1e-9
    assert float(((g.log_lik.cpu() - c.log_lik) / c.log_lik).abs().max()) <= 1e-11
