"""The port's f32 fast mode (``dtype=torch.float32``) against the JAX
package's (``PGPFA_X64=0``) and against the port's own f64 fit, on the
problem of ``tests/test_f32_mode.py`` (xdim 2, ydim 20, 5 trials of 1000 ms
in 20 ms bins, seed 123, init seed 0).

JAX's x64 flag is process-global and on in this process (the conftest), so
the JAX package's f32 results come from its functions called on f32 inputs
inside ``jax.enable_x64(False)``; for both fits below that gives the same
numbers, bit for bit, as a ``PGPFA_X64=0`` subprocess.

Two f32 computations of one quantity by two implementations differ by the
rounding of their factorizations, up to ``kappa * eps32`` relative for an
inverse of condition ``kappa``; EM then amplifies such differences about 5x
per iteration (CLAUDE.md item 11), so fits are held tightly at iteration 1
and to ``tests/test_f32_mode.py``'s envelopes after it.

On the card (``requires_cuda``): the f32 E-steps against the same calls on
the CPU, and the f32 fits launch ``chol32`` and never ``ns_step``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pgpfa.em.fit import FitConfig as JaxFitConfig
from pgpfa.em.fit import fit as jax_fit
from pgpfa.infer import laplace as JL
from pgpfa.learn import mstep_obs as jobs
from pgpfa.ops import blockmat as JB
from pgpfa_torch import FitConfig, dataset, fit, initialize_params
from pgpfa_torch.infer import laplace as TL
from pgpfa_torch.infer import variational as TV
from pgpfa_torch.learn import mstep_obs as tobs
from pgpfa_torch.models.params import rbf_kernel
from pgpfa_torch.models.poisson_gpfa import hessian_weights, linear_predictor
from pgpfa_torch.ops import blockmat as TB
from pgpfa_torch.ops import cuda_kernels
from torch_helpers import npy, rel_err, requires_cuda

BIN = 20.0
EPS32 = float(np.finfo(np.float32).eps)
N_ITER = 3
# tests/test_f32_mode.py's envelopes of the f32 fit around the f64 one
PLL_ENV, TAU_ENV, MONOTONE = 6e-2, 5e-3, 1e-3
# Iteration 1 of two f32 fits from identical inputs: the nPLL (and bound)
# of the port and the JAX package differ by 3.9e-4 (Laplace) and 7.3e-4
# (VI; bound 1.8e-4) here, the rounding of two f32 factorizations of the
# prior and the Hessians; held to 2e-3.
ITER1_TOL = 2e-3


@pytest.fixture(scope="module")
def problem():
    ds = dataset(xdim=2, ydim=20, numTrials=5, trialDur=1000, binSize=20, dOffset=1, fixTau=True,
                 fixedTau=np.linspace(0.1, 0.5, 2), seed=123)
    return ds, initialize_params(2, 20, ds, seed=0)


@pytest.fixture(scope="module")
def arrays32(problem):
    """f32 NumPy inputs at the init: C, d, tau, Y, the prior K, its exact
    inverse, the Laplace Hessian's time-local part W at zero modes and the
    dense Hessian."""
    ds, init = problem
    C, d, tau = (np.asarray(init[k], np.float64) for k in ("C", "d", "tau"))
    K = rbf_kernel(torch.from_numpy(tau), ds.T, BIN).numpy()
    Kinv = np.linalg.inv(K)
    X0 = torch.zeros(ds.numTrials, 2, ds.T, dtype=torch.float64)
    W = hessian_weights(torch.from_numpy(C), torch.exp(linear_predictor(
        torch.from_numpy(C), torch.from_numpy(d), X0))).numpy()
    H = TB.assemble_hessian(torch.from_numpy(W), torch.from_numpy(Kinv)).numpy()
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {k: f32(v) for k, v in dict(C=C, d=d, tau=tau, Y=ds.Y, K=K, Kinv=Kinv, W=W, H=H).items()}


def _kappa(M) -> float:
    ev = np.linalg.eigvalsh(np.asarray(M, np.float64))
    return float((ev[..., -1] / ev[..., 0]).max())


def _refuse_ns_step(*args):
    raise AssertionError("ns_step called on the f32 path")


@pytest.fixture
def no_ns_step(monkeypatch):
    """The f32 path has no Newton-Schulz step: a call to the kernel fails."""
    monkeypatch.setattr(cuda_kernels, "ns_step", _refuse_ns_step)


@pytest.mark.parametrize("name", ["inv_psd_mixed", "inv_psd_structured", "blocks_inv"])
def test_f32_inverses_match_jax(arrays32, no_ns_step, name):
    """The direct symmetrized f32 inverses against the JAX package's f32
    branch: each is within kappa * eps32 of the exact inverse, so the two are
    within 2 kappa eps32 of each other (relative to the largest entry)."""
    a = arrays32
    with jax.enable_x64(False):
        if name == "inv_psd_mixed":
            want = jax.vmap(JB.inv_psd_mixed)(jnp.asarray(a["H"]))
            got = TB.inv_psd_mixed(torch.from_numpy(a["H"]))
            kappa = _kappa(a["H"])
        elif name == "inv_psd_structured":
            Kinv = jnp.asarray(a["Kinv"])
            want = jax.vmap(lambda w: JB.inv_psd_structured(w, Kinv))(jnp.asarray(a["W"]))
            got = TB.inv_psd_structured(torch.from_numpy(a["W"]), torch.from_numpy(a["Kinv"]))
            kappa = _kappa(a["H"])
        else:
            want = JB.blocks_inv(jnp.asarray(a["K"]))
            got = TB.blocks_inv(torch.from_numpy(a["K"]))
            kappa = _kappa(a["K"])
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    assert torch.equal(got, got.transpose(-1, -2))
    assert rel_err(got, want) <= 2 * kappa * EPS32, (rel_err(got, want), kappa)


def test_f32_solve_psd_structured_matches_jax(arrays32, no_ns_step):
    """From one f32 factor, the default f32 solve is the unrefined one on
    both sides (ir_steps 0 in f32; an explicit count is still honored):
    the two triangular solves agree to 2 kappa eps32."""
    a = arrays32
    rhs = np.random.default_rng(5).normal(size=a["H"].shape[:-1]).astype(np.float32)
    W, Kinv, b = (torch.from_numpy(x) for x in (a["W"], a["Kinv"], rhs))
    L32 = TB.chol32(torch.from_numpy(a["H"]))
    got = TB.solve_psd_structured(W, Kinv, b, L32)
    assert torch.equal(got, TB.solve_psd_structured(W, Kinv, b, L32, ir_steps=0))
    assert not torch.equal(got, TB.solve_psd_structured(W, Kinv, b, L32, ir_steps=1))
    with jax.enable_x64(False):
        Kj = jnp.asarray(a["Kinv"])
        want = jax.vmap(lambda w, r, l: JB.solve_psd_structured(w, Kj, r, l))(
            jnp.asarray(a["W"]), jnp.asarray(rhs), jnp.asarray(npy(L32)))
    assert rel_err(got, want) <= 2 * _kappa(a["H"]) * EPS32


def _jax_newton(a, X0, Kinv):
    with jax.enable_x64(False):
        C, d = jnp.asarray(a["C"]), jnp.asarray(a["d"])
        w = jnp.ones(a["C"].shape[0], jnp.float32)
        Kj = jnp.asarray(Kinv)
        run = jax.jit(jax.vmap(lambda y, x0: JL._newton_solve(y, x0, C, d, Kj, w, 1e-8, 100)))
        return [np.asarray(v) for v in run(jnp.asarray(a["Y"]), jnp.asarray(X0))[:3]]


def _torch_newton(a, X0, Kinv, dtype=torch.float32):
    t = lambda k: torch.from_numpy(a[k]).to(dtype)  # noqa: E731
    return TL._newton_solve(t("Y"), torch.from_numpy(X0).to(dtype), t("C"), t("d"),
                            torch.from_numpy(Kinv).to(dtype),
                            torch.ones(a["C"].shape[0], dtype=dtype), 1e-8, 100)[:3]


def test_newton_solve_f32_matches_jax(arrays32, no_ns_step):
    """Cold f32 Newton from zero modes, prior inverse shared: the trial
    objectives agree to 1e-3 absolute (each is a difference of f32 sums
    whose terms reach ~1e3, |f| up to 800 here: 3e-4 observed) and the
    modes to 2e-3 of their largest entry (at dec_tol 3e-6 a mode is fixed
    only to ~sqrt(3e-6 / lambda_min(H))); the Newton counts within one."""
    a = arrays32
    X0 = np.zeros((a["Y"].shape[0], 2, a["Y"].shape[2]), np.float32)
    Xj, fj, itj = _jax_newton(a, X0, a["Kinv"])
    X, f, it = _torch_newton(a, X0, a["Kinv"])
    assert X.dtype == torch.float32
    np.testing.assert_allclose(npy(f), fj, rtol=0, atol=1e-3)
    assert rel_err(X, Xj) <= 2e-3
    assert np.abs(npy(it) - itj).max() <= 1, (npy(it), itj)


def test_newton_solve_f32_stall_cutoff(arrays32, no_ns_step):
    """A warm start whose Newton decrement is 0.6 of the f32 slack
    5e-7 (1 + |f|), from the mode of the same objective solved in f64: above
    the f32 dec_tol (3e-6), so the step is taken, and its gain (about half
    the decrement) is under the slack. A lane that stops after that one
    accepted step was stopped by the stall cutoff: the decrement test did
    not fire, and the gradient test's 1e-8 is below what an f32 gradient
    resolves. The f32 objective's own rounding here (1e-4 to 2e-3, as large
    as the slack) decides lane by lane whether the measured gain falls under
    the slack, so each implementation is held to a cutoff in at least one
    lane and every lane done within 3 iterations, and the two to the cold
    test's tolerances."""
    a = arrays32
    R, _, T = a["Y"].shape
    Kinv64 = a["Kinv"].astype(np.float64)  # the f32 solvers' objective, evaluated in f64
    X64, f64, _ = _torch_newton(a, np.zeros((R, 2, T)), Kinv64, torch.float64)
    C64, d64 = (torch.from_numpy(a[k]).double() for k in ("C", "d"))
    W = hessian_weights(C64, torch.exp(linear_predictor(C64, d64, X64)))
    v = torch.from_numpy(np.random.default_rng(11).normal(size=(R, 2 * T)))
    vHv = (v * TB.structured_mm(W, torch.from_numpy(Kinv64), v)).sum(-1, keepdim=True)
    dec = 0.6 * 5e-7 * (1.0 + f64.abs())  # per lane; 6e-6 or more, |f| >= 19 here
    assert float(dec.min()) > 3e-6
    X0 = (X64 + (v * (dec[:, None] / vHv).sqrt()).reshape(R, 2, T)).numpy().astype(np.float32)
    Xj, fj, itj = _jax_newton(a, X0, a["Kinv"])
    X, f, it = _torch_newton(a, X0, a["Kinv"])
    for Xs, its in ((npy(X), npy(it)), (Xj, itj)):
        moved = (Xs != X0).any(axis=(1, 2))
        assert int(its.max()) <= 3 and bool((moved & (its == 1)).any()), (its, moved)
    np.testing.assert_allclose(npy(f), fj, rtol=0, atol=1e-3)
    assert rel_err(X, Xj) <= 2e-3


def test_learn_cd_newton_f32_matches_jax(problem, monkeypatch):
    """The f32 (C, d) Newton on the port's f64 E-step moments cast to f32,
    8 steps as the fit takes them: the summed costs agree to 1e-5 relative
    (near the optimum the f32 acceptance slack 2e-6 (1 + |f|) lets each side
    take or skip a last step on rounding), and C, d to 2e-3."""
    ds, init = problem
    C, d, tau = (torch.from_numpy(np.asarray(init[k], np.float64)) for k in ("C", "d", "tau"))
    Y = torch.from_numpy(np.asarray(ds.Y, np.float64))
    inf, _ = TL.laplace_estep_from_arrays(C, d, tau, Y, ds.T, BIN)
    args = [x.float() for x in (Y, inf.post_mean, inf.post_vsm, C, d)]
    monkeypatch.setattr(cuda_kernels, "ns_step", _refuse_ns_step)
    t = tobs.learn_cd_newton(*args, n_iter=8)
    with jax.enable_x64(False):
        j = jobs.learn_cd_newton(*(jnp.asarray(npy(x)) for x in args), n_iter=8)
    assert t.C.dtype == torch.float32 and str(j.C.dtype) == "float32"
    assert abs(float(t.cost) - float(j.cost)) <= 1e-5 * abs(float(j.cost))
    np.testing.assert_allclose(npy(t.C), np.asarray(j.C), rtol=0, atol=2e-3)
    np.testing.assert_allclose(npy(t.d), np.asarray(j.d), rtol=0, atol=2e-3)


_FITS = {}


def _fits(problem, method):
    """JAX f32, port f32 (``ns_step`` refused) and port f64 fits, one set
    per method, shared by the tests of that method."""
    if method not in _FITS:
        ds, init = problem
        kw = dict(inference_method=method, vi_solver="newton", max_em_iter=N_ITER)
        with jax.enable_x64(False):
            j = jax_fit({k: np.asarray(v, np.float32) for k, v in init.items()},
                        np.asarray(ds.Y, np.float32), BIN, JaxFitConfig(**kw))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cuda_kernels, "ns_step", _refuse_ns_step)
            t32 = fit(init, ds.Y, BIN, FitConfig(**kw), device="cpu", dtype=torch.float32)
        t64 = fit(init, ds.Y, BIN, FitConfig(**kw), device="cpu")
        _FITS[method] = (j, t32, t64)
    return _FITS[method]


@pytest.mark.parametrize("method", ["laplace", "variational"])
def test_f32_fit_matches_jax_f32(problem, method):
    """A 3-iteration f32 fit (dual-Newton for VI) against the JAX package's
    f32 fit with the same FitConfig values: iteration 1's nPLL (and bound)
    to ITER1_TOL, every iteration to the f32 envelope, final tau to 5e-3 s."""
    j, t32, _ = _fits(problem, method)
    assert t32.C.dtype == t32.post_loglik.dtype == torch.float32
    series = [("post_loglik", t32.post_loglik, j.post_loglik)]
    if method == "variational":
        series.append(("var_lower_bound", t32.var_lower_bound, j.var_lower_bound))
    for name, got, want in series:
        got, want = npy(got), np.asarray(want)
        assert np.isfinite(got).all()
        assert abs(got[0] - want[0]) <= ITER1_TOL, (name, got[0] - want[0])
        np.testing.assert_allclose(got, want, rtol=0, atol=PLL_ENV, err_msg=name)
    np.testing.assert_allclose(npy(t32.tau), np.asarray(j.tau), rtol=0, atol=TAU_ENV)


@pytest.mark.parametrize("method", ["laplace", "variational"])
def test_f32_fit_tracks_own_f64(problem, method):
    """The port's f32 fit against its own f64 fit, within
    tests/test_f32_mode.py's envelopes: nPLL and bound 6e-2 absolute, tau
    5e-3 s, and both rising to 1e-3 per iteration."""
    _, t32, t64 = _fits(problem, method)
    series = [(t32.post_loglik, t64.post_loglik)]
    if method == "variational":
        series.append((t32.var_lower_bound, t64.var_lower_bound))
    for got, want in series:
        got = npy(got)
        assert np.all(np.diff(got) > -MONOTONE), got
        np.testing.assert_allclose(got, npy(want), rtol=0, atol=PLL_ENV)
    np.testing.assert_allclose(npy(t32.tau), npy(t64.tau), rtol=0, atol=TAU_ENV)


# -- on the card ----------------------------------------------------------------


@requires_cuda
@pytest.mark.parametrize("method", ["laplace", "variational"])
def test_cuda_f32_estep_matches_cpu(problem, method):
    """One cold f32 E-step on the card (chol32 launched, ns_step never)
    against the same call on the CPU: two f32 factorizations of the same
    inputs, held as the port against JAX at iteration 1 (ITER1_TOL)."""
    ds, init = problem
    args = lambda dev: [torch.as_tensor(np.asarray(init[k], np.float32), device=dev)  # noqa: E731
                        for k in ("C", "d", "tau")] + [
        torch.as_tensor(np.asarray(ds.Y, np.float32), device=dev)]
    n_ch, n_ns = cuda_kernels.chol32.launches, cuda_kernels.ns_step.launches
    if method == "laplace":
        gpu = TL.laplace_estep_from_arrays(*args("cuda"), ds.T, BIN)[1:]
        cpu = TL.laplace_estep_from_arrays(*args("cpu"), ds.T, BIN)[1:]
    else:
        gpu = TV.vi_estep_from_arrays(*args("cuda"), ds.T, BIN, solver="newton")[1:3]
        cpu = TV.vi_estep_from_arrays(*args("cpu"), ds.T, BIN, solver="newton")[1:3]
    torch.cuda.synchronize()
    assert cuda_kernels.chol32.launches > n_ch and cuda_kernels.ns_step.launches == n_ns
    for g, c in zip(gpu, cpu):
        assert g.dtype == torch.float32 and g.device.type == "cuda"
        assert abs(float(g) - float(c)) <= ITER1_TOL, (float(g), float(c))
