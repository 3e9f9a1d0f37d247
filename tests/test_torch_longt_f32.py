"""The banded long-trial path in the f32 fast mode
(``fit(..., FitConfig(time_block=25), dtype=torch.float32)``) on
``tests/test_f32_mode.py``'s ``"banded"`` problem: 5 trials x 20 neurons,
1000 ms of 20 ms bins, taus (0.05, 0.08) s, seed 123, init seed 0.

The JAX package's f32 and f64 fits of that configuration are recorded in
``tests/torch_parallel_reference.npz`` (``python tests/torch_parallel_reference.py``;
each precision in its own ``PGPFA_X64`` subprocess); nothing here runs JAX.

In f32 the banded path's block inverses are the symmetrized f32 inverses of
the f32 factor, with no Newton-Schulz step (as the JAX package's f32
branch), so ``ns_step`` must never run. Fits are held to
``tests/test_torch_f32.py``'s envelopes around the f64 fit: nPLL and bound
6e-2, tau 5e-3 s, rising to 1e-3 per iteration. The JAX package's own f32
banded VI fit lies up to 0.114 (nPLL) and 0.221 (bound) from its f64 fit,
outside that envelope, which its own tests never apply to banded VI. So the
port's f32 fits are held to JAX's f32 fits within the envelope plus JAX's
own f32 departure, and the port's f32 bound to its f64 bound within the
same allowance (the warm iteration-2 dual stops on its f32 slack in both
packages: 0.112 from f64 in the port, 0.169 in JAX); nPLL and tau stay
within the envelope of the f64 fits.
"""

import numpy as np
import pytest
import torch

from pgpfa_torch import FitConfig, fit
from pgpfa_torch.infer import variational_longt as TVL
from pgpfa_torch.infer.laplace_longt import laplace_estep_banded
from pgpfa_torch.infer.variational_longt import vi_estep_banded
from pgpfa_torch.learn.mstep_gp import learn_tau_banded
from pgpfa_torch.ops import blockmat as TB
from pgpfa_torch.ops import cuda_kernels
from torch_helpers import npy, rel_err, requires_cuda
from torch_parallel_reference import F32_BIN, F32_CFG, f32_problem, load, logdet_matrices

REF = load()
EPS32 = float(np.finfo(np.float32).eps)
# tests/test_torch_f32.py's envelopes and its iteration-1 tolerance between
# two f32 computations of one E-step
PLL_ENV, TAU_ENV, MONOTONE, ITER1_TOL = 6e-2, 5e-3, 1e-3, 2e-3
# The fixed 12-body banded Newton accepts a body only where the objective
# (~500) falls, which f32 resolves to ~3e-5: a mode freezes where a step's
# decrease 0.5 dx^T H dx drops below that, ~3e-3 per coordinate here
# (measured: modes 3.0e-3 Laplace, 6.9e-3 VI; post_vsm 8.8e-5).
MODE_TOL, VSM_TOL = 2e-2, 5e-4
METHODS = ["laplace", "variational"]


def _refuse_ns_step(*args):
    raise AssertionError("ns_step called on the f32 path")


@pytest.fixture
def no_ns_step(monkeypatch):
    monkeypatch.setattr(cuda_kernels, "ns_step", _refuse_ns_step)


@pytest.fixture(scope="module")
def problem():
    return f32_problem()


_FITS = {}


def _fits(problem, method):
    """The port's f32 fit (ns_step refused) and f64 fit, once per module."""
    if method not in _FITS:
        ds, init = problem
        cfg = FitConfig(inference_method=method, **F32_CFG)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cuda_kernels, "ns_step", _refuse_ns_step)
            t32 = fit(init, ds.Y, F32_BIN, cfg, device="cpu", dtype=torch.float32)
        _FITS[method] = (t32, fit(init, ds.Y, F32_BIN, cfg, device="cpu"))
    return _FITS[method]


def _series(r, method):
    out = [("post_loglik", npy(r.post_loglik))]
    if method == "variational":
        out.append(("var_lower_bound", npy(r.var_lower_bound)))
    return out


def _allowance(method, name):
    """PLL_ENV per iteration, plus the JAX f32 bound's own departure from
    its f64 bound for the VI bound."""
    if name == "post_loglik":
        return PLL_ENV
    return PLL_ENV + np.abs(REF[f"banded_f32_{method}_{name}"] - REF[f"banded_f64_{method}_{name}"])


@pytest.mark.parametrize("method", METHODS)
def test_f32_banded_fit_against_jax(problem, method):
    """The port's f32 banded fit against the JAX package's recorded fits of
    the same configuration: its f64 fit within the envelope (nPLL, tau; the
    bound within _allowance), its f32 fit within the envelope plus the JAX
    f32 fit's own distance from its f64 fit."""
    t32, _ = _fits(problem, method)
    assert t32.C.dtype == t32.post_loglik.dtype == torch.float32
    assert str(REF[f"banded_f32_{method}_dtype"]) == "float32"
    for name, got in _series(t32, method):
        j32, j64 = REF[f"banded_f32_{method}_{name}"], REF[f"banded_f64_{method}_{name}"]
        assert np.isfinite(got).all()
        assert np.all(np.abs(got - j64) <= _allowance(method, name)), (name, got - j64)
        assert np.all(np.abs(got - j32) <= PLL_ENV + np.abs(j32 - j64)), (name, got - j32)
    np.testing.assert_allclose(npy(t32.tau), REF[f"banded_f64_{method}_tau"], rtol=0,
                               atol=TAU_ENV)
    j32_tau, j64_tau = REF[f"banded_f32_{method}_tau"], REF[f"banded_f64_{method}_tau"]
    assert np.all(np.abs(npy(t32.tau) - j32_tau) <= TAU_ENV + np.abs(j32_tau - j64_tau))


@pytest.mark.parametrize("method", METHODS)
def test_f32_banded_fit_tracks_own_f64(problem, method):
    """The port's f32 banded fit against its own f64 fit: nPLL within 6e-2
    (the bound within _allowance), both rising to 1e-3 per iteration, tau
    within 5e-3 s."""
    t32, t64 = _fits(problem, method)
    for (name, got), (_, want) in zip(_series(t32, method), _series(t64, method)):
        assert np.all(np.diff(got) > -MONOTONE), (name, got)
        assert np.all(np.abs(got - want) <= _allowance(method, name)), (name, got - want)
    np.testing.assert_allclose(npy(t32.tau_seq), npy(t64.tau_seq), rtol=0, atol=TAU_ENV)


def _estep(problem, method, dtype, device="cpu"):
    """A cold banded E-step in ``dtype``: Laplace at the true parameters; VI
    at the init (at the true parameters the dual from rho = 0 does not
    converge in 150 L-BFGS iterations, in either package: nPLL ~ -7.7e14)."""
    ds, init = problem
    p = ds.params if method == "laplace" else init
    a = [torch.as_tensor(np.reshape(p[k], s), dtype=dtype, device=device)
         for k, s in (("C", (20, 2)), ("d", -1), ("tau", -1))]
    Y = torch.as_tensor(ds.Y, dtype=dtype, device=device)
    fn = laplace_estep_banded if method == "laplace" else vi_estep_banded
    return fn(*a, Y, ds.T, F32_BIN, F32_CFG["time_block"])


@pytest.mark.parametrize("method", METHODS)
def test_f32_banded_estep_against_f64(problem, method):
    """One f32 banded E-step against the f64 one on the same inputs: nPLL
    within ITER1_TOL (the bound within iteration 1's _allowance: 1.4e-2
    measured, the JAX package's 5.6e-2), modes and post_vsm within the f32
    Newton's stall (MODE_TOL, VSM_TOL); no ns_step in f32."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_kernels, "ns_step", _refuse_ns_step)
        o32 = _estep(problem, method, torch.float32)
    o64 = _estep(problem, method, torch.float64)
    assert o32[0].post_mean.dtype == o32[1].dtype == torch.float32
    assert abs(float(o32[1]) - float(o64[1])) <= ITER1_TOL, (float(o32[1]), float(o64[1]))
    if method == "variational":
        tol = _allowance(method, "var_lower_bound")[0]
        assert abs(float(o32[2]) - float(o64[2])) <= tol, (float(o32[2]), float(o64[2]))
    assert float((o32[0].post_mean.double() - o64[0].post_mean).abs().max()) <= MODE_TOL
    assert float((o32[0].post_vsm.double() - o64[0].post_vsm).abs().max()) <= VSM_TOL


def test_f32_block_inverse_and_logdet(no_ns_step):
    """The banded path's block inverse in f32 (``inv_logdet_psd_mixed``, as
    ``ops/blocktridiag.py`` reaches it): the inverse is the symmetrized f32
    inverse of the equilibrated matrix's f32 factor, computed once and
    shared with the logdet (no ns_step); both against the exact values and
    the JAX package's recorded f32 branch, within kappa * eps32."""
    H64 = logdet_matrices()
    H = torch.as_tensor(H64, dtype=torch.float32)
    X, ld = TB.inv_logdet_psd_mixed(H)
    assert X.dtype == ld.dtype == torch.float32 and torch.equal(X, X.transpose(-1, -2))
    Hs, s = TB._equilibrate(H)
    X32 = TB._inv32(TB.chol32(Hs))
    assert torch.equal(X, TB._sym(X32) * (s[..., :, None] * s[..., None, :]))
    kappa = float(np.linalg.cond(H64).max())
    exact_inv, exact_ld = np.linalg.inv(H64), np.linalg.slogdet(H64)[1]
    assert rel_err(X, exact_inv) <= kappa * EPS32
    assert rel_err(X, REF["banded_f32_inv"]) <= 2 * kappa * EPS32
    assert np.abs(npy(ld) - exact_ld).max() <= kappa * EPS32
    assert np.abs(npy(ld) - REF["banded_f32_logdet"]).max() <= 2 * kappa * EPS32


def test_f32_block_inverse_derivative_rule(no_ns_step):
    """``inv_logdet_psd_mixed_d`` in f32 differentiates by the exact rules
    from its saved f32 inverse: the gradient of ``<W, H^-1> + logdet H`` is
    ``-X W X + X``, within 4 kappa eps32 of the exact f64 one."""
    H64 = logdet_matrices()
    W = np.random.default_rng(2).standard_normal(H64.shape)
    H = torch.as_tensor(H64, dtype=torch.float32).requires_grad_(True)
    X, ld = TB.inv_logdet_psd_mixed_d(H)
    ((torch.as_tensor(W, dtype=torch.float32) * X).sum() + ld.sum()).backward()
    Xe = np.linalg.inv(H64)
    want = -Xe @ W @ Xe + Xe
    kappa = float(np.linalg.cond(H64).max())
    assert H.grad.dtype == torch.float32
    assert rel_err(H.grad, want) <= 4 * kappa * EPS32


def test_f32_banded_vi_slack(problem, monkeypatch):
    """The banded dual's chunked L-BFGS stops on an f32 slack of 1e-6 per
    trial in f32 and 1e-13 in f64 (``pgpfa/infer/variational_longt.py:181``)."""
    seen = []
    real = TVL.lbfgs_chunked_driver

    def spy(*args, **kw):
        seen.append(kw["slack_coef"])
        return real(*args, **kw)

    monkeypatch.setattr(TVL, "lbfgs_chunked_driver", spy)
    ds, init = problem
    for dt in (torch.float32, torch.float64):
        a = [torch.as_tensor(np.reshape(init[k], s), dtype=dt)
             for k, s in (("C", (20, 2)), ("d", -1), ("tau", -1))]
        vi_estep_banded(*a, torch.as_tensor(ds.Y[:1], dtype=dt), ds.T, F32_BIN, 25, maxiter=2)
    assert seen == [1e-6, 1e-13]


def test_f32_banded_tau_mstep(problem):
    """The f32 banded tau M-step (secant on the f32 cost, deciding by the
    exact gradient within the cost's rounding band), from the init's tau on
    the f64 Laplace E-step's moments at the true parameters, lands within
    TAU_ENV of the f64 M-step."""
    ds, init = problem
    inf = _estep(problem, "laplace", torch.float64)[0]
    tau0 = np.asarray(init["tau"], np.float64)
    t64 = learn_tau_banded(inf.post_mean, inf.vsm_gp_diag, inf.vsm_gp_off,
                           torch.as_tensor(tau0), F32_BIN, maxiter=12)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_kernels, "ns_step", _refuse_ns_step)
        t32 = learn_tau_banded(inf.post_mean.float(), inf.vsm_gp_diag.float(),
                               inf.vsm_gp_off.float(), torch.as_tensor(tau0, dtype=torch.float32),
                               F32_BIN, maxiter=12)
    assert t32.tau.dtype == torch.float32 and bool((t32.niter > 0).all())
    np.testing.assert_allclose(npy(t32.tau), npy(t64.tau), rtol=0, atol=TAU_ENV)


@requires_cuda
def test_cuda_f32_banded_estep_matches_cpu(problem):
    """The f32 banded Laplace E-step on the card (chol32 launched, ns_step
    never) against the same call on the CPU: nPLL within ITER1_TOL, modes
    within MODE_TOL."""
    n_ch, n_ns = cuda_kernels.chol32.launches, cuda_kernels.ns_step.launches
    gpu = _estep(problem, "laplace", torch.float32, "cuda")
    torch.cuda.synchronize()
    assert cuda_kernels.chol32.launches > n_ch and cuda_kernels.ns_step.launches == n_ns
    cpu = _estep(problem, "laplace", torch.float32)
    assert gpu[1].device.type == "cuda" and gpu[1].dtype == torch.float32
    assert abs(float(gpu[1]) - float(cpu[1])) <= ITER1_TOL
    assert float((gpu[0].post_mean.cpu() - cpu[0].post_mean).abs().max()) <= MODE_TOL
