"""Trial-parallel EM over ``torch.distributed`` (``pgpfa_torch.parallel``)
against the JAX package's ``pgpfa.parallel`` on ``tests/test_parallel.py``'s
problem (16 trials x 16 neurons, 30 bins of 20 ms, xdim 2).

The ranks are CPU processes forked by ``torch_helpers.run_ranks`` and joined
by a gloo group. The JAX side runs on its 8-device virtual mesh and is
recorded in ``tests/torch_parallel_reference.npz``
(``python tests/torch_parallel_reference.py``); nothing here runs JAX.
Sharded online EM is tested in ``tests/test_torch_parallel_online.py``.

Tolerances: a sharded fit sums the same trial terms in another order, so it
is held to the port's own one-process fit with ``tests/test_parallel.py``'s
tolerances (Laplace: nPLL 1e-9 relative, C 1e-7, tau 1e-8; VI: iteration 1
1e-9, all iterations 1e-6, C 1.5e-4). The JAX recording is a second
implementation: it is held as ``tests/test_torch_fit.py`` holds the port's
fit against the JAX package's (iteration 1 1e-9 relative, iteration n
1e-6 * 5^(n-1) absolute, parameters 1e-6 after EM's amplification).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pgpfa_torch
from pgpfa_torch import FitConfig, fit
from pgpfa_torch.learn.mstep_gp import pauto_sum
from pgpfa_torch.ops.blocktridiag import btd_solve_cr
from pgpfa_torch.parallel import (
    btd_solve_cr_timesharded,
    fit_multihost,
    fit_sharded,
    init_distributed,
    make_mesh_2d,
    mesh_for_trials,
    sharded_estep_stats,
    trial_slice,
)
from torch_helpers import npy, parallel_problem, run_ranks
from torch_parallel_reference import cr_system, load, sharded_configs

BIN = 20.0
REF = load()
DATA, INIT = parallel_problem()
CONFIGS = sharded_configs(FitConfig)
HIST = ("post_loglik", "var_lower_bound", "C", "d", "tau")


def _init(key):
    tau = CONFIGS[key][1]
    return dict(INIT) if tau is None else {**INIT, "tau": tau}


def _result(r):
    return {k: getattr(r, k) for k in HIST + ("newton_iters",)}


def _sharded(rank, world, key):
    return _result(fit_sharded(_init(key), DATA.Y, BIN, CONFIGS[key][0], device="cpu"))


_SINGLE = {}


def _single(key):
    if key not in _SINGLE:
        _SINGLE[key] = _result(fit(_init(key), DATA.Y, BIN, CONFIGS[key][0], device="cpu"))
    return _SINGLE[key]


def test_mesh_for_trials_is_jax_rule():
    """The rank count for 1..20 trials on 8 ranks is the JAX package's
    device count (recorded table); the slices tile the trials, and ranks
    past that count hold none."""
    got = [mesh_for_trials(n, 8) for n in range(1, 21)]
    assert got == REF["mesh_sizes"].tolist()
    for n in range(1, 21):
        idx = [i for r in range(8) for i in range(n)[trial_slice(r, n, 8)]]
        assert idx == list(range(n))
        assert all(len(range(n)[trial_slice(r, n, 8)]) == 0 for r in range(got[n - 1], 8))


@pytest.mark.parametrize("key", ["laplace", "vi", "banded"])
def test_fit_sharded_two_ranks(key):
    """Two gloo ranks of 8 trials each: the same result on both ranks, the
    port's one-process fit within tests/test_parallel.py's tolerances, and
    the JAX package's recorded fit_sharded within the cross-implementation
    envelope."""
    outs = run_ranks(2, _sharded, key)
    for k in HIST:
        assert torch.equal(outs[0][k], outs[1][k]), k
    assert outs[0]["newton_iters"].shape[-1] == 8
    got, one = outs[0], _single(key)
    pll, pll1 = npy(got["post_loglik"]), npy(one["post_loglik"])
    assert np.isfinite(pll).all()
    if key == "vi":
        np.testing.assert_allclose(pll[:1], pll1[:1], rtol=1e-9)
        np.testing.assert_allclose(pll, pll1, rtol=1e-6)
        np.testing.assert_allclose(npy(got["var_lower_bound"]), npy(one["var_lower_bound"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(npy(got["C"]), npy(one["C"]), atol=1.5e-4)
    else:
        np.testing.assert_allclose(pll, pll1, rtol=1e-9)
        np.testing.assert_allclose(npy(got["C"]), npy(one["C"]), atol=1e-7)
        np.testing.assert_allclose(npy(got["tau"]), npy(one["tau"]), atol=1e-8)
    jax_pll = REF[f"sharded_{key}_post_loglik"]
    assert abs(pll[0] - jax_pll[0]) <= 1e-9 * abs(jax_pll[0])
    for n in range(1, len(pll)):
        assert abs(pll[n] - jax_pll[n]) <= 1e-6 * 5.0 ** (n - 1), (n, pll[n] - jax_pll[n])
    np.testing.assert_allclose(npy(got["tau"]), REF[f"sharded_{key}_tau"], rtol=1e-5)


def test_fit_sharded_without_group_is_fit():
    """Without a process group fit_sharded and fit_multihost are fit, bit
    for bit, batch and online; fit_loop(reduce=...) with an identity reduce
    (one process, each mean taken as sum / count) is the online fit to
    rounding."""
    assert not torch.distributed.is_initialized()
    a = _result(fit_sharded(INIT, DATA.Y, BIN, CONFIGS["laplace"][0], device="cpu"))
    for k, v in _single("laplace").items():
        assert torch.equal(a[k], v), k
    online = FitConfig(em_mode="online", max_em_iter=2, batch_size=4)
    want = _result(fit(INIT, DATA.Y, BIN, online, device="cpu", seed=1))
    for entry in (fit_sharded, fit_multihost):
        got = _result(entry(INIT, DATA.Y, BIN, online, device="cpu", seed=1))
        for k, v in want.items():
            assert torch.equal(got[k], v), (entry.__name__, k)
    got = _result(pgpfa_torch.fit_loop(INIT, DATA.Y, BIN, online, device="cpu", seed=1,
                                       reduce=lambda t: t))
    assert torch.equal(got["newton_iters"], want["newton_iters"])
    for k in HIST:
        np.testing.assert_allclose(npy(got[k]), npy(want[k]), rtol=1e-11, atol=1e-11, err_msg=k)


def test_idle_rank_changes_nothing():
    """Three ranks on 16 trials use two (mesh_for_trials); the third holds
    no trials (its E-steps, the Laplace Newton and the dual's L-BFGS, run
    on none), adds zeros to every collective, and the result equals the
    two-rank one bit for bit, Laplace and VI."""
    for key in ("laplace", "vi"):
        two = run_ranks(2, _sharded, key)[0]
        three = run_ranks(3, _sharded, key)
        assert three[2]["newton_iters"].shape[-1] == 0
        for k in HIST:
            assert torch.equal(three[2][k], two[k]) and torch.equal(three[0][k], two[k]), (key, k)


def _multihost(rank, world, split):
    lo, hi = split[rank], split[rank + 1]
    r = fit_multihost(INIT, DATA.Y[lo:hi], BIN, CONFIGS["laplace"][0], device="cpu")
    return _result(r)


def test_fit_multihost_local_trials():
    """Each rank passing its own 8 trials equals fit_sharded bit for bit.
    An uneven split (5 and 11 trials) sums the same terms in another order;
    held to the one-process fit within tests/test_parallel.py's nPLL and C
    tolerances, and tau to 1e-7 like C (after 4 EM iterations its tau lies
    3.4e-8 from the one-process fit's; the even split's 7.8e-10)."""
    even = run_ranks(2, _multihost, [0, 8, 16])
    sharded = run_ranks(2, _sharded, "laplace")
    for k in HIST:
        assert torch.equal(even[0][k], sharded[0][k]), k
    uneven = run_ranks(2, _multihost, [0, 5, 16])[1]
    one = _single("laplace")
    np.testing.assert_allclose(npy(uneven["post_loglik"]), npy(one["post_loglik"]), rtol=1e-9)
    np.testing.assert_allclose(npy(uneven["C"]), npy(one["C"]), atol=1e-7)
    np.testing.assert_allclose(npy(uneven["tau"]), npy(one["tau"]), atol=1e-7)


def test_init_distributed_without_launcher(monkeypatch):
    """Without a launcher's environment and without arguments it does
    nothing and returns False."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False
    assert init_distributed("gloo") is False
    assert not torch.distributed.is_initialized()


def _stats(rank, world):
    sl = trial_slice(rank, len(DATA.Y), world)
    args = [torch.as_tensor(np.asarray(INIT[k], np.float64)) for k in ("C", "d", "tau")]
    X, _, _, pauto, obj_sum, n = sharded_estep_stats(
        *args, torch.as_tensor(DATA.Y[sl]), DATA.T, BIN)
    return X, pauto, obj_sum, n


def test_sharded_estep_stats():
    """Two ranks' reduced PautoSum, objective sum and count against the
    one-process E-step (1e-10) and the JAX package's recording (the modes'
    and PautoSum's floor between the packages, 1e-6, as
    tests/test_parallel.py holds them)."""
    outs = run_ranks(2, _stats)
    X = torch.cat([o[0] for o in outs])
    _, pauto, obj_sum, n = outs[0]
    assert float(n) == 16 and torch.equal(pauto, outs[1][1])
    args = [torch.as_tensor(np.asarray(INIT[k], np.float64)) for k in ("C", "d", "tau")]
    inf, pll = pgpfa_torch.laplace_estep_from_arrays(*args, torch.as_tensor(DATA.Y), DATA.T, BIN,
                                                     compute_cov=False)
    want = pauto_sum(inf.post_mean, inf.post_vsm_gp)
    assert float((pauto - want).abs().max() / want.abs().max()) <= 1e-10
    assert abs(float(-obj_sum / n) - float(pll)) <= 1e-10 * abs(float(pll))
    assert float((X - inf.post_mean).abs().max()) <= 1e-10
    np.testing.assert_allclose(npy(pauto), REF["stats_pauto"], rtol=1e-6)
    np.testing.assert_allclose(float(obj_sum), float(REF["stats_obj_sum"]), rtol=1e-10)
    np.testing.assert_allclose(npy(X), REF["stats_X"], atol=1e-6)


def _cr(rank, world, n_trial):
    D, B, rhs = (torch.as_tensor(a) for a in cr_system())
    Bp = torch.cat([B, torch.zeros_like(B[:, :1])], 1)
    if n_trial is None:
        n = D.shape[1] // world
        sl, tr, group = slice(rank * n, (rank + 1) * n), slice(None), None
    else:
        mesh = make_mesh_2d(world, n_trial)
        n = D.shape[1] // mesh.n_time
        sl = slice(mesh.time_index * n, (mesh.time_index + 1) * n)
        tr, group = slice(mesh.trial_index, mesh.trial_index + 1), mesh.time_group
    return tr, sl, btd_solve_cr_timesharded(D[tr, sl], Bp[tr, sl], rhs[tr, sl], group)


@pytest.mark.parametrize("world, n_trial", [(2, None), (4, 2)])
def test_time_sharded_cr_solve(world, n_trial):
    """The block-cyclic-reduction solve with its 16 blocks split over 2
    ranks, and over a (2 trials, 2 time) grid of 4, against the
    one-process btd_solve_cr and the JAX package's 2 x 4 recording
    (1e-11, tests/test_parallel.py's)."""
    D, B, rhs = (torch.as_tensor(a) for a in cr_system())
    want = btd_solve_cr(D, B, rhs)
    got = torch.zeros_like(want)
    for tr, sl, x in run_ranks(world, _cr, n_trial):
        got[tr, sl] = x
    assert float((got - want).abs().max()) <= 1e-11
    np.testing.assert_allclose(npy(got), REF["cr_timesharded"], rtol=0, atol=1e-11)


def test_import_has_no_jax():
    """Importing the parallel package imports neither JAX nor the JAX
    package."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, pgpfa_torch.parallel.sharded, pgpfa_torch.parallel; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'pgpfa')))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=repo,
                       timeout=120, check=True)
    assert r.stdout.strip() == "[]", r.stdout
