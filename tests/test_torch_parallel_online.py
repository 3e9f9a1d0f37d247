"""Sharded online EM over ``torch.distributed`` (``fit_sharded``,
``fit_multihost`` and ``fit_loop(reduce=...)`` with ``em_mode="online"``) on
``tests/test_parallel.py``'s problem (16 trials x 16 neurons, 30 bins of
20 ms, xdim 2), the minibatch stream ``torch_compat_reference.STREAM``
(3 iterations of 4 trials) injected on every side.

The ranks are CPU processes forked by ``torch_helpers.run_ranks`` and joined
by a gloo group; every rank holds all trials (``fit_sharded``: trials 0-7 on
rank 0, 8-15 on rank 1) or its own (``fit_multihost``). Iteration 2's
minibatch lies in trials 0-7, so rank 1 holds none of it and still takes
part in every collective.

Tolerances. The ranks' results are bit-equal. A sharded fit sums the
minibatch's terms in another order than the one-process fit on the same
stream: iteration 1's nPLL is held to 1e-9 relative and its cost to 1e-6,
every nPLL and cost to 1e-6 relative, the parameters to 2e-5
(``tests/test_torch_online.py``'s parameter and cost tolerances). The later
nPLLs and costs are relative because the (C, d) Newton's accept tests tie
differently near the optimum on sums in another order: the joint 'diag'
parameters after iteration 2 differ by 5e-8 and iteration 3's nPLL by
1.1e-6 and cost by 1.4e-6 (3.4e-9 relative), as the card's and the CPU's
do (``chip_smoke.py``'s online phase). The variational fit is held as
``tests/test_torch_parallel.py`` holds its sharded VI (iteration 1 1e-9,
nPLL and bound 1e-6 relative, C 1.5e-4); the f32 fit within ``tests/test_torch_f32.py``'s envelopes (nPLL 6e-2, tau
5e-3 s; its f32 accept tests tie the same way, 3.7e-4 in C measured). The
JAX package's one-device online fit on the stream (recorded in
``tests/torch_compat_reference.npz``; sharding is exact in JAX) is a second
implementation, held as ``tests/test_torch_parallel.py`` holds its JAX
recordings: iteration 1 1e-9 relative (cost 1e-6), iteration n's nPLL and
cost 1e-6 * 5^(n-1), the parameters 2e-5. Nothing here runs JAX.
"""

import numpy as np
import pytest
import torch

from pgpfa_torch import FitConfig, fit
from pgpfa_torch.parallel import fit_multihost, fit_sharded
from torch_compat_reference import BIN, STREAM, load, online_config
from torch_helpers import npy, parallel_problem, run_ranks
from torch_parallel_reference import BANDED_TAU

REF = load()
DATA, INIT = parallel_problem()
PLL0_REL, PLL_REL, PARAM_TOL, COST_TOL = 1e-9, 1e-6, 2e-5, 1e-6
VI_REL, VI_C_TOL = 1e-6, 1.5e-4
F32_PLL_ENV, F32_TAU_ENV = 6e-2, 5e-3
HIST = ("post_loglik", "var_lower_bound", "C_seq", "d_seq", "tau_seq", "cd_cost", "tau_cost")
IDLE = 1  # iteration 2's minibatch: trials 0-7 only


def _result(r):
    return {k: getattr(r, k) for k in HIST + ("newton_iters",)}


def _cfg(**kw):
    return FitConfig(**online_config(**kw))


def _sharded(rank, world, kw, dtype=torch.float64, init=None):
    r = fit_sharded(init or INIT, DATA.Y, BIN, _cfg(**kw), device="cpu", dtype=dtype,
                    batch_indices=STREAM)
    return _result(r)


def _single(kw, dtype=torch.float64, init=None):
    return _result(fit(init or INIT, DATA.Y, BIN, _cfg(**kw), device="cpu", dtype=dtype,
                       batch_indices=STREAM))


def _same_on_ranks(outs):
    for k in HIST:
        for o in outs[1:]:
            assert torch.equal(outs[0][k], o[k]), k


def _held(got, want, jax=False):
    """``got`` (a result dict) against ``want`` (a result dict, or with
    ``jax`` the JAX recording's arrays) at the module's tolerances."""
    pg, pw = npy(got["post_loglik"]), npy(want["post_loglik"])
    assert np.isfinite(pg).all()
    assert abs(pg[0] - pw[0]) <= PLL0_REL * abs(pw[0])
    cg, cw = npy(got["cd_cost"]), npy(want["cd_cost"])
    assert abs(cg[0] - cw[0]) <= COST_TOL
    if jax:
        for n in range(1, len(pg)):
            env = 1e-6 * 5.0 ** (n - 1)
            assert abs(pg[n] - pw[n]) <= env and abs(cg[n] - cw[n]) <= env, n
    else:
        np.testing.assert_allclose(pg, pw, rtol=PLL_REL)
        np.testing.assert_allclose(cg, cw, rtol=PLL_REL)
    for k in ("C_seq", "d_seq", "tau_seq"):
        np.testing.assert_allclose(npy(got[k]), npy(want[k]), rtol=0, atol=PARAM_TOL, err_msg=k)


RULES = ([dict(online_update=m) for m in ("diag", "hess", "grad", "balancingGamma",
                                          "sequentialAverage", "fullyUpdateAll")]
         + [dict(online_update=m, update_cd_jointly=False) for m in ("diag", "hess", "grad")])


@pytest.mark.parametrize("kw", RULES, ids=lambda kw: "-".join(map(str, kw.values())))
def test_sharded_online_rule(kw):
    """Two ranks, each of the six rules joint and C-only 'diag', 'hess' and
    'grad': the ranks bit-equal, the one-process fit on the stream within
    the module's tolerances; rank 1 idle at iteration 2 (its newton_iters
    row all -1), the ranks' iteration-1 Newton counts together the
    one-process fit's; the 'diag' fits also against the JAX package's."""
    outs = run_ranks(2, _sharded, kw)
    _same_on_ranks(outs)
    one = _single(kw)
    _held(outs[0], one)
    nwi = [npy(o["newton_iters"]) for o in outs]
    assert nwi[0].shape == (len(STREAM), STREAM.shape[1])
    assert (nwi[1][IDLE] == -1).all() and (nwi[0][IDLE] >= 0).all()
    merged = np.where(STREAM[0] < 8, nwi[0][0], nwi[1][0])
    assert ((nwi[0][0] == -1) != (nwi[1][0] == -1)).all()
    np.testing.assert_array_equal(merged, npy(one["newton_iters"])[0])
    if kw["online_update"] == "diag":
        name = "joint" if kw.get("update_cd_jointly", True) else "conly"
        _held(outs[0], {k: REF[f"online_{name}_{k}"] for k in
                        ("post_loglik", "C_seq", "d_seq", "tau_seq", "cd_cost")}, jax=True)


def _multihost(rank, world, split, kw):
    lo, hi = split[rank], split[rank + 1]
    return _result(fit_multihost(INIT, DATA.Y[lo:hi], BIN, _cfg(**kw), device="cpu",
                                 batch_indices=STREAM))


def test_fit_multihost_uneven_online():
    """Ranks passing 10 and 6 of their own trials (the offsets from one
    collective of the local counts), joint 'diag' and C-only 'hess': the
    ranks bit-equal, the one-process fit within the module's tolerances,
    rank 1 idle at iteration 2."""
    for kw in (dict(online_update="diag"), dict(online_update="hess", update_cd_jointly=False)):
        outs = run_ranks(2, _multihost, [0, 10, 16], kw)
        _same_on_ranks(outs)
        _held(outs[0], _single(kw))
        nwi = [npy(o["newton_iters"]) for o in outs]
        assert (nwi[1][IDLE] == -1).all()
        np.testing.assert_array_equal(nwi[0][0] == -1, STREAM[0] >= 10)


def _resumable(rank, world, mode, path, stop_after, resume):
    kw = dict(checkpoint_path=path, checkpoint_every=1, stop_after=stop_after,
              resume_from=path if resume else None)
    if mode == "online":
        cfg = FitConfig(em_mode="online", batch_size=4, max_em_iter=4, online_update="diag")
        r = fit_sharded(INIT, DATA.Y, BIN, cfg, device="cpu", seed=3, **kw)
    else:  # batch EM's warm start: 10 and 6 local trials
        lo, hi = [0, 10, 16][rank:rank + 2]
        r = fit_multihost(INIT, DATA.Y[lo:hi], BIN, FitConfig(max_em_iter=4), device="cpu", **kw)
    return _result(r)


def test_sharded_resume(tmp_path):
    """Fits stopped after 2 iterations with a checkpoint written by rank 0
    and resumed by both ranks equal the uninterrupted fits bit for bit on
    both ranks, history included: online on fit_sharded's drawn stream
    (seed 3), and batch on fit_multihost with 10 and 6 local trials, whose
    checkpoint holds the warm starts of all 16 trials (each rank resumes
    from its own)."""
    for mode in ("online", "batch"):
        full = run_ranks(2, _resumable, mode, None, None, False)
        path = str(tmp_path / f"{mode}.npz")
        part = run_ranks(2, _resumable, mode, path, 2, False)
        assert npy(part[0]["post_loglik"]).shape == (2,)
        resumed = run_ranks(2, _resumable, mode, path, None, True)
        for r in range(2):
            for k in HIST + ("newton_iters",):
                assert torch.equal(resumed[r][k], full[r][k]), (mode, r, k)
        if mode == "batch":
            with np.load(path) as blob:
                assert blob["warm"].shape == (16, 2, 30)
                assert blob["extra_hist_nwi"].shape == (4, 16)


def _paths(rank, world):
    return {
        "banded": _sharded(rank, world, dict(time_block=6), init={**INIT, "tau": BANDED_TAU}),
        "vi": _sharded(rank, world, dict(inference_method="variational", vi_maxiter=60,
                                         vi_solver="lbfgs")),
        "f32": _sharded(rank, world, dict(online_update="hess"), dtype=torch.float32),
    }


def test_sharded_online_banded_vi_f32():
    """The banded E-step and tau M-step (blocks of 6 bins), the L-BFGS dual
    variational E-step and the f32 fast mode, each on two ranks: the ranks
    bit-equal, each held to its one-process fit."""
    outs = run_ranks(2, _paths)
    for name in outs[0]:
        _same_on_ranks([o[name] for o in outs])
    got = outs[0]
    _held(got["banded"], _single(dict(time_block=6), init={**INIT, "tau": BANDED_TAU}))
    one = _single(dict(inference_method="variational", vi_maxiter=60, vi_solver="lbfgs"))
    pg, pw = npy(got["vi"]["post_loglik"]), npy(one["post_loglik"])
    assert abs(pg[0] - pw[0]) <= PLL0_REL * abs(pw[0])
    np.testing.assert_allclose(pg, pw, rtol=VI_REL)
    np.testing.assert_allclose(npy(got["vi"]["var_lower_bound"]), npy(one["var_lower_bound"]),
                               rtol=VI_REL)
    np.testing.assert_allclose(npy(got["vi"]["C_seq"]), npy(one["C_seq"]), atol=VI_C_TOL)
    one = _single(dict(online_update="hess"), dtype=torch.float32)
    pg, pw = npy(got["f32"]["post_loglik"]), npy(one["post_loglik"])
    assert got["f32"]["C_seq"].dtype == torch.float32
    assert abs(pg[0] - pw[0]) <= PLL0_REL * abs(pw[0])
    np.testing.assert_allclose(pg, pw, rtol=0, atol=F32_PLL_ENV)
    np.testing.assert_allclose(npy(got["f32"]["tau_seq"]), npy(one["tau_seq"]), rtol=0,
                               atol=F32_TAU_ENV)
