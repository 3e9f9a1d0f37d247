"""Batch and online EM (PyTorch port of ``pgpfa/em/fit.py``).

:func:`fit` runs the EM loop in Python on one device: E-step = the
trial-batched Laplace Newton solve or the dual variational solve, M-step =
the per-neuron (C, d) Newton and the per-latent timescale Newton.
:func:`fit_loop` is the same loop with checkpoint and resume, ``stop_after``
and per-iteration timing; :func:`fit` calls it without them.

Batch EM: iteration 0 starts the E-step cold (zero modes, or zero ``rho``
with the cold budget ``vi_maxiter``); each later iteration warm-starts from
the secant extrapolation ``2 w_n - w_{n-1}`` of the two previous solutions,
as ``_fit_scan`` does.

Online EM: each iteration runs a cold E-step on a minibatch of trials and
one of the six update rules of ``_online_mstep``: three mix the full
M-step's result into the old parameters, three (``'diag'``, ``'hess'``,
``'grad'``) take a proximal or damped Newton step from them.

:class:`PPGPFAfit` is the reference-compatible class driver over the same
E- and M-steps, with host-side histories, per-phase timing and the fit
diagnostics.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from pgpfa_torch.convert import params_from_numpy, to_numpy
from pgpfa_torch.data.init import initialize_params
from pgpfa_torch.data.synthetic import stack_experiment
from pgpfa_torch.infer.laplace import InfRes, laplace_estep_from_arrays
from pgpfa_torch.infer.laplace_longt import BandedInfRes, laplace_estep_banded
from pgpfa_torch.infer.variational import SOLVERS, vi_estep_from_arrays
from pgpfa_torch.infer.variational_longt import vi_estep_banded
from pgpfa_torch.learn.mstep_gp import learn_tau, learn_tau_banded
from pgpfa_torch.learn.mstep_obs import (
    c_only_cost,
    c_only_grad_hess,
    cd_cost,
    cd_cost_sum,
    learn_cd,
    learn_cd_newton,
    neuron_grad_hess,
    update_d_closed_form,
)
from pgpfa_torch.models.params import Params, pack_cd
from pgpfa_torch.ops.blockmat import solve_psd_mixed
from pgpfa_torch.utils.io import load_checkpoint, save_checkpoint
from pgpfa_torch.utils.optim import minimize_lbfgs
from pgpfa_torch.utils.reduce import Reduce, gathered, summed_over_ranks, trial_count

BATCH = "batch"
ONLINE = "online"
ONLINE_UPDATE_METHODS = (
    "balancingGamma",
    "sequentialAverage",
    "fullyUpdateAll",
    "hess",
    "diag",
    "grad",
)
_MIXING = {"balancingGamma", "sequentialAverage", "fullyUpdateAll"}


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Fit configuration: the batch- and online-EM fields of
    ``pgpfa.em.fit.FitConfig`` with the same names and defaults, except
    ``vi_solver``.

    ``vi_solver`` is ``'newton'`` (the default) or ``'lbfgs'``. The JAX
    package's default ``'auto'`` picks by trial count to avoid a crash of its
    TPU worker, and at the Stevenson width picks Newton; there is no such
    crash on the card, so the port takes the solver as given and ``'auto'``
    raises.

    ``time_block`` (bins; ``None`` for the dense path) selects the banded
    long-trial E-steps and tau M-step: it must divide T and satisfy
    ``time_block * bin >~ 6 max(tau)``. The banded Laplace E-step runs
    ``banded_newton_iters`` Newton bodies; the banded variational E-step
    always uses L-BFGS. In f32 the banded path's block inverses are the
    symmetrized f32 inverses, with no Newton-Schulz step.
    """

    inference_method: str = "laplace"
    em_mode: str = BATCH
    max_em_iter: int = 50
    batch_size: int = 5  # online minibatch (trials)
    online_update: str = "diag"  # one of ONLINE_UPDATE_METHODS
    step_pow: float = 0.75  # online step size 1 / (n + 1)^step_pow
    update_cd_jointly: bool = True  # online: joint (C, d), else closed-form d and C alone
    fully_update_tau: bool = False  # online mixing rules: take the un-mixed tau
    newton_gtol: float = 1e-8
    newton_maxiter: int = 100
    cd_maxiter: int = 500  # L-BFGS budget of the online C-only path
    cd_newton_iters: int = 8  # per-neuron Newton steps per M-step
    cd_tol: float = 1e-9
    tau_maxiter: int = 6
    vi_maxiter: int = 150  # dual-solve budget of the cold first E-step
    vi_maxiter_warm: int = 100  # and of the warm-started ones after it
    vi_gtol: float = 1e-8
    vi_solver: str = "newton"
    eps_noise: float = 0.001
    time_block: Optional[int] = None  # banded long-trial path: block size in bins
    banded_newton_iters: int = 12

    def __post_init__(self):
        if self.inference_method not in ("laplace", "variational"):
            raise ValueError(f"unknown inference_method {self.inference_method!r}")
        if self.vi_solver not in SOLVERS:
            raise ValueError(f"unknown vi_solver {self.vi_solver!r}; choose 'newton' or 'lbfgs'")
        if self.em_mode not in (BATCH, ONLINE):
            raise ValueError(f"unknown em_mode {self.em_mode!r}")
        if self.online_update not in ONLINE_UPDATE_METHODS:
            raise ValueError(f"unknown online_update {self.online_update!r}")


class FitResult(NamedTuple):
    """History of a fit. Leading axis of the sequences = EM iteration."""

    C: torch.Tensor  # final (ydim, xdim)
    d: torch.Tensor  # final (ydim,)
    tau: torch.Tensor  # final (xdim,)
    C_seq: torch.Tensor  # (iters, ydim, xdim) params AFTER each M-step
    d_seq: torch.Tensor
    tau_seq: torch.Tensor
    post_loglik: torch.Tensor  # (iters,)
    var_lower_bound: torch.Tensor  # (iters,) zeros for laplace
    cd_cost: torch.Tensor  # (iters,)
    tau_cost: torch.Tensor  # (iters, xdim)
    cd_grad_norm: torch.Tensor  # (iters,)
    cd_niter: torch.Tensor  # (iters,)
    tau_niter: torch.Tensor  # (iters, xdim)
    # (iters, R) E-step Newton counts; online (iters, batch_size), -1 at the
    # rows that other processes hold (fit_loop's reduce)
    newton_iters: torch.Tensor
    # (iters,) host seconds per iteration, NaN for those restored from a
    # checkpoint; only with fit_loop(record_iter_sec=True)
    iter_sec: Optional[torch.Tensor] = None


def _estep(C, d, tau, Y, T, bin_size_ms, warm, cfg: FitConfig, reduce: Reduce = None):
    """E-step of either method, dense or banded (``cfg.time_block``);
    returns ``(inf, post_loglik, vlb, warm_new)``. ``warm is None`` marks
    the cold first E-step, which for variational inference takes the cold
    budget ``vi_maxiter``. ``reduce`` (sums over ranks) makes the nPLL and
    the bound means over the trials of all ranks."""
    vi_maxiter = cfg.vi_maxiter if warm is None else cfg.vi_maxiter_warm
    if cfg.inference_method == "laplace":
        if cfg.time_block is not None:
            inf, pll = laplace_estep_banded(
                C, d, tau, Y, T, bin_size_ms, cfg.time_block,
                x_init=warm, maxiter=cfg.banded_newton_iters, eps_noise=cfg.eps_noise,
                reduce=reduce)
            return inf, pll, torch.zeros_like(pll), inf.post_mean
        inf, pll = laplace_estep_from_arrays(
            C, d, tau, Y, T, bin_size_ms,
            x_init=warm, gtol=cfg.newton_gtol, maxiter=cfg.newton_maxiter,
            compute_cov=False, eps_noise=cfg.eps_noise, reduce=reduce,
        )
        return inf, pll, torch.zeros_like(pll), inf.post_mean
    if cfg.time_block is not None:
        return vi_estep_banded(
            C, d, tau, Y, T, bin_size_ms, cfg.time_block,
            rho_init=warm, maxiter=vi_maxiter, eps_noise=cfg.eps_noise, reduce=reduce)
    return vi_estep_from_arrays(
        C, d, tau, Y, T, bin_size_ms,
        rho_init=warm, gtol=cfg.vi_gtol, maxiter=vi_maxiter,
        compute_cov=False, eps_noise=cfg.eps_noise, solver=cfg.vi_solver, reduce=reduce,
    )


def _learn_tau_from_inf(inf, tau, bin_size_ms, cfg: FitConfig, prior=None,
                        reduce: Reduce = None):
    """Tau M-step from dense or banded posterior moments. The banded one
    never forms the dense ``(xdim, T, T)`` PautoSum; its secant optimizer
    gets at least 12 iterations."""
    if isinstance(inf, BandedInfRes):
        return learn_tau_banded(inf.post_mean, inf.vsm_gp_diag, inf.vsm_gp_off, tau, bin_size_ms,
                                prior=prior, eps=cfg.eps_noise, maxiter=max(cfg.tau_maxiter, 12),
                                reduce=reduce)
    return learn_tau(inf.post_mean, inf.post_vsm_gp, tau, bin_size_ms, prior=prior,
                     eps=cfg.eps_noise, maxiter=cfg.tau_maxiter, reduce=reduce)


def _mstep_full(C, d, tau, Y, inf: InfRes, bin_size_ms, cfg: FitConfig, reduce: Reduce = None):
    """Unregularized M-step: (C, d) then tau, both from the E-step moments
    (of all ranks' trials with ``reduce``)."""
    cd = learn_cd(Y, inf.post_mean, inf.post_vsm, C, d, maxiter=cfg.cd_newton_iters,
                  reduce=reduce)
    return cd, _learn_tau_from_inf(inf, tau, bin_size_ms, cfg, reduce=reduce)


def _online_mstep(n: int, C, d, tau, Yb, inf: InfRes, bin_size_ms, cfg: FitConfig, P, cumH,
                  reduce: Reduce = None):
    """One online M-step after the E-step ``inf`` of the minibatch ``Yb``;
    ``n`` is the 0-based EM iteration. Returns ``(C', d', tau', P', cumH',
    cd_cost, tau_cost, full_tau, (cd_grad_norm, cd_niter, tau_niter))``.

    ``P`` is the prior precision and ``cumH`` the summed curvature of the
    ``'grad'`` rule (carried, read by nothing), both from :func:`_init_prior`.
    The step size is ``1 / (n + 1)^step_pow`` and the mixing weight of
    ``'balancingGamma'`` ``n / (max_em_iter - 1)``.

    With ``reduce`` (sums over ranks) ``Yb`` holds this rank's share of the
    minibatch, possibly none, and every statistic is a mean over the
    minibatch trials of all ranks; each prior or penalty term is added once,
    after the reduce, so ``P`` and ``cumH`` stay the same on every rank.
    """
    method = cfg.online_update
    gamma = n / max(cfg.max_em_iter - 1, 1)
    stepsize = 1.0 / (n + 1.0) ** cfg.step_pow

    if method in _MIXING:
        cd, tr = _mstep_full(C, d, tau, Yb, inf, bin_size_ms, cfg, reduce)
        mix = {"balancingGamma": gamma, "sequentialAverage": 0.5, "fullyUpdateAll": 0.0}[method]
        newC = mix * C + (1.0 - mix) * cd.C
        newd = mix * d + (1.0 - mix) * cd.d
        newtau = mix * tau + (1.0 - mix) * tr.tau
        details = (cd.grad_norm, cd.niter, tr.niter)
        return newC, newd, newtau, P, cumH, cd.cost, tr.cost, tr.tau, details

    tr = _learn_tau_from_inf(inf, tau, bin_size_ms, cfg, prior=(tau, stepsize), reduce=reduce)
    means, vsms = inf.post_mean, inf.post_vsm
    one = torch.ones((), dtype=torch.int32, device=C.device)
    if cfg.update_cd_jointly:
        # per-neuron (q, q) blocks: the joint Hessian is block-diagonal per neuron
        theta_old = torch.cat([C, d[:, None]], dim=1)
        eye_q = torch.eye(theta_old.shape[1], dtype=C.dtype, device=C.device)
        if method == "grad":  # one damped Newton step
            g, Hb = neuron_grad_hess(theta_old, Yb, means, vsms, reduce)
            theta_new = theta_old - stepsize * solve_psd_mixed(Hb + 1e-10 * eye_q, g)
            newC, newd = theta_new[:, :-1], theta_new[:, -1]
            cost = cd_cost(pack_cd(newC, newd), Yb, means, vsms, reduce)
            cumH = cumH + Hb
            cd_gnorm, cd_niter = g.abs().amax(), one
        else:
            if method == "diag":
                P = (eye_q / stepsize**2).expand(P.shape)
            else:  # 'hess': the accumulated exact curvature is the prior precision
                P = neuron_grad_hess(theta_old, Yb, means, vsms, reduce)[1] + P
            cd = learn_cd_newton(Yb, means, vsms, C, d, prior_blocks=(P, theta_old),
                                 n_iter=cfg.cd_newton_iters, reduce=reduce)
            newC, newd, cost = cd.C, cd.d, cd.cost
            cd_gnorm, cd_niter = cd.grad_norm, cd.niter
    else:
        # closed-form d, then C alone in vC = C.T.reshape(-1) order
        newd = update_d_closed_form(Yb, means, vsms, C, reduce)
        vC_old = C.T.reshape(-1)
        eye = torch.eye(vC_old.shape[0], dtype=C.dtype, device=C.device)
        if method == "grad":
            g, H = c_only_grad_hess(vC_old, newd, Yb, means, vsms, reduce)
            vC_new = vC_old - stepsize * solve_psd_mixed(H + 1e-10 * eye, g)
            cumH = cumH + H
            cd_gnorm, cd_niter = g.abs().amax(), one
        else:
            if method == "diag":
                P = eye / stepsize**2
            else:
                P = c_only_grad_hess(vC_old, newd, Yb, means, vsms, reduce)[1] + P
            if reduce is None:
                def data_cost(v):
                    return c_only_cost(v, newd, Yb, means, vsms)
            else:
                # every rank must take the same L-BFGS steps (it reads back
                # each evaluation): the local share, divided by the global
                # count, and its gradient are summed in one collective
                num = trial_count(Yb.shape[0], C, reduce)
                data_cost = summed_over_ranks(
                    lambda v: cd_cost_sum(torch.cat([v, newd]), Yb, means, vsms) / num, reduce)

            def fun(v):
                dv = v - vC_old
                return data_cost(v) + 0.5 * dv @ (P @ dv)

            res = minimize_lbfgs(fun, vC_old, maxiter=cfg.cd_maxiter, tol=cfg.cd_tol)
            vC_new, cd_gnorm, cd_niter = res.x, res.grad_norm, res.niter
        newC = vC_new.reshape(C.shape[1], C.shape[0]).T
        cost = c_only_cost(vC_new, newd, Yb, means, vsms, reduce)  # without the penalty

    details = (cd_gnorm, cd_niter, tr.niter)
    return newC, newd, tr.tau, P, cumH, cost, tr.cost, tr.tau, details


def _init_prior(cfg: FitConfig, xdim: int, ydim: int, like: torch.Tensor) -> torch.Tensor:
    """Initial prior precision (and summed curvature): identity blocks
    ``(ydim, xdim+1, xdim+1)`` for the joint (C, d) update, a dense
    ``eye(xdim*ydim)`` for the C-only one."""
    if cfg.update_cd_jointly:
        q = xdim + 1
        return torch.eye(q, dtype=like.dtype, device=like.device).expand(ydim, q, q)
    return torch.eye(xdim * ydim, dtype=like.dtype, device=like.device)


def draw_batch_indices(R: int, batch_size: int, n_iter: int, seed: int = 0) -> torch.Tensor:
    """The online minibatch stream ``(n_iter, batch_size)`` that :func:`fit`
    draws without ``batch_indices``: ``batch_size`` distinct trials per
    iteration, each row the head of one ``torch.randperm(R)`` from a CPU
    generator seeded with ``seed``, so the stream is the same on every
    device. (The JAX package draws with ``jax.random.choice``; its streams
    differ from these.)"""
    if not 0 < batch_size <= R:
        raise ValueError(f"batch_size {batch_size} must be in [1, {R}]")
    gen = torch.Generator().manual_seed(seed)
    return torch.stack([torch.randperm(R, generator=gen)[:batch_size] for _ in range(n_iter)])


def _minibatches(R: int, cfg: FitConfig, seed: int, batch_indices, start: int, end: int,
                 device) -> torch.Tensor:
    """The minibatch rows of online iterations ``start .. end - 1``: drawn
    (the rows of ``draw_batch_indices(R, batch_size, end, seed)``) or
    ``batch_indices[n]``, checked and put on ``device`` once."""
    if batch_indices is None:
        idx = draw_batch_indices(R, cfg.batch_size, end, seed)[start:]
    else:
        idx = torch.stack([torch.as_tensor(batch_indices[n]).reshape(-1).to(torch.int64)
                           for n in range(start, end)])
        if not bool(((idx >= 0) & (idx < R)).all()):
            raise ValueError(f"batch_indices must lie in [0, {R})")
    return idx.to(device)


# The per-iteration history, in FitResult's order, under the names of the
# JAX package's checkpoints (extra_hist_<name>); the last three are counts.
_HIST_KEYS = ("C", "d", "tau", "pll", "vlb", "cdc", "tc", "cgn", "cni", "tni", "nwi")
_N_FLOAT_HIST = 8


def _save(path, C, d, tau, em_iter, warm, warm_prev, P, cumH, seed, rows):
    """Write the full resumable state (``pgpfa.em.fit.fit_loop``'s keys, the
    port's minibatch seed under ``torch_batch_seed``)."""
    extra = {"P": to_numpy(P), "cumH": to_numpy(cumH), "torch_batch_seed": seed}
    if warm_prev is not None:
        extra["warm_prev"] = to_numpy(warm_prev)
    for i, k in enumerate(_HIST_KEYS):
        extra["hist_" + k] = np.stack([to_numpy(r[i]) for r in rows])
    save_checkpoint(path, {"C": to_numpy(C), "d": to_numpy(d), "tau": to_numpy(tau)},
                    em_iter=em_iter, warm=None if warm is None else to_numpy(warm), extra=extra)


def fit(
    init_params,
    Y,
    bin_size_ms: float,
    config: Optional[FitConfig] = None,
    device="cuda",
    dtype=torch.float64,
    seed: int = 0,
    batch_indices=None,
) -> FitResult:
    """Run a batch or online EM fit (Laplace or dual variational E-step).

    Args:
        init_params: dict ``{'C','d','tau'}`` of arrays, or :class:`Params`
            (then its tensors' device and dtype are used as they are).
        Y: spike counts ``(R, ydim, T)`` (array or tensor).
        bin_size_ms: bin width in milliseconds.
        config: :class:`FitConfig` (defaults to batch Laplace EM;
            ``inference_method="variational"`` for the dual variational
            E-step, ``em_mode="online"`` for online EM).
        device, dtype: where and in what precision the fit runs:
            ``torch.float64``, or ``torch.float32`` for the f32 fast mode
            (the JAX package's ``PGPFA_X64=0``: the whole EM in f32, f32
            factors used without refinement, f32-calibrated tolerances).
            The default is the card, which runs the CUDA kernels;
            there is no fallback to the CPU. Pass ``device="cpu"`` to run
            the kernels' plain PyTorch versions on the CPU.
        seed: online EM: the seed of the minibatch stream
            (:func:`draw_batch_indices`; its draws differ from the JAX
            package's ``jax.random`` ones).
        batch_indices: online EM: the minibatch of each iteration instead of
            drawn ones; iteration ``n`` uses the trials ``batch_indices[n]``,
            as ``pgpfa.em.fit.fit_loop(batch_indices=...)``.
    """
    return fit_loop(init_params, Y, bin_size_ms, config, device, dtype, seed, batch_indices)


def fit_loop(
    init_params,
    Y,
    bin_size_ms: float,
    config: Optional[FitConfig] = None,
    device="cuda",
    dtype=torch.float64,
    seed: int = 0,
    batch_indices=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 10,
    resume_from: Optional[str] = None,
    stop_after: Optional[int] = None,
    record_iter_sec: bool = False,
    reduce: Reduce = None,
    trial_offset: int = 0,
    write_checkpoint: bool = True,
) -> FitResult:
    """:func:`fit` with checkpoint and resume (``pgpfa.em.fit.fit_loop``);
    :func:`fit` is this loop without them.

    Args (beyond :func:`fit`'s):
        checkpoint_path: write the full resumable state there every
            ``checkpoint_every`` iterations and at the last one (the
            ``.npz`` of :func:`pgpfa_torch.utils.io.save_checkpoint`):
            parameters, the warm start and the one before it, the EM
            iteration, the online ``P`` and ``cumH``, the seed of the drawn
            minibatch stream (``torch_batch_seed``; the stream of iteration
            ``n`` depends only on it and ``n``) and every iteration's history.
        resume_from: a checkpoint of either package to continue from; the
            result equals the uninterrupted fit's, history included. A port
            checkpoint's minibatch seed replaces ``seed``. An online
            checkpoint of the JAX package carries a ``jax.random`` key,
            which cannot be replayed: it resumes only with ``batch_indices``
            (else ``ValueError``). A checkpoint without ``warm_prev`` (an
            older format) resumes with a plain warm start.
        stop_after: end after that many EM iterations (counted from 0, not
            from the resume point); the histories cover the completed ones.
        record_iter_sec: time each iteration on the host clock, closed by a
            ``torch.cuda.synchronize()`` on the card; ``FitResult.iter_sec``,
            NaN for iterations restored from a checkpoint.
        reduce: EM over the trials of several processes, ``Y`` holding this
            one's: a callable that sums a tensor over all of them
            (:mod:`pgpfa_torch.parallel` passes one). Every trial sum of the
            E-steps and M-steps goes through it, so every process computes
            the same parameters. Batch EM: ``newton_iters`` covers the local
            trials. Online EM: the minibatch stream (drawn from ``seed``, or
            ``batch_indices``) numbers the trials of all processes, which
            every process must draw or pass alike; each process E-steps the
            rows of each minibatch that it holds, possibly none, and
            ``newton_iters`` is ``(iters, batch_size)`` with -1 at the rows
            other processes hold. A checkpoint holds the warm starts and
            Newton counts of all processes' trials, laid out as a
            one-process fit's: every process takes part in gathering it and
            restores its own share on resume.
        trial_offset: with ``reduce``, the global number of ``Y``'s first
            trial: the processes' trials, in rank order, are the global
            trials ``0 .. R_all - 1``.
        write_checkpoint: with ``reduce``, whether this process writes
            ``checkpoint_path`` (one process does; :mod:`pgpfa_torch.parallel`
            has rank 0 write it). No process goes on before it is written.
    """
    cfg = config or FitConfig()
    p = init_params if isinstance(init_params, Params) else params_from_numpy(
        init_params, device, dtype)
    Y = torch.as_tensor(Y, dtype=p.C.dtype, device=p.C.device)
    R, ydim, T = Y.shape
    bin_size_ms = float(bin_size_ms)
    like = dict(dtype=p.C.dtype, device=p.C.device)
    C, d, tau = p.C, p.d, p.tau
    warm = warm_prev = None
    P = cumH = _init_prior(cfg, C.shape[1], ydim, C)
    # the global trial numbering: the online stream's and the checkpoint's
    R_all = R if reduce is None else int(trial_count(R, C, reduce))
    mine = slice(trial_offset, trial_offset + R)
    rows, start = [], 0
    if resume_from is not None:
        state = load_checkpoint(resume_from)
        extra = state["extra"]
        C, d, tau = (torch.tensor(state["params"][k], **like) for k in ("C", "d", "tau"))
        d, tau = d.reshape(-1), tau.reshape(-1)
        start = state["em_iter"]
        if state["warm"] is not None:
            warm = torch.tensor(state["warm"][mine], **like)
        # an older checkpoint has no warm_prev: a plain warm start then
        warm_prev = (torch.tensor(extra["warm_prev"][mine], **like) if "warm_prev" in extra
                     else warm)
        if "P" in extra:
            P, cumH = torch.tensor(extra["P"], **like), torch.tensor(extra["cumH"], **like)
        if cfg.em_mode == ONLINE and batch_indices is None:
            if "torch_batch_seed" in extra:
                seed = int(extra["torch_batch_seed"])
            elif state["rng_key"] is not None:
                raise ValueError("this online checkpoint's minibatch stream is a jax.random key, "
                                 "which the port cannot replay: pass batch_indices")
        if "hist_pll" in extra:
            hist = [torch.tensor(extra["hist_" + k], **like) if i < _N_FLOAT_HIST else
                    torch.tensor(extra["hist_" + k], dtype=torch.int32, device=C.device)
                    for i, k in enumerate(_HIST_KEYS)]
            rows = [tuple(h[i] for h in hist) for i in range(start)]
    end = cfg.max_em_iter if stop_after is None else min(int(stop_after), cfg.max_em_iter)
    if cfg.em_mode == ONLINE and max(start, end) > 0:
        # every process draws the whole stream and E-steps the rows it holds
        idx = _minibatches(R_all, cfg, seed, batch_indices, 0, max(start, end), "cpu")
        held = (idx >= trial_offset) & (idx < trial_offset + R)
        # each iteration's local trials and their places in the minibatch, moved once
        batches = [((b[h] - trial_offset).to(Y.device), h.nonzero()[:, 0].to(Y.device))
                   for b, h in zip(idx[start:end], held[start:end])]
    if rows:  # the checkpoint's Newton counts are all processes': keep this one's
        if cfg.em_mode == BATCH:
            rows = [r[:-1] + (r[-1][mine],) for r in rows]
        else:
            rows = [r[:-1] + (torch.where(h.to(Y.device), r[-1], -1),)
                    for r, h in zip(rows, held)]
    times = [math.nan] * start if record_iter_sec else None

    def checkpoint(em_iter):
        # the warm starts and the Newton counts of all processes' trials
        w, wp = (None if x is None else gathered(x, trial_offset, R_all, reduce)
                 for x in (warm, warm_prev))
        nwi = torch.stack([r[-1] for r in rows])
        if reduce is not None:
            nwi = (reduce(nwi + 1) - 1 if cfg.em_mode == ONLINE else
                   gathered(nwi.T, trial_offset, R_all, reduce).T)
        if write_checkpoint:
            _save(checkpoint_path, C, d, tau, em_iter, w, wp, P, cumH, seed,
                  [r[:-1] + (h,) for r, h in zip(rows, nwi)])
        if reduce is not None:  # read back: no process goes on before the file is written
            float(reduce(C.new_zeros(1))[0])

    for n in range(start, end):
        t0 = time.perf_counter()
        if cfg.em_mode == BATCH:
            # the secant warm start 2 w_n - w_{n-1} (2 w - w = w at iteration 1)
            ex = None if warm is None else 2.0 * warm - warm_prev
            inf, pll, vlb, warm_new = _estep(C, d, tau, Y, T, bin_size_ms, ex, cfg, reduce)
            cd, tr = _mstep_full(C, d, tau, Y, inf, bin_size_ms, cfg, reduce)
            C, d, tau = cd.C, cd.d, tr.tau
            warm_prev = warm_new if warm is None else warm
            warm = warm_new
            row = (C, d, tau, pll, vlb, cd.cost, tr.cost, cd.grad_norm, cd.niter, tr.niter)
            nwi = inf.newton_iters
        else:
            local, pos = batches[n - start]
            Yb = Y.index_select(0, local)
            # cold E-step: a new minibatch
            inf, pll, vlb, _ = _estep(C, d, tau, Yb, T, bin_size_ms, None, cfg, reduce)
            C, d, newtau, P, cumH, cost, tcost, full_tau, det = _online_mstep(
                n, C, d, tau, Yb, inf, bin_size_ms, cfg, P, cumH, reduce)
            tau = full_tau if cfg.fully_update_tau else newtau
            row = (C, d, tau, pll, vlb, cost, tcost, *det)
            nwi = torch.full((held.shape[1],), -1, dtype=torch.int32, device=Y.device)
            nwi.index_copy_(0, pos, inf.newton_iters.to(torch.int32))
        rows.append(row[:_N_FLOAT_HIST] + tuple(
            c.to(torch.int32) for c in row[_N_FLOAT_HIST:] + (nwi,)))
        if record_iter_sec:
            if C.is_cuda:
                torch.cuda.synchronize(C.device)
            times.append(time.perf_counter() - t0)
        if checkpoint_path is not None and ((n + 1) % checkpoint_every == 0 or n + 1 == end):
            checkpoint(n + 1)

    seq = [torch.stack(col) for col in zip(*rows)]
    C_seq, d_seq, tau_seq, pll, vlb, cdc, tc, cgn, cni, tni, nwi = seq
    return FitResult(
        C=C_seq[-1], d=d_seq[-1], tau=tau_seq[-1],
        C_seq=C_seq, d_seq=d_seq, tau_seq=tau_seq,
        post_loglik=pll, var_lower_bound=vlb, cd_cost=cdc, tau_cost=tc,
        cd_grad_norm=cgn, cd_niter=cni, tau_niter=tni, newton_iters=nwi,
        iter_sec=None if times is None else torch.tensor(times, dtype=torch.float64),
    )


# --------------------------------------------------------------------------
# reference-compatible class driver
# --------------------------------------------------------------------------


class PPGPFAfit:
    """Poisson-GPFA fit with the reference's call pattern and attribute
    surface (``pgpfa.em.fit.PPGPFAfit``): construction runs the fit.

    Each iteration is :func:`fit_loop`'s E-step and M-step (batch EM with its
    secant warm start ``2 w_n - w_{n-1}``; online EM with a cold E-step on
    each minibatch), timed on the host clock: ``inferenceTime`` ends after a
    readback of the E-step's nPLL and ``learningTime`` after one of the new
    parameters, so the card has finished each phase. Online minibatches are
    the rows of ``draw_batch_indices(R, batchSize, maxEMiter, seed)``, the
    stream of :func:`fit` with that seed (not the JAX package's
    ``jax.random`` draws); ``seenTrialIdx`` records them.

    ``device`` and ``dtype`` are :func:`fit`'s: the card unless the caller
    passes ``device="cpu"``. The histories (``paramSeq``,
    ``learningDetails``, ...) are NumPy; ``_inf`` is the last E-step's
    :class:`~pgpfa_torch.infer.laplace.InfRes` on ``device``, and ``infRes``
    its reference-layout NumPy copy.
    """

    def __init__(
        self,
        experiment,
        initParams=None,
        xdim: int = 2,
        inferenceMethod: str = "laplace",
        maxEMiter: int = 50,
        optimLogLamb: bool = False,
        CdOptimMethod: str = "TNC",
        tauOptimMethod: str = "TNC",
        EMmode: str = "Batch",
        batchSize: int = 5,
        onlineParamUpdateMethod: str = "diag",
        hessTol=None,
        stepPow: float = 0.75,
        updateCdJointly: bool = True,
        fullyUpdateTau: bool = False,
        extractAllTraj: bool = False,
        extractAllTraj_trueParams: bool = False,
        getPredictionErr: bool = False,
        CdMaxIter=None,
        tauMaxIter=None,
        seed: int = 0,
        verbose: bool = False,
        config: Optional[FitConfig] = None,
        device="cuda",
        dtype=torch.float64,
    ):
        # The reference's optimizer options have no counterpart here: the
        # M-steps are exact-derivative Newton solvers, the dual is optimized
        # in rho = log(lambda) and curvature is analytic. They warn.
        import warnings

        for nm, val in (("CdOptimMethod", CdOptimMethod), ("tauOptimMethod", tauOptimMethod)):
            if val != "TNC":
                warnings.warn(
                    f"{nm}={val!r} is a scipy optimizer name; pgpfa_torch's M-steps are "
                    "exact-derivative Newton solvers and ignore it", stacklevel=2)
        if inferenceMethod == "variational" and not optimLogLamb:
            warnings.warn(
                "optimLogLamb=False (the reference's bounded-lambda L-BFGS-B dual) is not "
                "available: pgpfa_torch optimizes the dual in rho = log(lambda), the "
                "reference's optimLogLamb=True variant", stacklevel=2)
        if hessTol is not None:
            warnings.warn("hessTol is ignored: pgpfa_torch uses exact analytic curvature, "
                          "not finite differences", stacklevel=2)
        self.experiment = experiment
        Y = stack_experiment(experiment)
        R, ydim, T = Y.shape
        if initParams is None:
            initParams = initialize_params(xdim, ydim, experiment, seed=seed)
        else:
            xdim = np.shape(initParams["C"])[1]

        extra_cfg = {}
        if CdMaxIter is not None:
            # an upper bound on the M-step's iterations: binds only below
            # the fixed Newton budget
            extra_cfg["cd_maxiter"] = int(CdMaxIter)
            extra_cfg["cd_newton_iters"] = max(min(int(CdMaxIter), FitConfig.cd_newton_iters), 1)
        if tauMaxIter is not None:
            extra_cfg["tau_maxiter"] = max(min(int(tauMaxIter), FitConfig.tau_maxiter), 1)
        cfg = config or FitConfig(
            inference_method=inferenceMethod,
            em_mode=EMmode.lower(),
            max_em_iter=maxEMiter,
            batch_size=batchSize,
            online_update=onlineParamUpdateMethod,
            step_pow=stepPow,
            update_cd_jointly=updateCdJointly,
            fully_update_tau=fullyUpdateTau,
            **extra_cfg,
        )
        self.config = cfg
        self.device, self.dtype = torch.device(device), dtype

        p = params_from_numpy(initParams, device, dtype)
        Yt = torch.as_tensor(Y, dtype=dtype, device=p.C.device)
        bin_size_ms = float(experiment.binSize)
        C, d, tau = p.C, p.d, p.tau
        warm = warm_prev = None
        P = cumH = _init_prior(cfg, xdim, ydim, C)
        if cfg.em_mode == ONLINE:
            idx = draw_batch_indices(R, cfg.batch_size, cfg.max_em_iter, seed)

        if verbose:
            from pgpfa_torch.utils.io import print_options_banner

            rows = [
                ("Dimensionality of Latent State", xdim),
                ("Dimensionality of Observed State (# neurons)", ydim),
                ("EM mode", "Batch" if cfg.em_mode == BATCH else "Online"),
                ("Max EM iterations", cfg.max_em_iter),
                ("Inference Method", cfg.inference_method),
            ]
            if cfg.em_mode == ONLINE:
                rows += [
                    ("Online Param Update Method", f"`{cfg.online_update}`"),
                    ("Batch size (trials)", cfg.batch_size),
                ]
            print_options_banner("Fit Options", rows)

        posteriorLikelihood, variationalLowerBound = [], []
        learningDetails, paramSeq = [], [dict(initParams)]
        inferenceTime, learningTime, seenTrialIdx = [], [], []
        for n in range(cfg.max_em_iter):
            t0 = time.perf_counter()
            if cfg.em_mode == BATCH:
                Yb = Yt
                ex = None if warm is None else 2.0 * warm - warm_prev
                inf, pll, vlb, warm_new = _estep(C, d, tau, Yb, T, bin_size_ms, ex, cfg)
                warm_prev = warm_new if warm is None else warm
                warm = warm_new
            else:
                seenTrialIdx.append(idx[n].numpy())
                Yb = Yt.index_select(0, idx[n].to(Yt.device))
                inf, pll, vlb, _ = _estep(C, d, tau, Yb, T, bin_size_ms, None, cfg)
            posteriorLikelihood.append(float(pll))  # the readback ends the E-step
            inferenceTime.append(time.perf_counter() - t0)
            if cfg.inference_method == "variational":
                variationalLowerBound.append(float(vlb))

            t0 = time.perf_counter()
            if cfg.em_mode == BATCH:
                cd, tr = _mstep_full(C, d, tau, Yb, inf, bin_size_ms, cfg)
                C, d, tau = cd.C, cd.d, tr.tau
                cd_c, tau_c, det = cd.cost, tr.cost, (cd.grad_norm, cd.niter, tr.niter)
            else:
                C, d, newtau, P, cumH, cd_c, tau_c, full_tau, det = _online_mstep(
                    n, C, d, tau, Yb, inf, bin_size_ms, cfg, P, cumH)
                tau = full_tau if cfg.fully_update_tau else newtau
            params_n = {"C": to_numpy(C), "d": to_numpy(d), "tau": to_numpy(tau)}
            learningTime.append(time.perf_counter() - t0)
            learningDetails.append({
                "Cd": float(cd_c), "tau": to_numpy(tau_c),
                "Cd_grad_norm": float(det[0]), "Cd_niter": int(det[1]),
                "tau_niter": to_numpy(det[2]),
                "inference_newton_iters": to_numpy(inf.newton_iters.to(torch.int32)),
            })
            paramSeq.append(params_n)
            if verbose:
                msg = f"Iteration: {n + 1:3d} of {cfg.max_em_iter:3d}, nPLL: = {float(pll):.4f}"
                if cfg.inference_method == "variational":
                    msg += f", VLB = {float(vlb):.4f}"
                print(msg)

        self.xdim, self.ydim, self.T, self.numTrials = xdim, ydim, T, R
        self.trialDur = getattr(experiment, "trialDur", T * bin_size_ms)
        self.binSize = bin_size_ms
        self.maxEMiter = cfg.max_em_iter
        self.EMmode = "Batch" if cfg.em_mode == BATCH else "Online"
        self.inferenceMethod = cfg.inference_method
        self.initParams = dict(initParams)
        self.paramSeq = paramSeq
        self.posteriorLikelihood = posteriorLikelihood
        self.variationalLowerBound = variationalLowerBound
        self.learningDetails = learningDetails
        self.optimParams = dict(paramSeq[-1])
        self.infRes = inf.to_reference_dict()
        self._inf = inf
        self.seenTrialIdx = seenTrialIdx
        self.learningTime = np.asarray(learningTime)
        self.inferenceTime = np.asarray(inferenceTime)
        self._Y = Y

        self.processParamResults()
        self.performSpikeCountAnalysis()
        if extractAllTraj:
            self.extractTrajectories()
        if extractAllTraj_trueParams:
            self.extractTrajWithTrueParams()
        if getPredictionErr:
            self.leaveOneOutPrediction()

    # -- post-processing (NumPy, on the host) ---------------------------------

    def processParamResults(self):
        """Per-iteration spike-count, subspace and magnitude diagnostics of
        ``paramSeq[0 .. maxEMiter-1]`` (the init and the first
        ``maxEMiter - 1`` iterates, as the reference indexes them)."""
        from pgpfa_torch.diag.metrics import subspace_angle

        it = self.maxEMiter
        self.tauSeq = np.stack([self.paramSeq[i]["tau"] for i in range(it)], axis=1)
        est = np.zeros((self.ydim, it))
        for i in range(it):
            Ci, di = self.paramSeq[i]["C"], self.paramSeq[i]["d"]
            est[:, i] = self.T * np.exp(0.5 * np.diag(Ci @ Ci.T) + di)
        self.expectedSpikeCountsEst = est
        self.expectedSpikeCountsEstVar = est.var(axis=0)
        self.sampleMeanSpikeCounts = self._Y.sum(axis=2).mean(axis=0)
        self.sampleMeanSpikeCountsVar = float(np.var(self.sampleMeanSpikeCounts))
        self.meanSquaredErrorOverTrueVariance_SM = [
            float(np.sum((est[:, i] - self.sampleMeanSpikeCounts) ** 2)
                  / self.numTrials / self.sampleMeanSpikeCountsVar)
            for i in range(it)
        ]
        self.varESpkCountSampleMean_Ratios = (
            self.expectedSpikeCountsEstVar / self.sampleMeanSpikeCountsVar)
        if hasattr(self.experiment, "params"):
            Ct = self.experiment.params["C"]
            dt = np.ravel(self.experiment.params["d"])
            true_est = self.T * np.exp(0.5 * np.diag(Ct @ Ct.T) + dt)
            self.expectedSpikeCountsTrue = true_est
            self.expectedSpikeCountsTrueVar = float(np.var(true_est))
            self.varESpkCountTrue_Ratios = (
                self.expectedSpikeCountsEstVar / self.expectedSpikeCountsTrueVar)
            self.subspaceAngleC = [subspace_angle(Ct, self.paramSeq[i]["C"]) for i in range(it)]
        self.CabsoluteValue = np.asarray([np.sum(self.paramSeq[i]["C"] ** 2) for i in range(it)])

    def performSpikeCountAnalysis(self):
        """Model-implied spike-count mean and covariance at the init, the
        optimum and (simulated data) the truth, against the observed ones."""
        from pgpfa_torch.diag.metrics import js_logdet_div, mean_cov_y_from_params

        ey_i, eyy_i = mean_cov_y_from_params(self.initParams)
        ey_o, eyy_o = mean_cov_y_from_params(self.optimParams)
        raster = np.concatenate([self._Y[r] for r in range(self.numTrials)], axis=1)
        ey_obs = raster.mean(axis=1)
        eyy_obs = np.cov(raster)
        self.E_y_init_params, self.E_yy_init_params = ey_i, eyy_i
        self.E_y_optim_params, self.E_yy_optim_params = ey_o, eyy_o
        self.E_y_obs, self.E_yy_obs = ey_obs, eyy_obs
        nrm = np.linalg.norm(eyy_obs)
        self.mean_err_optim_obs = float(np.sum((ey_obs - ey_o) ** 2) / np.var(ey_obs)
                                        / self.numTrials)
        self.mean_err_init_obs = float(np.sum((ey_obs - ey_i) ** 2) / np.var(ey_obs)
                                       / self.numTrials)
        self.cov_err_optim_obs = float(np.linalg.norm(eyy_obs - eyy_o) / nrm)
        self.cov_err_init_obs = float(np.linalg.norm(eyy_obs - eyy_i) / nrm)
        self.JSdiv_cov_optim_obs = js_logdet_div(eyy_o, eyy_obs)
        self.JSdiv_cov_init_obs = js_logdet_div(eyy_i, eyy_obs)
        if hasattr(self.experiment, "params"):
            ey_t, eyy_t = mean_cov_y_from_params(self.experiment.params)
            self.E_y_true_params, self.E_yy_true_params = ey_t, eyy_t
            self.mean_err_optim_true = float(np.sum((ey_t - ey_o) ** 2) / np.var(ey_t)
                                             / self.numTrials)
            self.mean_err_init_true = float(np.sum((ey_t - ey_i) ** 2) / np.var(ey_t)
                                            / self.numTrials)
            self.cov_err_optim_true = float(np.linalg.norm(eyy_t - eyy_o) / nrm)
            self.cov_err_init_true = float(np.linalg.norm(eyy_t - eyy_i) / nrm)
            self.JSdiv_cov_optim_true = js_logdet_div(eyy_o, eyy_t)
            self.JSdiv_cov_init_true = js_logdet_div(eyy_i, eyy_t)

    def orthonormalizeTrajectories(self):
        from pgpfa_torch.diag.metrics import orthonormalized_trajectories

        self.x_tilde = orthonormalized_trajectories(self.optimParams["C"],
                                                    to_numpy(self._inf.post_mean))

    def _estep_all(self, params, method):
        """A cold E-step of all trials at ``params`` on the fit's device."""
        p = params_from_numpy(params, self.device, self.dtype)
        cfg = self.config if method is None else dataclasses.replace(
            self.config, inference_method=method)
        Y = torch.as_tensor(self._Y, dtype=self.dtype, device=p.C.device)
        return _estep(p.C, p.d, p.tau, Y, self.T, float(self.binSize), None, cfg)

    def extractTrajectories(self, method: Optional[str] = None):
        """Re-infer all trials at the optimal parameters."""
        inf, pll, vlb, _ = self._estep_all(self.optimParams, method)
        self._inf = inf
        self.infRes = inf.to_reference_dict()
        self.nll_all_traj = float(pll)
        if self.inferenceMethod == "variational":
            self.vlb_all_traj = float(vlb)

    def extractTrajWithTrueParams(self, method: Optional[str] = None):
        """Infer all trials at the dataset's true parameters."""
        inf, pll, _, _ = self._estep_all(self.experiment.params, method)
        self.infRes_trueParams = inf.to_reference_dict()
        self.nll_trueParams_all_traj = float(pll)

    def leaveOneOutPrediction(self):
        """Leave-one-neuron-out predictions of all trials at the optimal
        parameters (``y_pred_mode``, ``pred_err_mode``)."""
        from pgpfa_torch.diag.loo import leave_one_out_prediction

        self.y_pred_mode, self.pred_err_mode = leave_one_out_prediction(
            self.optimParams, self._Y, float(self.binSize), self.device, self.dtype)

    # -- plots (matplotlib, imported when drawn) --------------------------------

    def plotTrajectory(self, trial: int = 0):
        from pgpfa_torch.diag.plotting import plot_fit_trajectory

        return plot_fit_trajectory(self, trial)

    def plotTrajectories(self):
        from pgpfa_torch.diag.plotting import plot_fit_trajectories

        return plot_fit_trajectories(self)

    def plotParamSeq(self):
        from pgpfa_torch.diag.plotting import plot_param_seq

        return plot_param_seq(self)

    def plotFitDetails(self):
        from pgpfa_torch.diag.plotting import plot_fit_details

        return plot_fit_details(self)

    def plotOptimParams(self):
        from pgpfa_torch.diag.plotting import plot_optim_params

        return plot_optim_params(self)

    def plotParamComparison(self):
        from pgpfa_torch.diag.plotting import plot_param_comparison

        return plot_param_comparison(self)

    def plotCovAnalysis(self):
        from pgpfa_torch.diag.plotting import plot_cov_analysis

        return plot_cov_analysis(self)

    def plotLNOprediction(self, trialToPlot: int = 0, neuronToPlot: int = 0):
        from pgpfa_torch.diag.plotting import plot_lno_prediction

        return plot_lno_prediction(self, trialToPlot, neuronToPlot)
