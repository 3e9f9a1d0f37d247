"""Batch EM (PyTorch port of the batch branch of ``pgpfa/em/fit.py``).

:func:`fit` runs the EM loop in Python on one device: E-step = the
trial-batched Laplace Newton solve or the dual variational solve, M-step =
the per-neuron (C, d) Newton and the per-latent timescale Newton. EM
iteration 0 starts the E-step cold (zero modes, or zero ``rho`` with the
cold budget ``vi_maxiter``); each later iteration warm-starts from the
secant extrapolation ``2 w_n - w_{n-1}`` of the two previous solutions, as
``_fit_scan`` does.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from pgpfa_torch.convert import params_from_numpy
from pgpfa_torch.infer.laplace import InfRes, laplace_estep_from_arrays
from pgpfa_torch.infer.variational import SOLVERS, vi_estep_from_arrays
from pgpfa_torch.learn.mstep_gp import learn_tau
from pgpfa_torch.learn.mstep_obs import learn_cd
from pgpfa_torch.models.params import Params

BATCH = "batch"
ONLINE = "online"


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Fit configuration: the batch-EM fields of ``pgpfa.em.fit.FitConfig``
    with the same names and defaults, except ``vi_solver``.

    ``vi_solver`` is ``'newton'`` (the default) or ``'lbfgs'``. The JAX
    package's default ``'auto'`` picks by trial count to avoid a crash of its
    TPU worker, and at the Stevenson width picks Newton; there is no such
    crash on the card, so the port takes the solver as given and ``'auto'``
    raises.
    """

    inference_method: str = "laplace"
    em_mode: str = BATCH
    max_em_iter: int = 50
    newton_gtol: float = 1e-8
    newton_maxiter: int = 100
    cd_newton_iters: int = 8  # per-neuron Newton steps per M-step
    tau_maxiter: int = 6
    vi_maxiter: int = 150  # dual-solve budget of the cold first E-step
    vi_maxiter_warm: int = 100  # and of the warm-started ones after it
    vi_gtol: float = 1e-8
    vi_solver: str = "newton"
    eps_noise: float = 0.001
    time_block: Optional[int] = None

    def __post_init__(self):
        if self.inference_method not in ("laplace", "variational"):
            raise ValueError(f"unknown inference_method {self.inference_method!r}")
        if self.vi_solver not in SOLVERS:
            raise ValueError(f"unknown vi_solver {self.vi_solver!r}; choose 'newton' or 'lbfgs'")
        if self.em_mode == ONLINE:
            raise NotImplementedError("online EM is not ported yet")
        if self.em_mode != BATCH:
            raise ValueError(f"unknown em_mode {self.em_mode!r}")
        if self.time_block is not None:
            raise NotImplementedError("the banded long-trial path (time_block) is not ported yet")


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
    newton_iters: torch.Tensor  # (iters, R) E-step Newton counts


def _estep(C, d, tau, Y, T, bin_size_ms, warm, cfg: FitConfig):
    """E-step of either method; returns ``(inf, post_loglik, vlb, warm_new)``.
    ``warm is None`` marks the cold first E-step, which for variational
    inference takes the cold budget ``vi_maxiter``."""
    if cfg.inference_method == "laplace":
        inf, pll = laplace_estep_from_arrays(
            C, d, tau, Y, T, bin_size_ms,
            x_init=warm, gtol=cfg.newton_gtol, maxiter=cfg.newton_maxiter,
            compute_cov=False, eps_noise=cfg.eps_noise,
        )
        return inf, pll, torch.zeros_like(pll), inf.post_mean
    return vi_estep_from_arrays(
        C, d, tau, Y, T, bin_size_ms,
        rho_init=warm, gtol=cfg.vi_gtol,
        maxiter=cfg.vi_maxiter if warm is None else cfg.vi_maxiter_warm,
        compute_cov=False, eps_noise=cfg.eps_noise, solver=cfg.vi_solver,
    )


def _mstep_full(C, d, tau, Y, inf: InfRes, bin_size_ms, cfg: FitConfig):
    """Unregularized M-step: (C, d) then tau, both from the E-step moments."""
    cd = learn_cd(Y, inf.post_mean, inf.post_vsm, C, d, maxiter=cfg.cd_newton_iters)
    tr = learn_tau(inf.post_mean, inf.post_vsm_gp, tau, bin_size_ms,
                   eps=cfg.eps_noise, maxiter=cfg.tau_maxiter)
    return cd, tr


def fit(
    init_params,
    Y,
    bin_size_ms: float,
    config: Optional[FitConfig] = None,
    device="cuda",
    dtype=torch.float64,
) -> FitResult:
    """Run a batch EM fit (Laplace or dual variational E-step).

    Args:
        init_params: dict ``{'C','d','tau'}`` of arrays, or :class:`Params`
            (then its tensors' device and dtype are used as they are).
        Y: spike counts ``(R, ydim, T)`` (array or tensor).
        bin_size_ms: bin width in milliseconds.
        config: :class:`FitConfig` (defaults to batch Laplace EM;
            ``inference_method="variational"`` for the dual variational
            E-step).
        device, dtype: where and in what precision the fit runs:
            ``torch.float64``, or ``torch.float32`` for the f32 fast mode
            (the JAX package's ``PGPFA_X64=0``: the whole EM in f32, f32
            factors used without refinement, f32-calibrated tolerances).
            The default is the card, which runs the CUDA kernels;
            there is no fallback to the CPU. Pass ``device="cpu"`` to run
            the kernels' plain PyTorch versions on the CPU.
    """
    cfg = config or FitConfig()
    p = init_params if isinstance(init_params, Params) else params_from_numpy(
        init_params, device, dtype)
    Y = torch.as_tensor(Y, dtype=p.C.dtype, device=p.C.device)
    T = Y.shape[-1]
    bin_size_ms = float(bin_size_ms)

    C, d, tau = p.C, p.d, p.tau
    rows = []
    warm = warm_prev = None
    for n in range(cfg.max_em_iter):
        # iteration 1 sees warm == warm_prev, where 2 w - w is exactly w
        ex = None if n == 0 else 2.0 * warm - warm_prev
        inf, pll, vlb, warm_new = _estep(C, d, tau, Y, T, bin_size_ms, ex, cfg)
        cd, tr = _mstep_full(C, d, tau, Y, inf, bin_size_ms, cfg)
        C, d, tau = cd.C, cd.d, tr.tau
        warm_prev = warm_new if n == 0 else warm
        warm = warm_new
        rows.append((cd.C, cd.d, tr.tau, pll, vlb, cd.cost, tr.cost,
                     cd.grad_norm, cd.niter, tr.niter, inf.newton_iters))

    seq = [torch.stack(col) for col in zip(*rows)]
    C_seq, d_seq, tau_seq, pll, vlb, cdc, tc, cgn, cni, tni, nwi = seq
    return FitResult(
        C=C, d=d, tau=tau,
        C_seq=C_seq, d_seq=d_seq, tau_seq=tau_seq,
        post_loglik=pll, var_lower_bound=vlb, cd_cost=cdc, tau_cost=tc,
        cd_grad_norm=cgn, cd_niter=cni, tau_niter=tni, newton_iters=nwi,
    )
