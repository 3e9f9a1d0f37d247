"""Elliptical slice sampling of the exact latent posterior (PyTorch port of
``pgpfa/infer/mcmc.py``).

The chain's stationary density is ``N(x; 0, K) * prod Poisson(y | exp(C x + d))``:
the prior enters through the ellipse, built from the per-latent prior Cholesky
factors (:func:`_prior_chol`, the ``chol32`` kernel on the card), and the
transitions see the Poisson log-likelihood only. The four transitions keep
the JAX package's control flow and caps; each ``lax.while_loop`` is a Python
loop whose test reads one value back from the device (per shrink, or per
round of the speculative transition), and the fixed transition runs its
``n_shrink`` shrinks with no readback. Lanes of several chains run as one
batch where the JAX package ``vmap``s.

**Draws.** Every random number a transition uses comes from a draw source
with two methods, ``normal(shape, dtype, device)`` and
``uniform(shape, dtype, device)`` (uniform in ``[0, 1)``). A transition over
states of shape ``lanes + (xdim, T)`` asks, in this order: ``normal`` of the
state's shape (the prior draw ``z``); ``uniform(lanes)`` for the slice level;
``uniform(lanes)`` for the initial angle; then its shrink uniforms, one
``uniform(lanes)`` per shrink (sequential, batched), ``uniform((n_spec - 1,))``
for round 0 and ``uniform((n_spec,))`` for each later round (speculative), or
``uniform((n_shrink,) + lanes)`` once (fixed). The drivers draw from
:class:`SeededDraws` unless handed a source: its streams differ from the JAX
package's ``jax.random`` ones, and the tests feed both packages the same draws
by handing the port a source that replays JAX's. :class:`ReplayDraws` serves
the draws a ``SeededDraws(keep=True)`` kept, to repeat a chain elsewhere.

**Exhaustion.** When no candidate reaches the slice level within a
transition's cap, the port keeps the current state and its log-likelihood,
in all four transitions. The JAX package returns a rejected candidate there
(speculative: round 0's first; fixed: the last, untested; sequential and
batched: the last). On every input where a candidate is accepted the result
is the JAX package's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from pgpfa_torch.models.params import Params, rbf_kernel
from pgpfa_torch.ops.blockmat import chol32

TWO_PI = 2.0 * math.pi


class ESSResult(NamedTuple):
    samples: torch.Tensor  # (n_samples, xdim, T) or (R, n_samples, xdim, T)
    log_lik: torch.Tensor  # (n_samples,) or (R, n_samples)


class SeededDraws:
    """Draws from a ``torch.Generator`` on ``device`` seeded with ``seed``:
    made where the chain runs, so no draw is copied from the host. With
    ``keep=True`` each draw is also kept, in order, in ``kept``."""

    def __init__(self, seed: int, device, keep: bool = False):
        self.generator = torch.Generator(device=device).manual_seed(int(seed))
        self.kept = [] if keep else None

    def _made(self, t):
        if self.kept is not None:
            self.kept.append(t)
        return t

    def normal(self, shape, dtype, device):
        return self._made(torch.randn(shape, generator=self.generator, dtype=dtype, device=device))

    def uniform(self, shape, dtype, device):
        return self._made(torch.rand(shape, generator=self.generator, dtype=dtype, device=device))


class ReplayDraws:
    """Serves the draws ``kept`` by another run, in order, each moved to the
    device asked for: a chain replayed elsewhere (the card's on the CPU).
    A request of another shape, or past the end, means that the replaying
    chain took another accept decision: ``ValueError``. ``used`` counts the
    draws served."""

    def __init__(self, kept):
        self.kept, self.used = kept, 0

    def normal(self, shape, dtype, device):
        if self.used >= len(self.kept) or tuple(self.kept[self.used].shape) != tuple(shape):
            raise ValueError(f"draw {self.used}: asked for shape {tuple(shape)}, which the "
                             "recorded run did not draw there")
        self.used += 1
        return self.kept[self.used - 1].to(device=device, dtype=dtype)

    uniform = normal


def _prior_chol(K: torch.Tensor, dtype) -> torch.Tensor:
    """Guarded prior-draw factor of the ``(xdim, T, T)`` kernel blocks: the
    f32 ``chol32`` factor; if it is not finite, once more on
    ``K + 1e-5 max(diag K) I``; if that is not finite either, the f64
    ``torch.linalg.cholesky`` (as the JAX package's ``jnp.linalg.cholesky``).
    Cast to ``dtype``. Each test is one host readback."""
    L = chol32(K)
    if not bool(torch.isfinite(L).all()):
        bump = 1e-5 * K.diagonal(dim1=-2, dim2=-1).max()
        L = chol32(K + bump * torch.eye(K.shape[-1], dtype=K.dtype, device=K.device))
        if not bool(torch.isfinite(L).all()):
            return torch.linalg.cholesky(K.to(torch.float64)).to(dtype)
    return L.to(dtype)


def poisson_log_lik(C: torch.Tensor, d: torch.Tensor, Y: torch.Tensor):
    """``X -> sum(Y * A) - sum(exp(A))`` with ``A = C X + d``: the Poisson
    log-likelihood (up to a constant) of states ``X (..., xdim, T)`` against
    counts ``Y`` (``(ydim, T)``, or ``(R, ydim, T)`` for ``(R, xdim, T)``
    states), one value per state."""

    def log_lik(X):
        A = torch.matmul(C, X) + d[:, None]
        return (Y * A).sum((-2, -1)) - torch.exp(A).sum((-2, -1))

    return log_lik


def _lanes(t: torch.Tensor) -> torch.Tensor:
    """An angle per lane ``lanes`` as ``lanes + (1, 1)``, to scale states."""
    return t[..., None, None]


def _ellipse(draws, x, chol_blocks):
    """The prior draw ``nu = L z`` for states ``x`` (lanes + (xdim, T))."""
    z = draws.normal(x.shape, x.dtype, x.device)
    return torch.einsum("ktu,...ku->...kt", chol_blocks, z)


def _shrink(phi, lo, hi, u):
    """One step of the rejection loop: shrink the bracket toward 0 with the
    rejected angle ``phi``, then draw the next angle with ``u``."""
    lo = torch.where(phi < 0, phi, lo)
    hi = torch.where(phi >= 0, phi, hi)
    return u * (hi - lo) + lo, lo, hi


def elliptical_slice_step(draws, x, log_lik_fn, chol_blocks, ll_cur=None):
    """One sequential ESS transition of one chain, ``x (xdim, T)``, with at
    most 1000 shrinks (``pgpfa/infer/mcmc.py:62``).

    Args:
        draws: the draw source (module docstring).
        log_lik_fn: ``(..., xdim, T) -> (...)`` log-likelihood.
        chol_blocks: per-latent prior factors ``(xdim, T, T)``.
        ll_cur: ``log_lik_fn(x)``, if known (carried along the chain).

    Returns ``(x_new, ll_new)``; ``(x, ll_cur)`` if no shrink is accepted.
    """
    nu = _ellipse(draws, x, chol_blocks)
    if ll_cur is None:
        ll_cur = log_lik_fn(x)
    log_y = ll_cur + torch.log(draws.uniform((), x.dtype, x.device))
    phi = draws.uniform((), x.dtype, x.device) * 2.0 * math.pi
    lo, hi = phi - TWO_PI, phi
    x_new = x * torch.cos(phi) + nu * torch.sin(phi)
    ll = log_lik_fn(x_new)
    rejected = bool(ll <= log_y)
    it = 0
    while rejected and it < 1000:
        phi, lo, hi = _shrink(phi, lo, hi, draws.uniform((), x.dtype, x.device))
        x_new = x * torch.cos(phi) + nu * torch.sin(phi)
        ll = log_lik_fn(x_new)
        rejected = bool(ll <= log_y)
        it += 1
    if rejected:
        return x, ll_cur
    return x_new, ll


def elliptical_slice_step_spec(draws, x, log_lik_fn, chol_blocks, ll_cur,
                               n_spec: int = 8, max_rounds: int = 128):
    """Speculative ESS transition (``pgpfa/infer/mcmc.py:106``): the
    sequential transition's candidate angles, ``n_spec`` per batched
    likelihood evaluation, each computed as if its predecessors were
    rejected; the first candidate above the slice level is accepted. Round 0
    is the initial angle and ``n_spec - 1`` shrinks; at most ``max_rounds``
    rounds. One readback per round.

    Returns ``(x_new, ll_new)``; ``(x, ll_cur)`` if no round accepts.
    """
    nu = _ellipse(draws, x, chol_blocks)
    log_y = ll_cur + torch.log(draws.uniform((), x.dtype, x.device))
    phi0 = draws.uniform((), x.dtype, x.device) * 2.0 * math.pi

    def candidates(phi, lo, hi, n):
        angles = []
        for u in draws.uniform((n,), x.dtype, x.device):
            phi, lo, hi = _shrink(phi, lo, hi, u)
            angles.append(phi)
        return phi, lo, hi, angles

    def evaluate(angles):
        phis = torch.stack(angles)
        Xc = x * _lanes(torch.cos(phis)) + nu * _lanes(torch.sin(phis))
        lls = log_lik_fn(Xc)
        acc = lls > log_y
        return bool(acc.any()), acc, Xc, lls

    phi, lo, hi, rest = candidates(phi0, phi0 - TWO_PI, phi0, n_spec - 1)
    got, acc, Xc, lls = evaluate([phi0] + rest)
    it = 1
    while not got and it < max_rounds:
        phi, lo, hi, angles = candidates(phi, lo, hi, n_spec)
        got, acc, Xc, lls = evaluate(angles)
        it += 1
    if not got:
        return x, ll_cur
    first = torch.argmax(acc.to(torch.uint8))  # the first accepted candidate
    return Xc[first], lls[first]


def elliptical_slice_step_fixed(draws, x, log_lik_fn, chol_blocks, n_shrink: int = 40):
    """Branchless ESS transition (``pgpfa/infer/mcmc.py:193``) for states
    ``x`` of shape lanes + ``(xdim, T)``: exactly ``n_shrink`` shrinks, no
    readback. A lane freezes at its first candidate above the slice level
    (tested with the previous candidate's log-likelihood, as in the JAX
    package); the candidate left after the last shrink is tested too, and a
    lane that accepted none keeps its state. The slice level is set from
    ``log_lik_fn(x)``, computed here.

    Returns ``(x_new, ll_new)`` per lane.
    """
    lanes = x.shape[:-2]
    nu = _ellipse(draws, x, chol_blocks)
    ll_x = log_lik_fn(x)
    log_y = ll_x + torch.log(draws.uniform(lanes, x.dtype, x.device))
    phi = draws.uniform(lanes, x.dtype, x.device) * 2.0 * math.pi
    lo, hi = phi - TWO_PI, phi
    xc = x * _lanes(torch.cos(phi)) + nu * _lanes(torch.sin(phi))
    ll = log_lik_fn(xc)
    done = torch.zeros(lanes, dtype=torch.bool, device=x.device)
    for u in draws.uniform((n_shrink,) + tuple(lanes), x.dtype, x.device):
        done = done | (ll > log_y)
        phi_new, lo, hi = _shrink(phi, lo, hi, u)
        x_new = x * _lanes(torch.cos(phi_new)) + nu * _lanes(torch.sin(phi_new))
        ll_new = log_lik_fn(x_new)
        phi = torch.where(done, phi, phi_new)
        ll = torch.where(done, ll, ll_new)
        xc = torch.where(_lanes(done), xc, x_new)
    ok = done | (ll > log_y)
    return torch.where(_lanes(ok), xc, x), torch.where(ok, ll, ll_x)


def elliptical_slice_step_batched(draws, X, log_lik_batch, chol, ll_cur, max_shrink: int = 1000):
    """One ESS transition of ``R`` chains ``X (R, xdim, T)`` with one shrink
    loop over all of them (``pgpfa/infer/mcmc.py:243``). Lanes that have
    accepted keep their angle, bracket, state and log-likelihood; one
    uniform ``(R,)`` is drawn per shrink for all lanes; the loop ends when no
    lane is rejecting or after ``max_shrink`` shrinks (one readback per
    shrink). Lanes still rejecting then keep ``X`` and ``ll_cur``.

    Args:
        log_lik_batch: ``(R, xdim, T) -> (R,)``.
        ll_cur: ``log_lik_batch(X)``, carried along the chains.
    """
    R = X.shape[0]
    nu = _ellipse(draws, X, chol)
    log_y = ll_cur + torch.log(draws.uniform((R,), X.dtype, X.device))
    phi = draws.uniform((R,), X.dtype, X.device) * 2.0 * math.pi
    lo, hi = phi - TWO_PI, phi
    xc = X * _lanes(torch.cos(phi)) + nu * _lanes(torch.sin(phi))
    ll = log_lik_batch(xc)
    active = ll <= log_y  # lanes still rejecting
    it = 0
    while it < max_shrink and bool(active.any()):
        lo = torch.where(active & (phi < 0), phi, lo)
        hi = torch.where(active & (phi >= 0), phi, hi)
        u = draws.uniform((R,), X.dtype, X.device)
        phi = torch.where(active, u * (hi - lo) + lo, phi)
        x_cand = X * _lanes(torch.cos(phi)) + nu * _lanes(torch.sin(phi))
        ll_cand = log_lik_batch(x_cand)
        xc = torch.where(_lanes(active), x_cand, xc)
        ll = torch.where(active, ll_cand, ll)
        active = ll <= log_y
        it += 1
    return torch.where(_lanes(active), X, xc), torch.where(active, ll_cur, ll)


def _to_tensor(a, device) -> torch.Tensor:
    """A tensor as it is; an array on ``device``, f32 if it is f32, else f64."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    return torch.tensor(a, dtype=torch.float32 if a.dtype == np.float32 else torch.float64,
                        device=device)


def _chain_inputs(C, d, tau, Y, device):
    """``C`` as a tensor (its device and dtype are the chain's), then ``d``,
    ``tau`` and ``Y`` (cast to C's dtype) beside it."""
    C = _to_tensor(C, device)
    d, tau, Y = (_to_tensor(a, C.device).to(C.device, C.dtype) for a in (d, tau, Y))
    return C, d.reshape(-1), tau.reshape(-1), Y


def posterior_mcmc_batched(
    C,
    d,
    tau,
    Y,
    T: int,
    bin_size_ms: float,
    n_samples: int = 1000,
    seed: int = 0,
    eps_noise: float = 0.001,
    n_shrink: int = 40,
    shrink: str = "adaptive",
    draws=None,
    device="cuda",
) -> ESSResult:
    """One ESS chain per trial of ``Y (R, ydim, T)``, all trials at once
    (``pgpfa/infer/mcmc.py:304``), each from zeros.

    ``shrink='adaptive'``: :func:`elliptical_slice_step_batched`, the
    current log-likelihoods carried across samples. ``shrink='fixed'``:
    :func:`elliptical_slice_step_fixed` over all chains at once.

    Arrays go to ``device`` (the card unless the caller asks for the CPU);
    tensors keep their device. The chain's dtype is C's (f32 or f64); ``Y``
    is cast to it. Draws come from ``draws`` or, without it, from
    ``SeededDraws(seed)`` on the chain's device (not the JAX package's
    ``jax.random`` streams).

    Returns :class:`ESSResult` with ``samples (R, n_samples, xdim, T)``.
    """
    if shrink not in ("adaptive", "fixed"):
        raise ValueError(f"unknown shrink {shrink!r}; choose 'adaptive' or 'fixed'")
    C, d, tau, Y = _chain_inputs(C, d, tau, Y, device)
    chol = _prior_chol(rbf_kernel(tau, T, bin_size_ms, eps_noise), C.dtype)
    draws = SeededDraws(seed, C.device) if draws is None else draws
    return _batched_chains(C, d, chol, Y, n_samples, draws, shrink, n_shrink)


def _batched_chains(C, d, chol, Y, n_samples, draws, shrink="adaptive", n_shrink=40) -> ESSResult:
    """The chains of :func:`posterior_mcmc_batched` on the prior factor ``chol``."""
    R, T = Y.shape[0], Y.shape[-1]
    log_lik = poisson_log_lik(C, d, Y)
    x = torch.zeros((R, C.shape[1], T), dtype=C.dtype, device=C.device)
    samples = torch.empty((R, n_samples) + x.shape[1:], dtype=C.dtype, device=C.device)
    lls = torch.empty((R, n_samples), dtype=C.dtype, device=C.device)
    ll = log_lik(x)
    for i in range(n_samples):
        if shrink == "adaptive":
            x, ll = elliptical_slice_step_batched(draws, x, log_lik, chol, ll)
        else:
            x, ll = elliptical_slice_step_fixed(draws, x, log_lik, chol, n_shrink)
        samples[:, i] = x
        lls[:, i] = ll
    return ESSResult(samples=samples, log_lik=lls)


def posterior_mcmc_from_arrays(
    C,
    d,
    tau,
    Y_trial,
    T: int,
    bin_size_ms: float,
    n_samples: int = 1000,
    seed: int = 0,
    eps_noise: float = 0.001,
    n_spec: int = 8,
    draws=None,
    device="cuda",
) -> ESSResult:
    """One ESS chain over one trial's latent posterior, ``Y_trial (ydim, T)``
    (``pgpfa/infer/mcmc.py:383``), from zeros, its log-likelihood carried
    across samples. ``n_spec > 1`` takes the speculative transition,
    ``n_spec = 1`` the sequential one. Devices, dtypes and draws as in
    :func:`posterior_mcmc_batched`.

    Returns :class:`ESSResult` with ``samples (n_samples, xdim, T)``.
    """
    C, d, tau, Y = _chain_inputs(C, d, tau, Y_trial, device)
    chol = _prior_chol(rbf_kernel(tau, T, bin_size_ms, eps_noise), C.dtype)
    draws = SeededDraws(seed, C.device) if draws is None else draws
    return _single_chain(C, d, chol, Y, n_samples, draws, n_spec)


def _single_chain(C, d, chol, Y, n_samples, draws, n_spec=8) -> ESSResult:
    """The chain of :func:`posterior_mcmc_from_arrays` on the prior factor ``chol``."""
    log_lik = poisson_log_lik(C, d, Y)
    x = torch.zeros((C.shape[1], Y.shape[-1]), dtype=C.dtype, device=C.device)
    samples = torch.empty((n_samples,) + x.shape, dtype=C.dtype, device=C.device)
    lls = torch.empty((n_samples,), dtype=C.dtype, device=C.device)
    ll = log_lik(x)
    for i in range(n_samples):
        if n_spec > 1:
            x, ll = elliptical_slice_step_spec(draws, x, log_lik, chol, ll, n_spec=n_spec)
        else:
            x, ll = elliptical_slice_step(draws, x, log_lik, chol, ll_cur=ll)
        samples[i] = x
        lls[i] = ll
    return ESSResult(samples=samples, log_lik=lls)


def posterior_mcmc(params: Params, Y_trial, T: int, bin_size_ms: float, **kw) -> ESSResult:
    """:func:`posterior_mcmc_from_arrays` with a :class:`Params` (on its
    tensors' device and in their dtype)."""
    return posterior_mcmc_from_arrays(params.C, params.d, params.tau, Y_trial, T, bin_size_ms, **kw)
