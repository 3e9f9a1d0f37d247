"""The port's kernels (``pgpfa_torch/ops/cuda_kernels.py``).

On the CPU: each kernel's plain PyTorch version against the JAX package
(the Pallas kernels in interpret mode, as ``tests/test_pallas.py`` runs them,
and the XLA forms), the failure and aliasing contract, and the wrappers'
dispatch and input checks. On the card (``requires_cuda``, skipped here):
each CUDA kernel against its plain version:

    python -m pytest -p no:cacheprovider tests/test_torch_kernels.py

JAX is imported only inside the tests that compare with it, so on a machine
without JAX the module still runs with ``--noconftest`` (the conftest pins
JAX to the CPU) and those tests skip.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pgpfa_torch.ops import _build, cuda_kernels
from pgpfa_torch.ops.cuda_kernels import chol32, chol32_plain, ns_step, ns_step_plain
from torch_helpers import npy, rel_err, requires_cuda, spd_batch


def _jnp():
    """``jax.numpy``, or a skip where JAX is not installed (on the card)."""
    return pytest.importorskip("jax.numpy")


def _pallas_chol():
    _jnp()
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
    from exp_pallas_chol import pallas_chol

    return pallas_chol


@pytest.fixture(scope="module")
def spd260():
    """B = 4, D = 260 (not a multiple of 128), as test_pallas.py uses."""
    return spd_batch(np.random.default_rng(1), 4, 260, dtype=np.float32)


@pytest.fixture(scope="module")
def ns_inputs():
    rng = np.random.default_rng(0)
    H = spd_batch(rng, 3, 256, dtype=np.float32, ridge=1.0)
    X0 = np.stack([np.diag(1.0 / np.diag(h)) for h in H]).astype(np.float32)
    return H, X0


# -- plain versions against the JAX package ---------------------------------


def test_chol32_plain_matches_jnp_cholesky(spd260):
    """f32 factors of one SPD batch by two LAPACK-backed routines: 2e-5, the
    tolerance test_pallas.py holds the Pallas probe to (eigenvalues in
    [0.5, 4.5], so f32 rounding stays ~1e-6)."""
    jnp = _jnp()
    got = chol32_plain(torch.from_numpy(spd260))
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(spd260)))
    np.testing.assert_allclose(npy(got), want, rtol=2e-5, atol=2e-5)


def test_chol32_plain_matches_pallas_probe(spd260):
    """The Pallas probe in interpret mode (upper garbage removed) gives the
    same factor as the port's plain version, to the same 2e-5."""
    pallas_chol, jnp = _pallas_chol(), _jnp()
    got = chol32_plain(torch.from_numpy(spd260))
    want = np.asarray(jnp.tril(pallas_chol(jnp.asarray(spd260), interpret=True)))
    np.testing.assert_allclose(npy(got), want, rtol=2e-5, atol=2e-5)


def test_ns_step_plain_matches_pallas(ns_inputs):
    """One f32 step by the plain two-matmul form vs the fused Pallas kernel
    in interpret mode: 2e-5, as test_pallas.py compares it with XLA."""
    jnp = _jnp()
    from pgpfa.ops.pallas_kernels import ns_step_fused

    H, X0 = ns_inputs
    got = ns_step_plain(torch.from_numpy(H), torch.from_numpy(X0))
    want = np.asarray(ns_step_fused(jnp.asarray(H), jnp.asarray(X0), interpret=True))
    np.testing.assert_allclose(npy(got), want, rtol=2e-5, atol=2e-5)


def test_ns_step_plain_matches_xla_form(ns_inputs):
    """Against the XLA form of ``maybe_ns_step`` (the JAX default path)."""
    jnp = _jnp()
    import jax

    HI = jax.lax.Precision.HIGHEST
    H, X0 = ns_inputs
    got = ns_step_plain(torch.from_numpy(H), torch.from_numpy(X0))
    Hj, Xj = jnp.asarray(H), jnp.asarray(X0)
    eye = jnp.eye(H.shape[-1], dtype=jnp.float32)
    want = Xj + jnp.matmul(Xj, eye - jnp.matmul(Hj, Xj, precision=HI), precision=HI)
    np.testing.assert_allclose(npy(got), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_ns_step_contracts_residual(ns_inputs):
    """From X = 0.9 H^{-1} (residual 0.1 I) one step must leave a residual
    below 0.02 (it squares to 0.01), the property test_pallas.py pins."""
    H = torch.from_numpy(ns_inputs[0])
    eye = torch.eye(H.shape[-1])
    Xs = torch.from_numpy((0.9 * np.linalg.inv(ns_inputs[0].astype(np.float64))).astype(np.float32))

    def residual(X):
        return float((eye - H[0] @ X[0]).abs().max())

    r0 = residual(Xs)
    r1 = residual(ns_step(H, Xs))
    assert abs(r0 - 0.1) < 0.01, r0
    assert r1 < 0.02, (r0, r1)


# -- failure and aliasing contract -------------------------------------------


def test_chol32_nan_on_non_pd():
    """A non-PD matrix gets NaN in its whole lower triangle and zeros above,
    like jnp.linalg.cholesky; its PD neighbour in the batch is untouched."""
    bad = np.array([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
    good = np.eye(3, dtype=np.float32) * 4.0
    L = npy(chol32(torch.from_numpy(np.stack([bad, good]))))
    want_bad = np.asarray(_jnp().linalg.cholesky(_jnp().asarray(bad)))
    assert np.isnan(want_bad[np.tril_indices(3)]).all()
    assert np.isnan(L[0][np.tril_indices(3)]).all()
    assert (L[0][np.triu_indices(3, 1)] == 0).all()
    np.testing.assert_array_equal(L[1], np.eye(3) * 2.0)


def test_chol32_nan_input_fails():
    """A NaN entry is a failure too (the Laplace line search relies on it)."""
    A = np.eye(4, dtype=np.float32)
    A[2, 1] = A[1, 2] = np.nan
    L = npy(chol32(torch.from_numpy(A)))
    assert np.isnan(L[np.tril_indices(4)]).all()


def test_chol32_fresh_output_reads_lower_only(spd260):
    """The output is a new tensor (the Pallas probe aliased its input), the
    input is left as it was, and only the lower triangle of the input is read."""
    A = torch.from_numpy(spd260.copy())
    before = A.clone()
    L = chol32(A)
    assert L.data_ptr() != A.data_ptr()
    assert torch.equal(A, before)
    assert torch.equal(L, L.tril())
    garbage = A.tril() + torch.triu(torch.full_like(A, 7.0), 1)
    assert torch.equal(chol32(garbage), L)


def test_chol32_unbatched_and_tiny():
    """(D, D) input and D = 1."""
    A = torch.tensor([[4.0]])
    assert torch.equal(chol32(A), torch.tensor([[2.0]]))
    B = torch.from_numpy(spd_batch(np.random.default_rng(2), 1, 6, dtype=np.float32)[0])
    np.testing.assert_allclose(npy(chol32(B) @ chol32(B).T), npy(B), rtol=1e-5, atol=1e-5)


# -- wrapper dispatch and checks ------------------------------------------------


def test_cpu_tensors_take_plain_version_and_count_nothing(ns_inputs):
    H, X0 = (torch.from_numpy(a) for a in ns_inputs)
    n_ns, n_ch = ns_step.launches, chol32.launches
    assert torch.equal(ns_step(H, X0), ns_step_plain(H, X0))
    assert torch.equal(chol32(H), chol32_plain(H))
    assert (ns_step.launches, chol32.launches) == (n_ns, n_ch)


def test_non_cpu_tensor_never_falls_back():
    """A tensor that is not on the CPU goes to the kernel path, which rejects
    a non-CUDA device instead of computing the plain version."""
    A = torch.empty(2, 8, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        chol32(A)
    with pytest.raises(ValueError, match="CUDA"):
        ns_step(A, A)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc, no kernels: the build raises instead of falling back."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_library_path_keys_on_sources():
    """The library's name is a hash of the sources and flags, under build/."""
    p = _build.library_path()
    assert p == _build.library_path()
    assert p.parent == _build.BUILD_DIR and p.parent.parts[-2] == "build"
    assert sorted(s.name for s in _build._sources()) == ["chol32.cu", "ns_step.cu"]


def test_shared_memory_limits():
    """The switch widths between each kernel's two paths: the largest D whose
    narrow-path footprint fits one block's 227 KB of shared memory; above it
    the wide path's footprint, which does not grow with D, fits."""
    ns, D = cuda_kernels.ns_step_smem_bytes, cuda_kernels.NS_STEP_SWITCH_D
    assert ns(D) <= 232448 < ns(D + 1)
    # the G slice (RB x 64) and 6 stages of 32 x 36 + 32 x 64 at the path's
    # width; 3 stages of 128 x 36 + 32 x 64 at the Laplace Hessian's width,
    # two blocks to an SM
    assert ns(140) == 4 * (32 * 64 + 6 * (32 * 36 + 32 * 64))
    assert ns(700) == 4 * (128 * 64 + 3 * (128 * 36 + 32 * 64))
    assert 2 * (ns(700) + 1024) <= 228 * 1024
    assert ns(D) == 4 * (cuda_kernels.ns_step_block_rows(D) * 64 + 3 * (128 * 36 + 32 * 64))
    smem, D = cuda_kernels.chol32_smem_bytes, cuda_kernels.CHOL32_SWITCH_D
    assert smem(D) <= 232448 and cuda_kernels._chol32_panel_bytes(D + 1, 32) > 232448
    assert smem(700) == 4 * (64 * 708 + 64)  # the Laplace Hessian's width, 64-wide panels
    width = cuda_kernels.chol32_panel_width
    assert (width(896), width(897), width(D), width(D + 1)) == (64, 32, 32, 64)
    assert smem(D) == 4 * (32 * (D + 4) + 64)
    # the wide path: two chunk slots of 416 rows and the 64-row diagonal block
    assert cuda_kernels.CHOL32_WIDE_CHUNK == 416
    wide = 4 * (64 * (64 + 2 * 416 + 4) + 64)
    assert smem(D + 1) == smem(8192) == wide <= 232448 < wide + 4 * 64 * 64


@pytest.mark.parametrize("xdim,T", [(5, 140), (6, 140), (7, 140), (8, 140), (5, 352), (1, 1760)])
def test_chol32_takes_the_laplace_hessian_widths(xdim, T):
    """The Laplace Hessian is xdim * T wide: every latent count up to 8 at
    the Stevenson T = 140, and every width up to 1760 that the first 32-wide
    kernel took, stays on the narrow path (the whole panel in shared memory)."""
    assert xdim * T <= cuda_kernels.CHOL32_SWITCH_D
    assert cuda_kernels.chol32_smem_bytes(xdim * T) <= 232448


@pytest.mark.parametrize("T", [1, 140, 256, 257, 700, 1000, 1025, 1760, 1792])
def test_ns_step_takes_the_chol32_widths(T):
    """blocks_inv runs two f32 steps on the (xdim, T, T) prior blocks whose
    T x T factor is chol32's: every width of chol32's narrow path takes
    ns_step's narrow path, a cluster of at most 8 blocks whose G slices fit
    shared memory."""
    assert cuda_kernels.NS_STEP_SWITCH_D >= cuda_kernels.CHOL32_SWITCH_D
    assert T <= cuda_kernels.CHOL32_SWITCH_D
    assert cuda_kernels.ns_step_smem_bytes(T) <= 232448
    assert -(-T // cuda_kernels.ns_step_block_rows(T)) <= 8


# -- on the card ----------------------------------------------------------------


@requires_cuda
def test_cuda_raw_stream_is_current_stream():
    """The wrappers read the current stream through torch's private
    ``_cuda_getCurrentRawStream``: it must be the handle the public API
    gives, on the default stream and inside a side stream, so that a torch
    release that changes it fails here and not inside a kernel."""
    dev = torch.device("cuda", torch.cuda.current_device())
    raw = torch._C._cuda_getCurrentRawStream
    assert raw(dev.index) == torch.cuda.current_stream(dev).cuda_stream
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        assert raw(dev.index) == side.cuda_stream != torch.cuda.default_stream(dev).cuda_stream


@requires_cuda
@pytest.mark.parametrize("B,D", [(100, 700), (5, 140), (90, 6), (4, 260), (3, 1),
                                 (3, 63), (3, 64), (3, 65), (3, 127), (3, 128), (3, 129),
                                 (3, 896), (3, 897), (2, 1120), (2, 1792)])
def test_cuda_chol32_matches_plain(B, D):
    """Kernel vs cuSOLVER-backed plain version on well-conditioned SPD
    matrices (eigenvalues in [0.5, 4.5]): 2e-5, f32 rounding of two orders.
    The widths reach both edges of the 64-wide panel, its 32-wide sub-panels
    and the 32 x 32 warp tiles, both load paths (D % 4 == 0 or not), and the
    32-wide panels of D > 896 up to the largest D."""
    A = torch.from_numpy(spd_batch(np.random.default_rng(D), B, D, dtype=np.float32)).cuda()
    n = chol32.launches
    L = chol32(A)
    torch.cuda.synchronize()
    assert chol32.launches == n + 1
    torch.testing.assert_close(L, chol32_plain(A), rtol=2e-5, atol=2e-5)
    assert torch.equal(L, L.tril())


@requires_cuda
@pytest.mark.parametrize("B,D", [(100, 700), (4, 260)])
def test_cuda_chol32_offset_input(B, D):
    """A contiguous view one float into its buffer (rows not 16-byte
    aligned) gives the same factor as the aligned input."""
    A = torch.from_numpy(spd_batch(np.random.default_rng(D + 1), B, D, dtype=np.float32)).cuda()
    buf = torch.empty(A.numel() + 1, device="cuda")
    Aoff = buf[1:].view_as(A)
    Aoff.copy_(A)
    assert Aoff.data_ptr() % 16 != 0
    torch.testing.assert_close(chol32(Aoff), chol32(A), rtol=0, atol=0)


@requires_cuda
def test_cuda_chol32_nan_on_non_pd():
    bad = torch.tensor([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    A = torch.stack([bad, 4.0 * torch.eye(3)]).cuda()
    L = chol32(A).cpu()
    assert torch.isnan(L[0].tril()[torch.tril(torch.ones(3, 3, dtype=torch.bool))]).all()
    assert torch.equal(L[1], 2.0 * torch.eye(3))


@requires_cuda
def test_cuda_chol32_late_pivot_failure():
    """One matrix of a (100, 700, 700) batch fails at column 650 (its
    diagonal entry there made negative, so the first 650 pivots are as
    before): its whole lower triangle is NaN, its neighbours match the
    plain version."""
    A = torch.from_numpy(spd_batch(np.random.default_rng(7), 100, 700, dtype=np.float32)).cuda()
    A[37, 650, 650] = -1.0
    L, want = chol32(A), chol32_plain(A)
    torch.cuda.synchronize()
    lower = torch.ones(700, 700, dtype=torch.bool, device="cuda").tril()
    assert torch.isnan(L[37][lower]).all() and (L[37][~lower] == 0).all()
    ok = torch.ones(100, dtype=torch.bool)
    ok[37] = False
    torch.testing.assert_close(L[ok], want[ok], rtol=2e-5, atol=2e-5)


@requires_cuda
def test_cuda_chol32_reads_lower_only_at_700():
    """At D = 700 the input is left as it was, and garbage (NaN) above the
    diagonal changes nothing in the factor."""
    A = torch.from_numpy(spd_batch(np.random.default_rng(8), 4, 700, dtype=np.float32)).cuda()
    before = A.clone()
    L = chol32(A)
    torch.cuda.synchronize()
    assert torch.equal(A, before)
    garbage = A.tril() + torch.triu(torch.full_like(A, float("nan")), 1)
    assert torch.equal(chol32(garbage), L)
    assert torch.equal(L, L.tril())


def _ns_inputs_cuda(B, D, seed):
    """f32 ``H`` (eigenvalues in [1, 5]) and ``X = 0.9 H^{-1}`` on the card."""
    H = spd_batch(np.random.default_rng(seed), B, D, ridge=1.0)
    X = torch.from_numpy((0.9 * np.linalg.inv(H)).astype(np.float32)).cuda()
    return torch.from_numpy(H.astype(np.float32)).cuda(), X


@requires_cuda
@pytest.mark.parametrize("B,D", [(5, 140), (100, 700), (3, 33), (1, 1), (5, 31), (5, 32),
                                 (5, 63), (5, 64), (5, 65), (5, 127), (5, 128), (5, 129),
                                 (5, 139), (100, 140), (3, 256), (3, 257), (3, 512), (3, 513),
                                 (1, 1000), (5, 1000), (2, 1024), (2, 1025), (2, 1792),
                                 (1, cuda_kernels.NS_STEP_SWITCH_D)])
def test_cuda_ns_step_matches_plain(B, D):
    """Kernel vs two cuBLAS f32 matmuls (TF32 off): 2e-5 relative to max|X'|.
    The widths reach the edges of the 32-deep chunks, the 64-column tiles,
    the row tiles of 32 and 128 (D = 256/257), a cluster of 4 or 5 blocks
    (D = 512/513), a block owning
    more than one row tile (D > 1024), both copy paths (D % 4 == 0 or not),
    and the widest D."""
    torch.backends.cuda.matmul.allow_tf32 = False
    H, X = _ns_inputs_cuda(B, D, D)
    n = ns_step.launches
    out = ns_step(H, X)
    torch.cuda.synchronize()
    assert ns_step.launches == n + 1
    want = ns_step_plain(H, X)
    assert float((out - want).abs().max()) <= 2e-5 * float(want.abs().max())


@requires_cuda
@pytest.mark.parametrize("B,D", [(100, 700), (5, 140)])
def test_cuda_ns_step_offset_input(B, D):
    """Contiguous views one float into their buffers (rows not 16-byte
    aligned: the 4-byte copy path) give the same result as the aligned
    inputs (the 16-byte path): the same sums in the same order."""
    H, X = _ns_inputs_cuda(B, D, D + 1)
    bufs = [torch.empty(H.numel() + 1, device="cuda") for _ in range(2)]
    Hoff, Xoff = (b[1:].view_as(H) for b in bufs)
    Hoff.copy_(H)
    Xoff.copy_(X)
    assert Hoff.data_ptr() % 16 != 0 and Xoff.data_ptr() % 16 != 0
    torch.testing.assert_close(ns_step(Hoff, Xoff), ns_step(H, X), rtol=0, atol=0)


@requires_cuda
def test_cuda_ns_step_batch_past_grid_limit():
    """A batch of 65537 matrices, past the grid's z extent of 65535: two
    launches, (65535, 8) and (2, 8), whose result is the plain version's
    (2e-5 relative to max|X'|), the last matrices included."""
    B, D = cuda_kernels.MAX_GRID_Z + 2, 8
    H, X = _ns_inputs_cuda(B, D, 11)
    n, by = ns_step.launches, dict(ns_step.launches_by_shape)
    out = ns_step(H, X)
    torch.cuda.synchronize()
    assert ns_step.launches == n + 2
    for shape in ((cuda_kernels.MAX_GRID_Z, D), (2, D)):
        assert ns_step.launches_by_shape[shape] == by.get(shape, 0) + 1
    want = ns_step_plain(H, X)
    assert float((out - want).abs().max()) <= 2e-5 * float(want.abs().max())
    assert float((out[-2:] - want[-2:]).abs().max()) <= 2e-5 * float(want[-2:].abs().max())


@requires_cuda
def test_cuda_ns_step_unbatched():
    """A (D, D) pair gives a (D, D) result, the batched call's matrix."""
    H, X = _ns_inputs_cuda(3, 140, 5)
    out = ns_step(H[1].contiguous(), X[1].contiguous())
    assert out.shape == (140, 140)
    torch.testing.assert_close(out, ns_step(H, X)[1], rtol=0, atol=0)


@requires_cuda
def test_cuda_ns_step_fresh_output_inputs_untouched():
    """The output is a new tensor and H, X are left as they were."""
    H, X = _ns_inputs_cuda(5, 700, 6)
    H0, X0 = H.clone(), X.clone()
    out = ns_step(H, X)
    torch.cuda.synchronize()
    assert out.data_ptr() not in (H.data_ptr(), X.data_ptr())
    assert torch.equal(H, H0) and torch.equal(X, X0)


@requires_cuda
def test_cuda_blocks_inv_at_t1000():
    """blocks_inv of a (1, 1000, 1000) RBF prior on the card (chol32 and two
    f32 ns_step launches at D = 1000, then two f64 steps) against the same
    call on the CPU: 1e-9 relative. tau = 0.04 s at 10 ms bins gives
    kappa(K) = 1.0e4, so two f64 steps leave ~(kappa eps32)^4 ~ 1e-13 (at the
    init's longest timescales kappa reaches 1e5-1e6 and 1e-9 is out of reach)."""
    from pgpfa_torch.models.params import rbf_kernel
    from pgpfa_torch.ops.blockmat import blocks_inv

    tau = torch.tensor([0.04], dtype=torch.float64)
    K = rbf_kernel(tau, 1000, 10.0)
    ev = np.linalg.eigvalsh(K[0].numpy())
    assert ev[-1] / ev[0] < 1.1e4
    n = ns_step.launches
    got = blocks_inv(K.cuda())
    torch.cuda.synchronize()
    assert ns_step.launches == n + 2
    want = blocks_inv(K)
    assert rel_err(got, want) <= 1e-9


@requires_cuda
@pytest.mark.parametrize("B,D", [(2, 1793), (1, 2100), (1, 4096)])
def test_cuda_chol32_wide_path(B, D):
    """Above CHOL32_SWITCH_D (the wide path: 64-wide panels in chunks of 416
    rows) the kernel matches its plain version to the narrow path's 2e-5,
    leaves its input as it was and reads only its lower triangle (NaN above
    the diagonal changes nothing). The widths take one chunk boundary, a
    ragged last chunk (2100 = 64 + 4 x 416 + 372) and ten chunks."""
    assert D > cuda_kernels.CHOL32_SWITCH_D
    A = torch.from_numpy(spd_batch(np.random.default_rng(D), B, D, dtype=np.float32)).cuda()
    before = A.clone()
    n = chol32.launches_by_shape[(B, D)]
    L = chol32(A)
    torch.cuda.synchronize()
    assert chol32.launches_by_shape[(B, D)] == n + 1
    assert torch.equal(A, before)
    torch.testing.assert_close(L, chol32_plain(A), rtol=2e-5, atol=2e-5)
    assert torch.equal(L, L.tril())
    garbage = A.tril() + torch.triu(torch.full_like(A, float("nan")), 1)
    assert torch.equal(chol32(garbage), L)


@requires_cuda
@pytest.mark.parametrize("col", [100, 2090])
def test_cuda_chol32_wide_path_non_pd(col):
    """On the wide path a negative pivot in the second panel (column 100) or
    in the last (column 2090 of 2100) gives NaN in the whole lower triangle
    of that matrix and zeros above; its neighbour matches the plain version."""
    A = torch.from_numpy(spd_batch(np.random.default_rng(9), 2, 2100, dtype=np.float32)).cuda()
    A[0, col, col] = -1.0
    L = chol32(A)
    torch.cuda.synchronize()
    lower = torch.ones(2100, 2100, dtype=torch.bool, device="cuda").tril()
    assert torch.isnan(L[0][lower]).all() and (L[0][~lower] == 0).all()
    torch.testing.assert_close(L[1], chol32_plain(A[1:])[0], rtol=2e-5, atol=2e-5)


@requires_cuda
@pytest.mark.parametrize("B,D", [(1, 4769), (2, 6000)])
def test_cuda_ns_step_wide_path(B, D):
    """Above NS_STEP_SWITCH_D (G = H X in a device workspace, two passes) the
    step matches two cuBLAS f32 matmuls to the narrow path's 2e-5 of
    max|X'|, on both copy paths (D % 4 != 0 and == 0), and leaves H and X
    as they were."""
    assert D > cuda_kernels.NS_STEP_SWITCH_D
    torch.backends.cuda.matmul.allow_tf32 = False
    H, X = _ns_inputs_cuda(B, D, D)
    H0, X0 = H.clone(), X.clone()
    n = ns_step.launches
    out = ns_step(H, X)
    torch.cuda.synchronize()
    assert ns_step.launches == n + 1
    assert torch.equal(H, H0) and torch.equal(X, X0)
    want = ns_step_plain(H, X)
    assert float((out - want).abs().max()) <= 2e-5 * float(want.abs().max())


@requires_cuda
@pytest.mark.parametrize("T", [1800, 4800])
def test_cuda_blocks_inv_wide(T):
    """blocks_inv of a (1, T, T) RBF prior past chol32's switch (T = 1800)
    and past ns_step's too (T = 4800) against the same call on the CPU:
    1e-9 relative, as at T = 1000 (tau = 0.04 s at 10 ms bins keeps
    kappa(K) ~ 1e4 at any T)."""
    from pgpfa_torch.models.params import rbf_kernel
    from pgpfa_torch.ops.blockmat import blocks_inv

    K = rbf_kernel(torch.tensor([0.04], dtype=torch.float64), T, 10.0)
    n_ch, n_ns = chol32.launches_by_shape[(1, T)], ns_step.launches_by_shape[(1, T)]
    got = blocks_inv(K.cuda())
    torch.cuda.synchronize()
    assert chol32.launches_by_shape[(1, T)] == n_ch + 1
    assert ns_step.launches_by_shape[(1, T)] == n_ns + 2
    assert rel_err(got, blocks_inv(K)) <= 1e-9


@requires_cuda
def test_cuda_fit_matches_cpu_fit():
    """The slice on the card (kernels in the loop) against the same fit on
    the CPU (plain versions), 2 EM iterations of a small problem: nPLL to
    1e-9 relative and tau to 1e-6 relative (two f32 factorizations; the
    refinement floors of test_torch_laplace.py)."""
    from pgpfa_torch import FitConfig, fit
    from torch_helpers import small_problem

    ds, init = small_problem()
    cfg = FitConfig(max_em_iter=2)
    cpu = fit(init, ds.Y, ds.binSize, cfg, device="cpu")
    n_chol, n_ns = chol32.launches, ns_step.launches
    gpu = fit(init, ds.Y, ds.binSize, cfg, device="cuda")
    assert gpu.post_loglik.device.type == "cuda"
    assert chol32.launches > n_chol and ns_step.launches > n_ns
    np.testing.assert_allclose(npy(gpu.post_loglik), npy(cpu.post_loglik), rtol=1e-9)
    np.testing.assert_allclose(npy(gpu.tau), npy(cpu.tau), rtol=1e-6)
