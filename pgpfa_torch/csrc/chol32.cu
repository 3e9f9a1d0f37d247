// Batched lower Cholesky factorization of f32 SPD matrices:
//     L = chol(A),   A, L: (B, D, D), row-major, contiguous, any D >= 1
//
// Replaces: scripts/exp_pallas_chol.py:_chol_kernel / pallas_chol (the TPU
// probe padded D to a multiple of 128 with an identity block, factored
// 128-wide panels by masked rank-1 iota steps, left garbage above the
// diagonal, and aliased its input).
//
// Contract: reads only the lower triangle of A and never writes A. L is a
// fresh buffer holding the factor in its lower triangle and zeros above.
// A matrix whose factorization meets a pivot that is not > 0 (or is NaN)
// gets NaN in its whole lower triangle, the semantics of jnp.linalg.cholesky
// that the Laplace line search relies on to stop a failing lane. Full f32
// FFMA throughout: no TF32 (the Laplace Hessians have condition ~1e4, and
// TF32's 4.9e-4 unit roundoff would stop the f64 refinement from converging).
//
// What bounds it on the H100: D^3/3 flops per matrix, almost all of them in
// the trailing updates. At (100, 700, 700) that is 1.14e10 flops, 0.171 ms at
// the 67 TFLOP/s FP32 FFMA peak of 132 SMs (0.226 ms on the 100 SMs that one
// block per matrix occupies); the bytes (lower triangle in, L out, 294 MB)
// take 0.088 ms at 3.35 TB/s. So the kernel is bound by FFMA issue, and the
// design keeps the FMA pipes fed:
//
//   One 512-thread block (16 warps) per matrix; right-looking, 64-wide
//   panels (32-wide for 896 < D <= 1792, where a 64-wide tall panel does not
//   fit in shared memory; same code, the panel width is an argument). The
//   trailing matrix lives in L (1.96 MB per matrix at D = 700, too large for
//   shared memory). For each panel:
//   1. stage the tall panel L[k0:, k0:k0+nbw] in shared memory by 4-byte
//      cp.async copies, all in flight at once, k-major
//      (P[k * ldp + r] = L[k0 + r][k0 + k]), zero-padded to whole warp tiles
//      and with an identity block past a ragged last panel, so no loop below
//      carries a predicate. 180 KB at D = 700.
//   2. factor it as two 32-wide sub-panels (a panel of at most 32 columns
//      has only the first), each by
//      a. the 32 x 32 diagonal block in ONE warp, a row per lane in
//         registers, columns broadcast by shuffles: no block barrier inside
//         the serial chain;
//      b. row solves L21 = A21 L11^{-T}: a row per thread in registers,
//         L11's columns read from shared memory as float4 broadcasts; rows
//         are independent, so one barrier per sub-panel, not per column;
//      (and between the two, the second sub-panel's columns take the
//      first's rank-32 update, a row per thread.)
//   3. write the panel back to L (and zeros above it), and update the
//      trailing lower triangle, L22 -= L21 L21^T, as a register-tiled SYRK:
//      32 x 32 warp tiles dealt round-robin to the 16 warps (no barrier
//      between tiles), an 8 x 4 micro-tile per lane, 32 FFMA per three
//      float4 shared loads per k step; each lane issues its tile's loads of
//      L22 before the FMA loop and consumes them after it, so their latency
//      hides behind the loop. 64-wide panels halve the read-modify-write
//      passes over L22 (11 at D = 700) against 32-wide ones.
//   The first panel reads A directly, so A is never copied into L first.
//
//   The wide path (D > 1792, where even a 32-wide tall panel does not fit
//   shared memory): 64-wide panels whose rows below the diagonal block are
//   taken in chunks of CH rows (416 on the H100). Shared memory holds the
//   diagonal block and two chunk slots, I and J. For each chunk I of the
//   panel: stage it in slot I (chunk 0 together with the diagonal block,
//   which is factored first), row-solve and sub-panel-update it as above,
//   write it to L; then update the trailing blocks of its rows, L22[I, J]
//   -= L21[I] L21[J]^T, for each earlier chunk J restaged from L (its rows
//   were written there by the same block, behind a barrier) into slot J,
//   and last the triangle L22[I, I] from slot I alone. Same helpers, same
//   sums in the same order per entry; the narrow path is the case of one
//   chunk that covers the whole panel. One block per matrix, so a small
//   batch leaves most SMs idle: 13.4 ms at (4, 2048, 2048), 2.8x cuSOLVER's
//   time (H100, chip_smoke.py).
//
//   The serial parts (diagonal factors, row solves) are not inlined: each
//   unrolled body runs a few times per panel, and inlined copies of them
//   did not stay in the instruction cache.
//
// PERF.md has the measured split of the time between these phases
// (pgpfa_torch/tools/chol32_phases.py) and what limits each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NB = 64;   // widest panel
constexpr int SB = 32;   // sub-panel width: one warp's diagonal block, and the narrow panel
constexpr int NT = 512;  // threads: 16 warps
constexpr int NWARP = NT / 32;
constexpr int WT = 32;   // warp tile of the trailing update
constexpr unsigned FULL = 0xffffffffu;

// Rows of a staged panel of width nbw and height H: the diagonal block plus
// the trailing rows rounded up to whole warp tiles (a multiple of 32).
__host__ __device__ inline int panel_rows(int H, int nbw) {
  const int n2 = H > nbw ? H - nbw : 0;
  return nbw + WT * ((n2 + WT - 1) / WT);
}

// Dynamic shared memory of a narrow launch: the panel (nbw x ldp) and NB
// pivots.
inline size_t smem_bytes(int D, int nbw) {
  return sizeof(float) * ((size_t)nbw * (panel_rows(D, nbw) + 4) + NB);
}

// The wide path's chunk rows under a shared-memory limit: the largest
// multiple of WT with NB x (NB + 2 CH + 4) floats and NB pivots inside it.
// Its Python mirror is chol32_smem_bytes in ops/cuda_kernels.py.
inline int wide_chunk_rows(int limit) {
  const int ldp = (limit / (int)sizeof(float) - NB) / NB;
  return (ldp - NB - 4) / 2 / WT * WT;
}

// Factor the 32 x 32 diagonal block at (cb, cb) of the staged panel in one
// warp: lane r holds row r. Writes L11's lower triangle back, 1 / L11[j][j]
// to invd, and flags a pivot that is not > 0. Not inlined: its unrolled body
// runs once per sub-panel, and one copy of it stays in the instruction cache
// where two inlined copies did not (measured on the H100: 12k cycles per
// call against 10k-23k).
// sqrt(d) and 1 / sqrt(d) by rsqrtf and Newton steps on FMA residuals
// (within about half an ulp, as sqrtf and a division give) halve the
// serial chain against sqrtf and a division.
__device__ __noinline__ void diag_factor(float* P, int ldp, int cb, float* invd,
                                            int* failed, int lane) {
  float a[SB];
#pragma unroll
  for (int c = 0; c < SB; ++c) a[c] = P[(cb + c) * ldp + cb + lane];
#pragma unroll
  for (int j = 0; j < SB; ++j) {
    const float d = __shfl_sync(FULL, a[j], j);
    if (!(d > 0.f)) *failed = 1;
    float inv = rsqrtf(d);
    inv = inv * fmaf(-0.5f * d * inv, inv, 1.5f);
    float s = d * inv;
    s = fmaf(fmaf(-s, s, d), 0.5f * inv, s);  // sqrt(d) from the exact residual d - s^2
    inv = fmaf(fmaf(-s, inv, 1.f), inv, inv);  // 1 / s from the exact residual 1 - s inv
    a[j] = lane == j ? s : a[j] * inv;
    // rank-1 update of the columns right of j (entries above the diagonal
    // are computed and never stored)
#pragma unroll
    for (int c = j + 1; c < SB; ++c) a[c] = fmaf(-a[j], __shfl_sync(FULL, a[j], c), a[c]);
    if (lane == 0) invd[cb + j] = inv;
  }
#pragma unroll
  for (int c = 0; c < SB; ++c)
    if (c <= lane) P[(cb + c) * ldp + cb + lane] = a[c];
}

// Row r of the sub-panel at column cb: x := x L11^{-T}, L11 the factored
// diagonal block at (cb, cb). Forward substitution, right-looking, so the
// FMAs of one step are independent. (Not inlined, like subpanel_update:
// one copy of each unrolled body in the instruction cache.)
__device__ __noinline__ void row_solve(float* P, int ldp, int cb, const float* invd, int r) {
  float x[SB];
#pragma unroll
  for (int c = 0; c < SB; ++c) x[c] = P[(cb + c) * ldp + r];
#pragma unroll
  for (int j = 0; j < SB; ++j) {
    x[j] *= invd[cb + j];
    const float* lj = P + (cb + j) * ldp + cb;  // lj[k] = L11[k][j]
#pragma unroll
    for (int q = (j + 1) / 4; q < SB / 4; ++q) {
      const float4 l = *reinterpret_cast<const float4*>(lj + 4 * q);
      if (4 * q + 0 > j) x[4 * q + 0] = fmaf(-x[j], l.x, x[4 * q + 0]);
      if (4 * q + 1 > j) x[4 * q + 1] = fmaf(-x[j], l.y, x[4 * q + 1]);
      if (4 * q + 2 > j) x[4 * q + 2] = fmaf(-x[j], l.z, x[4 * q + 2]);
      if (4 * q + 3 > j) x[4 * q + 3] = fmaf(-x[j], l.w, x[4 * q + 3]);
    }
  }
#pragma unroll
  for (int c = 0; c < SB; ++c) P[(cb + c) * ldp + r] = x[c];
}

// Row r (>= SB) of the second sub-panel takes the first one's rank-32 update:
// P2[r][c] -= sum_k L[r][k] L[SB + c][k], stored on and below the diagonal.
__device__ __noinline__ void subpanel_update(float* P, int ldp, int r) {
  float y[SB];
#pragma unroll
  for (int c = 0; c < SB; ++c) y[c] = 0.f;
#pragma unroll 4
  for (int k = 0; k < SB; ++k) {
    const float xk = P[k * ldp + r];
    const float* lk = P + k * ldp + SB;  // lk[c] = L[SB + c][k]
#pragma unroll
    for (int q = 0; q < SB / 4; ++q) {
      const float4 l = *reinterpret_cast<const float4*>(lk + 4 * q);
      y[4 * q + 0] = fmaf(xk, l.x, y[4 * q + 0]);
      y[4 * q + 1] = fmaf(xk, l.y, y[4 * q + 1]);
      y[4 * q + 2] = fmaf(xk, l.z, y[4 * q + 2]);
      y[4 * q + 3] = fmaf(xk, l.w, y[4 * q + 3]);
    }
  }
#pragma unroll
  for (int c = 0; c < SB; ++c)
    if (SB + c <= r) P[(SB + c) * ldp + r] -= y[c];
}

// One 32 x 32 warp tile (ti, tj), tj <= ti, of the trailing update
// L22 -= L21 L21^T. C22 is read from src (A for the first panel, L after)
// at (row, col) offset base and written to dst = L. Row i of L21 is staged
// at P row pio + i for the tile's rows and pjo + i for its columns. VEC:
// rows are 16-byte aligned (D % 4 == 0), so a lane's 4 columns move as one
// float4.
template <bool VEC>
__device__ __forceinline__ void update_tile(const float* P, int ldp, int pio, int pjo,
                                            const float* src, float* dst, size_t base, int D,
                                            int n2, int nbw, int ti, int tj, int lane) {
  const int i0 = ti * WT + (lane >> 3) * 8;
  const int j0 = tj * WT + (lane & 7) * 4;
  float c[8][4];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int i = i0 + m;
    const float* s = src + base + (size_t)i * D + j0;
    if (VEC) {
      // a float4 that straddles the diagonal reads one to three entries above
      // it (garbage in A, zeros in L); they are never stored
      const float4 v = (i < n2 && j0 <= i) ? *reinterpret_cast<const float4*>(s)
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
      c[m][0] = v.x; c[m][1] = v.y; c[m][2] = v.z; c[m][3] = v.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) c[m][q] = (i < n2 && j0 + q <= i) ? s[q] : 0.f;
    }
  }

  float acc[8][4];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[m][q] = 0.f;
  const float* pi = P + (pio + i0);  // pi[k * ldp + m] = L21[i0 + m][k]
  const float* pj = P + (pjo + j0);
  for (int kb = 0; kb < nbw; kb += SB) {
#pragma unroll 4
    for (int k = kb; k < kb + SB; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(pi + k * ldp);
      const float4 a1 = *reinterpret_cast<const float4*>(pi + k * ldp + 4);
      const float4 b = *reinterpret_cast<const float4*>(pj + k * ldp);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][q] = fmaf(a[m], bb[q], acc[m][q]);
    }
  }

#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int i = i0 + m;
    if (i >= n2) continue;
    float* d = dst + base + (size_t)i * D + j0;
    if (VEC && j0 + 3 <= i) {
      *reinterpret_cast<float4*>(d) = make_float4(c[m][0] - acc[m][0], c[m][1] - acc[m][1],
                                                  c[m][2] - acc[m][2], c[m][3] - acc[m][3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (j0 + q <= i) d[q] = c[m][q] - acc[m][q];
    }
  }
}

// 4-byte asynchronous copy from device to shared memory.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// Stage panel rows [g0, g0 + rows) (rows a multiple of 4) of the panel at
// column k0 into P rows [p0, p0 + rows) by asynchronous copies, all in flight
// at once: a warp moves 8 columns x 4 rows (4 x 32 B from src, and 32
// distinct banks in P since ldp = 4 mod 32). Entries outside the panel's
// lower triangle are those of an identity block, so no loop below carries a
// predicate. Waits for the thread's own copies; the caller then syncs.
__device__ __forceinline__ void stage(float* P, int ldp, int p0, const float* src, int D, int k0,
                                      int H, int nb, int nbw, int g0, int rows, int tid) {
  const int gsh = nbw == NB ? 3 : 2;  // the 8-column groups of a panel: nbw = 8 << gsh
  for (int e = tid; e < rows * nbw; e += NT) {
    const int blk = e >> 5;
    const int k = (blk & ((1 << gsh) - 1)) * 8 + (e & 7), r = (blk >> gsh) * 4 + ((e >> 3) & 3);
    const int g = g0 + r;
    float* dst = P + k * ldp + p0 + r;
    if (g < H && k < nb && k <= g) cp_async4(dst, src + (size_t)(k0 + g) * D + k0 + k);
    else *dst = g == k ? 1.f : 0.f;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Write P rows [p0, p0 + rows), panel rows [g0, g0 + rows), back to L.
__device__ __forceinline__ void write_back(const float* P, int ldp, int p0, float* Lb, int D,
                                           int k0, int H, int nb, int nbw, int g0, int rows,
                                           int tid) {
  const int gsh = nbw == NB ? 3 : 2;
  for (int e = tid; e < rows * nbw; e += NT) {
    const int blk = e >> 5;
    const int k = (blk & ((1 << gsh) - 1)) * 8 + (e & 7), r = (blk >> gsh) * 4 + ((e >> 3) & 3);
    const int g = g0 + r;
    if (g < H && k < nb) Lb[(size_t)(k0 + g) * D + k0 + k] = P[k * ldp + p0 + r];
  }
}

// The wide path's block L22[I, J] -= L21[I] L21[J]^T, J < I: chunk J's rows
// of L21 restaged from L into slot J, then its nti x CH / WT warp tiles.
template <bool VEC>
__device__ __noinline__ void update_from_chunk(float* P, int ldp, int CH, int I, int J, int nti,
                                               const float* src, float* Lb, size_t base, int D,
                                               int k0, int H, int nb, int n2, int nbw) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, TC = CH / WT;
  __syncthreads();  // chunk J's rows of L visible, slot J free
  stage(P, ldp, nbw + CH, Lb, D, k0, H, nb, nbw, nbw + J * CH, CH, tid);
  __syncthreads();
  for (int t = warp; t < nti * TC; t += NWARP)
    update_tile<VEC>(P, ldp, nbw - I * CH, nbw + CH - J * CH, src, Lb, base, D, n2, nbw,
                     I * TC + t / TC, J * TC + t % TC, lane);
}

// ldp: the stride of P (= 4 mod 32); nbw: the panel width; CH: the rows of a
// chunk (a multiple of WT). P holds the diagonal block in rows [0, nbw),
// chunk slot I in [nbw, nbw + CH) and, on the wide path, slot J in
// [nbw + CH, nbw + 2 CH). The narrow path has CH >= D - nbw: one chunk.
template <bool VEC>
__global__ void __launch_bounds__(NT, 1)
chol32_kernel(const float* __restrict__ A, float* __restrict__ L, int D, int ldp, int nbw,
              int CH) {
  extern __shared__ float4 smem4[];
  float* P = reinterpret_cast<float*>(smem4);  // nbw x ldp staged panel
  float* invd = P + nbw * ldp;                 // 1 / L[k0 + k][k0 + k]
  __shared__ int failed;

  const size_t off = (size_t)blockIdx.x * D * D;
  const float* Ab = A + off;
  float* Lb = L + off;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) failed = 0;
  const int TC = CH / WT;  // warp tiles per chunk

  for (int k0 = 0; k0 < D; k0 += nbw) {
    const int H = D - k0;          // panel height
    const int nb = min(nbw, H);    // panel width (ragged only for the last one)
    const int n2 = H - nb;         // trailing size
    const float* src = k0 == 0 ? Ab : Lb;
    const size_t base = (size_t)(k0 + nbw) * D + k0 + nbw;
    const int nch = n2 > CH ? (n2 + CH - 1) / CH : 1;

    for (int I = 0; I < nch; ++I) {
      // P row r holds panel row r + c0: chunk 0 comes with the diagonal block
      const int c0 = I * CH;                // the chunk's first trailing row
      const int nI = min(CH, n2 - c0);      // its rows (0 in the last panel)
      const int p0 = I == 0 ? 0 : nbw;
      const int rows = nbw - p0 + WT * ((nI + WT - 1) / WT);
      const int rend = min(H - c0, nbw + CH);

      // 1. stage
      stage(P, ldp, p0, src, D, k0, H, nb, nbw, p0 + c0, rows, tid);
      __syncthreads();

      // 2. the two 32-wide sub-panels (the diagonal block's with chunk 0)
      const int rbeg = I == 0 ? SB : nbw;
      if (I == 0) {
        if (warp == 0) diag_factor(P, ldp, 0, invd, &failed, lane);
        __syncthreads();
      }
      for (int r = rbeg + tid; r < rend; r += NT) row_solve(P, ldp, 0, invd, r);
      __syncthreads();
      if (nb > SB) {  // uniform over the block
        for (int r = rbeg + tid; r < rend; r += NT) subpanel_update(P, ldp, r);
        __syncthreads();
        if (I == 0) {
          if (warp == 0) diag_factor(P, ldp, SB, invd, &failed, lane);
          __syncthreads();
        }
        for (int r = max(rbeg, 2 * SB) + tid; r < rend; r += NT) row_solve(P, ldp, SB, invd, r);
        __syncthreads();
      }

      // 3. write the chunk back; with chunk 0, zero the columns above the panel
      write_back(P, ldp, p0, Lb, D, k0, H, nb, nbw, p0 + c0, rows, tid);
      if (I == 0)
        for (int e = tid; e < k0 * nb; e += NT) Lb[(size_t)(e / nb) * D + k0 + e % nb] = 0.f;

      // 4. update the chunk's rows of L22: the blocks of each earlier chunk
      //    J, restaged from L into slot J, then the triangle of chunk I
      const int nti = (nI + WT - 1) / WT;
      for (int J = 0; J < I; ++J)
        update_from_chunk<VEC>(P, ldp, CH, I, J, nti, src, Lb, base, D, k0, H, nb, n2, nbw);
      const int ntiles = nti * (nti + 1) / 2;
      for (int t = warp; t < ntiles; t += NWARP) {
        int ti = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
        while (ti * (ti + 1) / 2 > t) --ti;
        while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
        update_tile<VEC>(P, ldp, nbw - c0, nbw - c0, src, Lb, base, D, n2, nbw, I * TC + ti,
                         I * TC + t - ti * (ti + 1) / 2, lane);
      }
      __syncthreads();
    }
  }

  if (failed) {
    const float nan = __int_as_float(0x7fc00000);
    for (size_t e = tid; e < (size_t)D * D; e += NT) {
      const int r = (int)(e / D), c = (int)(e % D);
      if (c <= r) Lb[e] = nan;
    }
  }
}

template <bool VEC>
int launch(const float* A, float* L, int B, int D, cudaStream_t stream) {
  // narrow: the widest panel whose whole height fits the block's shared
  // memory; the wide path where none does
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  int nbw = NB, ch, ldp;
  size_t smem;
  if (smem_bytes(D, SB) <= (size_t)limit) {
    nbw = smem_bytes(D, NB) <= (size_t)limit ? NB : SB;
    ldp = panel_rows(D, nbw) + 4;
    ch = max(WT, ldp - 4 - nbw);
    smem = smem_bytes(D, nbw);
  } else {
    ch = wide_chunk_rows(limit);
    if (ch < WT) return (int)cudaErrorInvalidValue;
    ldp = NB + 2 * ch + 4;
    smem = sizeof(float) * ((size_t)NB * ldp + NB);
  }
  err = cudaFuncSetAttribute(chol32_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  chol32_kernel<VEC><<<B, NT, smem, stream>>>(A, L, D, ldp, nbw, ch);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int pgpfa_chol32(const float* A, float* L, int B, int D, cudaStream_t stream) {
  const bool vec = D % 4 == 0 && (uintptr_t)A % 16 == 0 && (uintptr_t)L % 16 == 0;
  return vec ? launch<true>(A, L, B, D, stream) : launch<false>(A, L, B, D, stream);
}
