// Fused Newton-Schulz inverse step for a batch of f32 SPD matrices:
//     out = 2 X - X (H X)          H, X, out: (B, D, D), row-major, contiguous
//
// Replaces: pgpfa/ops/pallas_kernels.py:_ns_step_kernel / ns_step_fused (the
// TPU kernel kept H and X resident in VMEM and never wrote G = H X to HBM).
//
// Contract: out is a fresh buffer; H and X are only read; G = H X stays out
// of device memory except on the wide path below; the launch returns
// cudaGetLastError() and never synchronises. Full f32 FFMA: no TF32 (the
// refinement it serves needs ~1e-7, and floors at ~1e-3 in TF32).
//
// What bounds it on the H100: 4 D^3 flops per matrix against 3 D^2 floats
// moved, so FFMA issue at every width the path uses: at (100, 700, 700)
// 1.37e11 flops, 2.05 ms at the 67 TFLOP/s FP32 peak; at (5, 140, 140) the
// bound is under a microsecond and the kernel is latency- and launch-bound.
// The design feeds the FMA pipes at large D and puts enough blocks, with
// their loads in flight, on the card at small D:
//
//   A thread-block cluster of CR <= 8 blocks per (matrix, 64-column tile J).
//   Block c owns rows R_c = [c RB, (c + 1) RB) and
//   (a) computes G[R_c, J] = H[R_c, :] X[:, J] into its own shared memory;
//   (b) cluster barrier;
//   (c) computes out[R_c, J] = 2 X[R_c, J] - X[R_c, :] G[:, J], reading each
//       depth chunk of G[:, J] from the shared memory of the block that owns
//       it (distributed shared memory);
//   (d) cluster barrier, so no block leaves while another reads its G.
//   Both products are split by rows with no work repeated, and a block holds
//   only its RB x 64 slice of G and a ring of load stages, so the footprint
//   grows as D / 8, not D: D up to 4768 fits (ns_step_smem_bytes in
//   ops/cuda_kernels.py mirrors smem_floats below).
//
//   The wide path (D > 4768, where a cluster's shared memory no longer holds
//   G[:, J]): the caller passes a (B, D, D) workspace and G = H X goes
//   through device memory after all, in two launches over a grid of
//   128 x 64 output tiles: G = H X, then 2 X - X G, each tile by product()
//   with the same register tiles and ring. G's write and read add 8 D^2
//   bytes per matrix against its 4 D^3 flops: still FFMA-bound. At
//   (2, 6000, 6000) it runs at 54% of the FP32 peak, two cuBLAS SGEMMs at
//   78% (H100, chip_smoke.py).
//
//   Register tiles: 8 warps as 4 x 2 warp tiles of (4 TM) x 32; a lane holds
//   TM x 4 accumulators (TM = 8 for D > 256, 2 up to 256, so small matrices
//   get more, smaller blocks: 75 at (5, 140, 140)). Per four depth steps a
//   lane reads TM + 4 float4 from shared memory for 16 TM FFMA (12 loads per
//   128 FFMA at TM = 8). TM = 4 would serve 256 < D <= 512 better only at
//   small batches: 25% faster at (4, 260, 260), 14% slower at
//   (100, 400, 400) on the H100 (chip_smoke.py).
//
//   Loads in flight: the A operand (H rows, then X rows) and X[:, J] stream
//   in 32-deep chunks through a ring of 3 (TM = 8) or 6 (TM = 2) stages by
//   cp.async (at D <= 160 every chunk is in flight at once), 16-byte copies
//   where D % 4 == 0 and the pointers are 16-byte aligned, 4-byte copies
//   otherwise (1.5x slower at (100, 700, 700)); the ring keeps the next
//   chunks in flight while one is multiplied. In (c), the next G chunk is
//   read from its owner into registers before the current chunk's FMA loop
//   and stored to the ring after it. Ragged rows, columns and depth are
//   zero-filled in the stages.
//
// At (100, 700, 700) this runs at ~42% of the FP32 peak, cuBLAS's SGEMMs at
// ~64% (chip_smoke.py, PERF.md). Tried and slower there on the H100: an
// 8 x 8 micro-tile over 128 threads, a 2-stage ring, and
// __launch_bounds__(256, 1).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;        // threads: 8 warps, 4 (rows) x 2 (columns)
constexpr int BN = 64;         // columns of a tile J
constexpr int KC = 32;         // depth of a staged chunk
constexpr int LDA = KC + 4;    // row stride of a staged A chunk (16-byte rows)
constexpr int MAX_CLUSTER = 8; // the portable cluster size

__host__ __device__ constexpr int tile_rows(int TM) { return 16 * TM; }
__host__ __device__ constexpr int ring_stages(int TM) { return TM == 8 ? 3 : 6; }
__host__ __device__ constexpr int stage_floats(int TM) { return tile_rows(TM) * LDA + KC * BN; }

// Micro-tile rows per lane at width D.
inline int micro_rows(int D) { return D <= 256 ? 2 : 8; }

// Rows of G a block owns: one tile of rows, or D / 8 (rounded up to 4) where
// eight tiles do not cover D; the cluster size is then ceil(D / RB) <= 8.
inline int block_rows(int D) {
  const int bm = tile_rows(micro_rows(D));
  const int r = ((D + MAX_CLUSTER - 1) / MAX_CLUSTER + 3) / 4 * 4;
  return r > bm ? r : bm;
}

// Dynamic shared memory of a launch, in floats: the G slice and the ring.
// Its Python mirror is ns_step_smem_bytes in ops/cuda_kernels.py, which sets
// NS_STEP_SWITCH_D: change both together.
inline size_t smem_floats(int D) {
  const int TM = micro_rows(D);
  return (size_t)block_rows(D) * BN + (size_t)ring_stages(TM) * stage_floats(TM);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Depth chunk i of a product: columns [k0, kend) of the A operand. In the
// second product the chunk lies in one owner block's G slice, at local rows
// [lk0, lk0 + kend - k0).
struct Chunk {
  int k0, kend, owner, lk0;
};

__device__ __forceinline__ Chunk chunk_of(bool second, int i, int D, int RB, int per) {
  Chunk ch;
  if (second) {
    ch.owner = i / per;
    ch.lk0 = (i - ch.owner * per) * KC;
    ch.k0 = ch.owner * RB + ch.lk0;
    ch.kend = min(min(ch.owner * RB + RB, D), ch.k0 + KC);
  } else {
    ch.owner = 0;
    ch.lk0 = 0;
    ch.k0 = i * KC;
    ch.kend = min(ch.k0 + KC, D);
  }
  return ch;
}

// The chunk's depth rounded up to whole float4 steps (the rest zero-filled).
__device__ __forceinline__ int depth4(const Chunk& ch) {
  return ch.kend > ch.k0 ? (ch.kend - ch.k0 + 3) & ~3 : 0;
}

// Stage A[r0 + r, k0 + k] for r < BM, k < kc4 (row-major, stride LDA); zero
// where r0 + r >= rlim or k0 + k >= kend.
template <int TM, bool VEC>
__device__ __forceinline__ void stage_a(float* As, const float* __restrict__ A, int D, int r0,
                                        int rlim, const Chunk& ch, int kc4) {
  constexpr int BM = tile_rows(TM);
  if constexpr (VEC) {
#pragma unroll
    for (int t = 0; t < BM * (KC / 4) / NT; ++t) {
      const int e = threadIdx.x + t * NT, r = e >> 3, k = (e & 7) * 4;
      if (k >= kc4) continue;
      float* dst = As + r * LDA + k;
      if (r0 + r < rlim && ch.k0 + k < ch.kend)
        cp_async16(dst, A + (size_t)(r0 + r) * D + ch.k0 + k);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
#pragma unroll 4
    for (int t = 0; t < BM * KC / NT; ++t) {
      const int e = threadIdx.x + t * NT, r = e / KC, k = e % KC;
      if (k >= kc4) continue;
      float* dst = As + r * LDA + k;
      if (r0 + r < rlim && ch.k0 + k < ch.kend)
        cp_async4(dst, A + (size_t)(r0 + r) * D + ch.k0 + k);
      else
        *dst = 0.f;
    }
  }
}

// Stage X[k0 + k, j0 + j] for k < kc4, j < BN (stride BN); zero outside
// the chunk or past column D.
template <bool VEC>
__device__ __forceinline__ void stage_x(float* Bs, const float* __restrict__ X, int D, int j0,
                                        const Chunk& ch, int kc4) {
  if constexpr (VEC) {
#pragma unroll
    for (int t = 0; t < KC * (BN / 4) / NT; ++t) {
      const int e = threadIdx.x + t * NT, k = e >> 4, j = (e & 15) * 4;
      if (k >= kc4) continue;
      float* dst = Bs + k * BN + j;
      if (ch.k0 + k < ch.kend && j0 + j < D)
        cp_async16(dst, X + (size_t)(ch.k0 + k) * D + j0 + j);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
#pragma unroll 4
    for (int t = 0; t < KC * BN / NT; ++t) {
      const int e = threadIdx.x + t * NT, k = e / BN, j = e % BN;
      if (k >= kc4) continue;
      float* dst = Bs + k * BN + j;
      if (ch.k0 + k < ch.kend && j0 + j < D)
        cp_async4(dst, X + (size_t)(ch.k0 + k) * D + j0 + j);
      else
        *dst = 0.f;
    }
  }
}

// A G chunk, rows [lk0, lk0 + kc4) of an owner's slice, two float4 a lane.
// Rows past D in a slice hold zeros (their H rows were zero-filled).
constexpr int GV = KC * BN / 4 / NT;

__device__ __forceinline__ void load_g(float4 (&v)[GV], const float* Gr, int lk0, int kc4) {
#pragma unroll
  for (int i = 0; i < GV; ++i) {
    const int e = threadIdx.x + i * NT, k = e >> 4, j = (e & 15) * 4;
    v[i] = k < kc4 ? *reinterpret_cast<const float4*>(Gr + (lk0 + k) * BN + j)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ void store_g(float* Bs, const float4 (&v)[GV], int kc4) {
#pragma unroll
  for (int i = 0; i < GV; ++i) {
    const int e = threadIdx.x + i * NT, k = e >> 4, j = (e & 15) * 4;
    if (k < kc4) *reinterpret_cast<float4*>(Bs + k * BN + j) = v[i];
  }
}

__device__ __forceinline__ void fma4(float s, const float4& b, float (&c)[4]) {
  c[0] = fmaf(s, b.x, c[0]);
  c[1] = fmaf(s, b.y, c[1]);
  c[2] = fmaf(s, b.z, c[2]);
  c[3] = fmaf(s, b.w, c[3]);
}

// acc[m][q] += sum_{k < kc4} As[arow + m][k] Bs[k][bcol + q]
template <int TM>
__device__ __forceinline__ void fma_chunk(const float* As, const float* Bs, int kc4, int arow,
                                          int bcol, float (&acc)[TM][4]) {
  const float* pa = As + arow * LDA;
  const float* pb = Bs + bcol;
  auto step = [&](int k) {
    float4 a[TM];
#pragma unroll
    for (int m = 0; m < TM; ++m) a[m] = *reinterpret_cast<const float4*>(pa + m * LDA + k);
    const float4 b0 = *reinterpret_cast<const float4*>(pb + (k + 0) * BN);
    const float4 b1 = *reinterpret_cast<const float4*>(pb + (k + 1) * BN);
    const float4 b2 = *reinterpret_cast<const float4*>(pb + (k + 2) * BN);
    const float4 b3 = *reinterpret_cast<const float4*>(pb + (k + 3) * BN);
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      fma4(a[m].x, b0, acc[m]);
      fma4(a[m].y, b1, acc[m]);
      fma4(a[m].z, b2, acc[m]);
      fma4(a[m].w, b3, acc[m]);
    }
  };
  if (kc4 == KC) {  // a whole chunk: unrolled, so the loads run ahead of the FMAs
#pragma unroll
    for (int k = 0; k < KC; k += 4) step(k);
  } else {
#pragma unroll 1
    for (int k = 0; k < kc4; k += 4) step(k);
  }
}

// One product over a tile of BM rows from r0 (rows >= rlim read as zero):
//   kSecond = false: acc = A[rows, :] X[:, J], depth chunks of KC (RB,
//                    Gs and the cluster unused);
//   kSecond = true:  acc = X[rows, :] G[:, J], depth chunks inside each
//                    owner's slice of G.
// Ends with every stage free (barrier) and no copy in flight.
template <int TM, bool VEC, bool kSecond, class Cluster>
__device__ __forceinline__ void product(const float* __restrict__ A, const float* __restrict__ X,
                                        int D, int RB, int j0, int r0, int rlim,
                                        Cluster& cluster, float* Gs, float* ring,
                                        int arow, int bcol, float (&acc)[TM][4]) {
  constexpr int BM = tile_rows(TM), S = ring_stages(TM), STAGE = stage_floats(TM);
  const int per = (RB + KC - 1) / KC;
  const int n = kSecond ? (int)gridDim.x * per : (D + KC - 1) / KC;
  float4 g[S - 1][GV];

  // chunk i into stage i % S: A by cp.async; X[:, J] by cp.async, or the G
  // chunk into registers v (stored to the stage by the caller)
  auto issue = [&](int i, float4 (&v)[GV]) {
    const Chunk ch = chunk_of(kSecond, i, D, RB, per);
    const int kc4 = depth4(ch);
    float* As = ring + (i % S) * STAGE;
    stage_a<TM, VEC>(As, A, D, r0, rlim, ch, kc4);
    if constexpr (kSecond)
      load_g(v, cluster.map_shared_rank(Gs, ch.owner), ch.lk0, kc4);
    else
      stage_x<VEC>(As + BM * LDA, X, D, j0, ch, kc4);
    return kc4;
  };

#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[m][q] = 0.f;

  // prologue: the first S - 1 chunks, all their loads issued before any
  // G chunk is stored
  int kc4_pro[S - 1];
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    kc4_pro[s] = s < n ? issue(s, g[s]) : 0;
    cp_async_commit();
  }
  if constexpr (kSecond) {
#pragma unroll
    for (int s = 0; s < S - 1; ++s) store_g(ring + s * STAGE + BM * LDA, g[s], kc4_pro[s]);
  }
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    cp_async_wait<S - 2>();
    __syncthreads();  // chunk i visible to all; stage (i - 1) % S free
    const int nx = i + S - 1;
    const int kc4_nx = nx < n ? issue(nx, g[0]) : 0;
    cp_async_commit();
    const float* As = ring + (i % S) * STAGE;
    fma_chunk<TM>(As, As + BM * LDA, depth4(chunk_of(kSecond, i, D, RB, per)), arow, bcol, acc);
    if constexpr (kSecond)
      if (nx < n) store_g(ring + (nx % S) * STAGE + BM * LDA, g[0], kc4_nx);
  }
  cp_async_wait<0>();
  __syncthreads();
}

template <int TM, bool VEC>
__global__ void __launch_bounds__(NT, 2)
ns_step_kernel(const float* __restrict__ H, const float* __restrict__ X, float* __restrict__ out,
               int D, int RB) {
  constexpr int BM = tile_rows(TM);
  extern __shared__ float4 smem4[];
  float* Gs = reinterpret_cast<float*>(smem4);  // RB x BN: G[c RB + r, j0 + j]
  float* ring = Gs + RB * BN;

  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();  // == blockIdx.x: the grid is one cluster wide
  const int j0 = blockIdx.y * BN;
  const size_t off = (size_t)blockIdx.z * D * D;
  const float* Hb = H + off;
  const float* Xb = X + off;
  float* Ob = out + off;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int arow = (warp >> 1) * 4 * TM + (lane >> 3) * TM;  // the lane's first row in a tile
  const int bcol = (warp & 1) * 32 + (lane & 7) * 4;         // and its first column
  const int rbeg = c * RB, rend = min(rbeg + RB, D);

  float acc[TM][4];
  // (a) G[R_c, J] = H[R_c, :] X[:, J]
  for (int s0 = 0; s0 < RB; s0 += BM) {
    product<TM, VEC, false>(Hb, Xb, D, RB, j0, rbeg + s0, rend, cluster, Gs, ring, arow, bcol, acc);
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int r = s0 + arow + m;
      if (r < RB)
        *reinterpret_cast<float4*>(Gs + r * BN + bcol) =
            make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    }
  }
  cluster.sync();  // (b) every slice of G[:, J] complete and visible

  // (c) out[R_c, J] = 2 X[R_c, J] - X[R_c, :] G[:, J]
  for (int s0 = 0; s0 < RB; s0 += BM) {
    product<TM, VEC, true>(Xb, Xb, D, RB, j0, rbeg + s0, rend, cluster, Gs, ring, arow, bcol, acc);
    const int j = j0 + bcol;
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int r = rbeg + s0 + arow + m;
      if (r >= rend) continue;
      const float* x = Xb + (size_t)r * D + j;
      float* o = Ob + (size_t)r * D + j;
      if constexpr (VEC) {
        if (j < D) {
          const float4 v = *reinterpret_cast<const float4*>(x);
          *reinterpret_cast<float4*>(o) = make_float4(2.f * v.x - acc[m][0], 2.f * v.y - acc[m][1],
                                                      2.f * v.z - acc[m][2], 2.f * v.w - acc[m][3]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j + q < D) o[q] = 2.f * x[q] - acc[m][q];
      }
    }
  }
  cluster.sync();  // (d) no block leaves while another may still read its G
}

template <int TM, bool VEC>
int launch(const float* H, const float* X, float* out, int B, int D, cudaStream_t stream) {
  const int RB = block_rows(D);
  const unsigned CR = (unsigned)((D + RB - 1) / RB);
  const size_t smem = smem_floats(D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ns_step_kernel<TM, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CR;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CR, (unsigned)((D + BN - 1) / BN), (unsigned)B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ns_step_kernel<TM, VEC>, H, X, out, D, RB);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The wide path: one pass of out = op(A B) over a grid of BM x BN output
// tiles, (D / BM, D / BN, B), TM = 8, with the staging ring and register
// tiles of product(): kSecond = false writes G = H X (A = H, B = X),
// kSecond = true writes 2 X - X G (A = X, B = G).
template <bool VEC, bool kSecond>
__global__ void __launch_bounds__(NT, 2)
gemm_pass_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                 float* __restrict__ C, int D) {
  constexpr int TM = 8;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int r0 = blockIdx.x * tile_rows(TM), j0 = blockIdx.y * BN;
  const size_t off = (size_t)blockIdx.z * D * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int arow = (warp >> 1) * 4 * TM + (lane >> 3) * TM;
  const int bcol = (warp & 1) * 32 + (lane & 7) * 4;
  int no_cluster = 0;

  float acc[TM][4];
  product<TM, VEC, false>(A + off, Bm + off, D, KC, j0, r0, D, no_cluster, nullptr, ring, arow,
                          bcol, acc);
  const int j = j0 + bcol;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int r = r0 + arow + m;
    if (r >= D) continue;
    const float* x = A + off + (size_t)r * D + j;  // X[r, j] in the second pass
    float* o = C + off + (size_t)r * D + j;
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = kSecond ? 2.f * (j + q < D ? x[q] : 0.f) - acc[m][q] : acc[m][q];
    if constexpr (VEC) {
      if (j < D) *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (j + q < D) o[q] = v[q];
    }
  }
}

template <bool VEC>
int launch_wide(const float* H, const float* X, float* G, float* out, int B, int D,
                cudaStream_t stream) {
  const size_t smem = (size_t)ring_stages(8) * stage_floats(8) * sizeof(float);
  const dim3 grid((unsigned)((D + tile_rows(8) - 1) / tile_rows(8)),
                  (unsigned)((D + BN - 1) / BN), (unsigned)B);
  cudaError_t err = cudaFuncSetAttribute(gemm_pass_kernel<VEC, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gemm_pass_kernel<VEC, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gemm_pass_kernel<VEC, false><<<grid, NT, smem, stream>>>(H, X, G, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gemm_pass_kernel<VEC, true><<<grid, NT, smem, stream>>>(X, G, out, D);
  return (int)cudaGetLastError();
}

template <int TM>
int launch_tm(const float* H, const float* X, float* out, int B, int D, cudaStream_t stream) {
  const bool vec = D % 4 == 0 && (uintptr_t)H % 16 == 0 && (uintptr_t)X % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  return vec ? launch<TM, true>(H, X, out, B, D, stream)
             : launch<TM, false>(H, X, out, B, D, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success); a refused
// launch (shared memory, a cluster the card cannot schedule) returns its error.
// G: a (B, D, D) f32 workspace for G = H X, or null. With it the step runs
// as the wide path's two passes; without it as one cluster launch, which
// holds G in shared memory and is refused above the width where that fits
// (ns_step_smem_bytes in ops/cuda_kernels.py).
extern "C" int pgpfa_ns_step(const float* H, const float* X, float* G, float* out, int B, int D,
                             cudaStream_t stream) {
  if (G) {
    const bool vec = D % 4 == 0 && (uintptr_t)H % 16 == 0 && (uintptr_t)X % 16 == 0 &&
                     (uintptr_t)G % 16 == 0 && (uintptr_t)out % 16 == 0;
    return vec ? launch_wide<true>(H, X, G, out, B, D, stream)
               : launch_wide<false>(H, X, G, out, B, D, stream);
  }
  return micro_rows(D) == 2 ? launch_tm<2>(H, X, out, B, D, stream)
                            : launch_tm<8>(H, X, out, B, D, stream);
}
