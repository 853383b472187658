// Grouped expert matmul: out[e] = x[e] @ w[e] for every expert e.
//
//   x [E, R, D]; w [E, D, F]; out [E, R, F], all contiguous, one dtype
//   (fp32 or bf16).  The sum over D is taken in fp32 and written in the
//   input dtype.
//
// Replaces repro/kernels/moe_gmm.py:moe_gmm (Pallas).  On the TPU the D
// blocks were the innermost sequential grid axis, carrying the fp32 tile
// in VMEM scratch; Hopper blocks run in no order, so here the contraction
// over D is a loop inside the block, with the accumulators in registers.
//
// What bounds it: bytes.  The MoE layer's capacity dispatch gives every
// expert its R = n * C rows whether or not a token was routed there, so
// every call streams the whole weight tensor (E * D * F elements) while R
// is a few dozen rows (6 at a deepseek decode step, 12 to 64 at the
// server's prefill buckets): far below the card's ridge of ~295 flops per
// byte.  Only mixtral's R = 320 is bound by operations.  A work item is
// one (expert, tile of F, tile of rows) and holds ALL of the expert's rows
// when R <= 128, so each weight element is read from device memory once;
// more rows add row tiles, each of which reads the weights again (from
// L2, see below).
//
// bf16: tensor cores fed by a cp.async ring.  The plan (tile, grid,
// items) is a Python function of the shapes and the SM count only:
// repro_torch/kernels/moe_gmm.py:plan_gmm, which mirrors the walk below.
//   * A persistent grid of one block per SM walks the (expert, F tile,
//     row tile) items b, b + grid, b + 2 grid, ...; the ring runs on
//     across items, so the next item's tiles load while an item's last
//     step is multiplied and its output written.  Blocks running side by
//     side hold neighbouring F tiles of one expert, so device memory
//     serves whole rows of w, not scattered pieces (equal runs of (item,
//     step) per block balance the last round but scatter the rows, and
//     measured far slower).  Row tiles are the fastest index of an item,
//     so the blocks that share a tile of w run side by side and all but
//     one read it from L2.  The walk's cursors divide only at an item's
//     start: dividing at every step left the loop waiting on its own
//     address arithmetic.
//   * w and x reach shared memory in bf16 by cp.async (16 bytes, no
//     registers), one __syncthreads per ring step.  Where w is read once
//     (one row tile), its copies ask L2 for 256 bytes a miss and mark the
//     lines evict-first, which measured faster than either the plain copy
//     or the 256-byte fetch alone.
//   * R <= 8 (decode): mma.sync m16n8k16 computing out^T: F on the M side
//     (A = w^T by ldmatrix.trans from the [128][64] tile of w), the rows
//     on N = 8 (B by ldmatrix), so R = 6 wastes 2 of 8 lanes of N where
//     rows on M would waste 10 of 16.  Four warps of 16 columns; a ring
//     of 5 stages 128 deep keeps 4 x 16 KB of w in flight; rows padded by
//     16 bytes, so ldmatrix's eight row reads hit distinct bank groups.
//   * R > 8: wgmma m64n256k16, items of 128 rows x 256 columns, two
//     warpgroups of 64 rows, both operands in shared memory and swizzled
//     by 128 B (chunk c of row r at c ^ (r % 8)): x's [128][64] tile
//     K-major, w's [64][256] MN-major (transposed, four blocks of 64
//     columns); a ring of 4 stages 64 deep running 2 steps ahead, one
//     group of wgmmas left in flight while the next step is issued.  It
//     measured faster than mma.sync tiles of 16 to 128 rows at every R
//     from 12 up, and within 1% of the decode tile at R = 6.
//   * The summation order is fixed and there are no atomics: two runs
//     give identical bits.
// fp32 keeps the CUDA-core kernel (the tensor cores would compute in
// TF32, which cannot meet the fp32 limit of 1e-4): a block stages [64, 64]
// tiles of w and [BR, 64] of x in shared memory as fp32, the next step's
// loaded into registers while the current one is multiplied; each thread
// owns 4 columns of 8 rows over one of 128 / BR slices of the tile's
// depth, summed at the end through warp shuffles and shared memory.
//
// The ragged edge (R, D, F not multiples of the tiles, or rows not
// 16-byte aligned) is masked with zeros in all three; nothing needs
// divisibility.  Where rows are not 16-byte aligned the bf16 kernels
// stage that operand through registers instead of cp.async.
#include "gmm.cuh"

namespace {

using namespace gmm;

// planted faults, for the checks only (repro_torch/kernels/moe_gmm.py)
constexpr int kStaleTile = 1;     // each w stage holds the step before's tile
constexpr int kDropRowGroup = 2;  // the last 8-row group of R left out

// ------------------------------------------- bf16, R <= 8: mma.sync --
constexpr int M_BF = 64, M_BR = 8, M_BD = 128, M_STAGES = 5;
constexpr int M_THREADS = 128;                 // 4 warps of 16 columns
constexpr int PAD = 8;                         // bf16 padding per row (16 B)
constexpr int M_WS = M_BF + PAD, M_XS = M_BD + PAD;  // shared row strides
constexpr int M_STAGE = M_BD * M_WS + M_BR * M_XS;   // [128][72] + [8][136]
constexpr int M_SMEM_BYTES = M_STAGES * M_STAGE * 2;

// rows [0, ROWS) x 16-byte chunks [0, COLS / 8) of a tile into dst (row
// stride DS) from src (row stride `stride`), rows >= n_rows and columns
// >= n_cols as zeros
template <int ROWS, int COLS, int DS, bool ONCE>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           size_t stride, int n_rows,
                                           int n_cols, bool vec, int tid) {
  constexpr int CPR = COLS / 8;
  constexpr int CHUNKS = ROWS * CPR;
#pragma unroll
  for (int k = 0; k < (CHUNKS + M_THREADS - 1) / M_THREADS; ++k) {
    const int i = tid + k * M_THREADS;
    if (CHUNKS % M_THREADS != 0 && i >= CHUNKS) break;
    const int r = i / CPR, c = (i % CPR) * 8;
    stage_chunk<ONCE>(dst + r * DS + c,
                      src + static_cast<size_t>(r) * stride + c, src,
                      r < n_rows ? min(8, n_cols - c) : 0, vec);
  }
}

__global__ void __launch_bounds__(M_THREADS, 1)
    moe_gmm_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       bf16* __restrict__ out, int R, int D, int F,
                       int n_items, int f_tiles, int r_tiles, int x_vec,
                       int w_vec, int fault) {
  extern __shared__ __align__(16) unsigned char gmm_smem[];
  bf16* smem = reinterpret_cast<bf16*>(gmm_smem);
  const int tid = threadIdx.x, lane = tid % 32;
  const int f_warp = (tid / 32) * 16;  // the warp's 16 columns of the item
  const int k_steps = max(1, (D + M_BD - 1) / M_BD);
  const int steps = block_steps(n_items, k_steps);
  const int grid = gridDim.x;

  // the loader's cursor runs M_STAGES - 1 ring steps ahead of the product's
  Cursor ld{0, 0, 0, 0, 0}, cu{0, 0, 0, 0, 0};
  ld.seek(blockIdx.x, f_tiles, r_tiles, M_BF, M_BR);
  cu.seek(blockIdx.x, f_tiles, r_tiles, M_BF, M_BR);
  int ld_stage = 0;
  auto load = [&]() {
    const int dx = ld.ks * M_BD;
    const int dw = fault == kStaleTile && ld.ks > 0 ? dx - M_BD : dx;
    bf16* sw = smem + ld_stage * M_STAGE;
    // all R <= 8 rows in one item: w is read once
    stage_tile<M_BD, M_BF, M_WS, true>(
        sw, w + (static_cast<size_t>(ld.e) * D + dw) * F + ld.f0, F, D - dw,
        F - ld.f0, w_vec, tid);
    stage_tile<M_BR, M_BD, M_XS, false>(
        sw + M_BD * M_WS,
        x + (static_cast<size_t>(ld.e) * R + ld.r0) * D + dx, D, R - ld.r0,
        D - dx, x_vec, tid);
    ld_stage = ld_stage + 1 == M_STAGES ? 0 : ld_stage + 1;
    ld.step(k_steps, grid, f_tiles, r_tiles, M_BF, M_BR);
  };

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int s = 0; s < M_STAGES - 1; ++s) {
    if (s < steps) load();
    cp_async_commit();  // possibly empty: every thread counts alike
  }
  int stage = 0;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<M_STAGES - 2>();
    __syncthreads();  // step s has landed; step s - 1's stage is consumed
    if (s + M_STAGES - 1 < steps) load();
    cp_async_commit();

    const bf16* sw = smem + stage * M_STAGE;
    const bf16* sx = sw + M_BD * M_WS;
    stage = stage + 1 == M_STAGES ? 0 : stage + 1;
    // the item's rows, unless, as a planted fault, they are R's last
    // 8-row group
    const bool live =
        cu.r0 < R && !(fault == kDropRowGroup && cu.r0 + M_BR >= R);
    if (live) {
#pragma unroll
      for (int kc = 0; kc < M_BD / 32; ++kc) {
        // B: the 8 rows at depths 32 kc + [0, 32), two k-steps
        unsigned b[4];
        ldmatrix_x4(b, sx + (lane & 7) * M_XS + 32 * kc + (lane >> 3) * 8);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          // A = w^T: columns f_warp + [0, 16), depths 32 kc + 16 kk +
          // [0, 16), transposed on the way in
          unsigned a[4];
          ldmatrix_x4_trans(
              a, sw + (32 * kc + 16 * kk + (lane & 7) +
                       ((lane >> 4) & 1) * 8) * M_WS +
                     f_warp + ((lane >> 3) & 1) * 8);
          mma_bf16_16816(acc, a, b[2 * kk], b[2 * kk + 1]);
        }
      }
    }

    const int e = cu.e, f0 = cu.f0, r0 = cu.r0;
    if (cu.step(k_steps, grid, f_tiles, r_tiles, M_BF, M_BR)) {
      // the item is summed: write it, start anew
      bf16* oe = out + static_cast<size_t>(e) * R * F;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // d[i] of m16n8: F column lane / 4 (+ 8), row 2 (lane % 4)
        const int f = f0 + f_warp + lane / 4 + (i >> 1) * 8;
        const int r = r0 + 2 * (lane % 4) + (i & 1);
        if (r < R && f < F)
          oe[static_cast<size_t>(r) * F + f] = __float2bfloat16_rn(acc[i]);
        acc[i] = 0.f;
      }
    }
  }
  cp_async_wait<0>();
}

// ------------------------------------------------- bf16, R > 8: wgmma --
constexpr int G_BR = 128, G_BN = 256, G_BD = 64, G_STAGES = 4;
constexpr int G_THREADS = 256;                 // two warpgroups of 64 rows
constexpr int G_X_BYTES = G_BR * G_BD * 2;     // [128][64]: 128-byte rows
constexpr int G_W_BYTES = G_BD * G_BN * 2;     // four [64][64] blocks
constexpr int G_STAGE = G_X_BYTES + G_W_BYTES;
// + 1 KB to put the ring on a 1024-byte boundary (the swizzle's period)
constexpr int G_SMEM_BYTES = G_STAGES * G_STAGE + 1024;

// ONCE: one row tile, so w is read once
template <bool ONCE>
__global__ void __launch_bounds__(G_THREADS, 1)
    moe_gmm_wgmma_kernel(const bf16* __restrict__ x,
                         const bf16* __restrict__ w, bf16* __restrict__ out,
                         int R, int D, int F, int n_items, int f_tiles,
                         int r_tiles, int x_vec, int w_vec, int fault) {
  extern __shared__ __align__(16) unsigned char gmm_smem[];
  unsigned char* ring = gmm_smem + ((1024 - static_cast<int>(
      __cvta_generic_to_shared(gmm_smem) & 1023)) & 1023);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4;  // this warpgroup's 64 rows of the item
  const int k_steps = max(1, (D + G_BD - 1) / G_BD);
  const int steps = block_steps(n_items, k_steps);
  const int grid = gridDim.x;

  Cursor ld{0, 0, 0, 0, 0}, cu{0, 0, 0, 0, 0};
  ld.seek(blockIdx.x, f_tiles, r_tiles, G_BN, G_BR);
  cu.seek(blockIdx.x, f_tiles, r_tiles, G_BN, G_BR);
  int ld_stage = 0;
  auto load = [&]() {
    const int dx = ld.ks * G_BD;
    const int dw = fault == kStaleTile && ld.ks > 0 ? dx - G_BD : dx;
    unsigned char* st = ring + ld_stage * G_STAGE;
    bf16* xs = reinterpret_cast<bf16*>(st);
    bf16* ws = reinterpret_cast<bf16*>(st + G_X_BYTES);
    const bf16* xe = x + (static_cast<size_t>(ld.e) * R + ld.r0) * D + dx;
    const bf16* we = w + (static_cast<size_t>(ld.e) * D + dw) * F + ld.f0;
#pragma unroll
    for (int k = 0; k < G_BR * 8 / G_THREADS; ++k) {  // x: 128 rows x 8
      const int i = tid + G_THREADS * k, r = i / 8, c = i % 8;
      const int n = ld.r0 + r < R ? D - dx - 8 * c : 0;
      stage_chunk<false>(xs + sw128(r, c) / 2,
                         xe + static_cast<size_t>(r) * D + 8 * c, x,
                         min(n, 8), x_vec);
    }
#pragma unroll
    for (int k = 0; k < G_BD * G_BN / 8 / G_THREADS; ++k) {  // w: 64 x 32
      const int i = tid + G_THREADS * k, r = i / (G_BN / 8), c = i % (G_BN / 8);
      const int n = dw + r < D ? F - ld.f0 - 8 * c : 0;
      stage_chunk<ONCE>(ws + ((c / 8) * 8192 + sw128(r, c % 8)) / 2,
                        we + static_cast<size_t>(r) * F + 8 * c, w,
                        min(n, 8), w_vec);
    }
    ld_stage = ld_stage + 1 == G_STAGES ? 0 : ld_stage + 1;
    ld.step(k_steps, grid, f_tiles, r_tiles, G_BN, G_BR);
  };

  float acc[G_BN / 2];
#pragma unroll
  for (int i = 0; i < G_BN / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < G_STAGES - 2; ++s) {
    if (s < steps) load();
    cp_async_commit();
  }
  int stage = 0;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<G_STAGES - 3>();
    fence_proxy_async();  // the landed chunks, to wgmma's async proxy
    // step s has landed, and every warpgroup's products of step s - 2
    // are done (each waits below for all but its newest group), so that
    // step's stage is free
    __syncthreads();
    if (s + G_STAGES - 2 < steps) load();
    cp_async_commit();

    const unsigned char* st = ring + stage * G_STAGE;
    stage = stage + 1 == G_STAGES ? 0 : stage + 1;
    const bool live = cu.r0 + 64 * wg < R;  // rows 64 wg + [0, 64)
    const bool item_end = cu.ks + 1 == k_steps;
    if (live) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < G_BD / 16; ++kk) {
        // x: rows 64 wg.., depth 16 kk.. (32 bytes into each 128-B row);
        // w: depth rows 16 kk.. (2 KB each), four 64-column blocks
        const unsigned long long da =
            gmma_desc(st + 64 * wg * 128 + 32 * kk, 16, 1024);
        const unsigned long long db =
            gmma_desc(st + G_X_BYTES + 16 * kk * 128, 8192, 1024);
        wgmma_bf16_256<0, 1>(acc, da, db);  // x K-major, w MN-major
      }
      wgmma_commit();
      if (item_end)
        wgmma_wait<0>();  // the sums are read below
      else
        wgmma_wait<1>();
    }

    const int e = cu.e, f0 = cu.f0, r0 = cu.r0;
    if (cu.step(k_steps, grid, f_tiles, r_tiles, G_BN, G_BR)) {
      // the item is summed: write it, start anew; as a planted fault R's
      // last 8-row group is written as zeros
      const int rbase = r0 + 64 * wg + 16 * (warp % 4) + lane / 4;
      const int drop = fault == kDropRowGroup ? (R - 1) / 8 * 8 : R;
      bf16* oe = out + static_cast<size_t>(e) * R * F;
#pragma unroll
      for (int j = 0; j < G_BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rbase + 8 * (i >> 1);
          const int f = f0 + 8 * j + 2 * (lane % 4) + (i & 1);
          if (live && r < R && f < F)
            oe[static_cast<size_t>(r) * F + f] =
                __float2bfloat16_rn(r < drop ? acc[4 * j + i] : 0.f);
          acc[4 * j + i] = 0.f;
        }
    }
  }
  cp_async_wait<0>();
}

// The kernels' signature; each has its dynamic shared memory raised above
// 48 KB once, before its first launch.
using GmmKernel = void (*)(const bf16*, const bf16*, bf16*, int, int, int,
                           int, int, int, int, int, int);

template <GmmKernel K, int SMEM>
cudaError_t raise_smem() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      K, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  return attr;
}

// tile 0: mma.sync (R <= 8); tile 1: wgmma (R > 8), w read once where
// there is one row tile
int launch_bf16(int tile, const void* x, const void* w, void* out, int R,
                int D, int F, int n_items, int f_tiles, int r_tiles,
                int grid, int x_vec, int w_vec, int fault,
                cudaStream_t stream) {
  GmmKernel kernel;
  int smem, threads;
  cudaError_t attr;
  if (tile == 0) {
    kernel = moe_gmm_mma_kernel;
    smem = M_SMEM_BYTES;
    threads = M_THREADS;
    attr = raise_smem<moe_gmm_mma_kernel, M_SMEM_BYTES>();
  } else if (tile == 1) {
    kernel = r_tiles == 1 ? moe_gmm_wgmma_kernel<true>
                          : moe_gmm_wgmma_kernel<false>;
    smem = G_SMEM_BYTES;
    threads = G_THREADS;
    attr = r_tiles == 1
               ? raise_smem<moe_gmm_wgmma_kernel<true>, G_SMEM_BYTES>()
               : raise_smem<moe_gmm_wgmma_kernel<false>, G_SMEM_BYTES>();
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(out), R, D, F, n_items, f_tiles, r_tiles, x_vec,
      w_vec, fault);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ fp32: CUDA cores --
constexpr int F_BF = 64;          // output columns per block
constexpr int F_BD = 64;          // contraction depth per shared-memory step
constexpr int F_THREADS = 256;    // 16 column groups of 4 x 16 lanes

template <int BR>
__global__ void __launch_bounds__(F_THREADS)
    moe_gmm_f32_kernel(const float* __restrict__ x,
                       const float* __restrict__ w, float* __restrict__ out,
                       int R, int D, int F, int x_vec, int w_vec) {
  using T = float;
  constexpr int BF = F_BF, THREADS = F_THREADS;
  constexpr int V = 4;                           // elements per 16 bytes
  constexpr int KS = 128 / BR;                   // slices of the D tile
  constexpr int W_SEGS = F_BD * BF / V;            // 16-byte segments of w
  constexpr int X_SEGS = BR * F_BD / V;            // ... and of x
  constexpr int W_PER = (W_SEGS + THREADS - 1) / THREADS;
  constexpr int X_PER = (X_SEGS + THREADS - 1) / THREADS;
  // Ws also holds the KS / 2 partial sums at the end: KS * BR * BF / 2
  // floats = F_BD * BF
  __shared__ __align__(16) float Ws[F_BD][BF];
  __shared__ __align__(16) float Xs[F_BD][BR + 4];  // transposed, padded

  const int f0 = blockIdx.x * BF, e = blockIdx.y, r0 = blockIdx.z * BR;
  // thread t: columns 4 * cg + [0, 4) of rows 8 * rg + [0, 8), over the
  // depths dd = ks (mod KS) of each tile; the two halves of a warp hold
  // neighbouring slices ks, ks + 1 of the same rows
  const int cg = threadIdx.x % 16, l = threadIdx.x / 16;
  const int ks = l % KS, rg = l / KS;
  const T* xe = x + static_cast<size_t>(e) * R * D;
  const T* we = w + static_cast<size_t>(e) * D * F;

  Vec<T, V> wr[W_PER], xr[X_PER];   // the next step's tiles, as loaded
  auto load = [&](int d0) {
#pragma unroll
    for (int i = 0; i < W_PER; ++i) {
      const int s = threadIdx.x + i * THREADS;
      const int dd = s / (BF / V), c = (s % (BF / V)) * V;
      const int n = (s < W_SEGS && d0 + dd < D) ? min(V, F - f0 - c) : 0;
      wr[i] = load_seg<T, V>(we + static_cast<size_t>(d0 + dd) * F + f0 + c,
                             n, w_vec);
    }
#pragma unroll
    for (int i = 0; i < X_PER; ++i) {
      const int s = threadIdx.x + i * THREADS;
      const int r = s / (F_BD / V), dd = (s % (F_BD / V)) * V;
      const int n = (s < X_SEGS && r0 + r < R) ? min(V, D - d0 - dd) : 0;
      xr[i] = load_seg<T, V>(xe + static_cast<size_t>(r0 + r) * D + d0 + dd,
                             n, x_vec);
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < W_PER; ++i) {
      const int s = threadIdx.x + i * THREADS;
      if (s < W_SEGS) {
        const int dd = s / (BF / V), c = (s % (BF / V)) * V;
        *reinterpret_cast<float4*>(&Ws[dd][c]) = make_float4(
            wr[i].v[0], wr[i].v[1], wr[i].v[2], wr[i].v[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < X_PER; ++i) {
      const int s = threadIdx.x + i * THREADS;
      if (s < X_SEGS) {
        const int r = s / (F_BD / V), dd = (s % (F_BD / V)) * V;
#pragma unroll
        for (int j = 0; j < V; ++j) Xs[dd + j][r] = xr[i].v[j];
      }
    }
  };

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load(0);
  for (int d0 = 0; d0 < D; d0 += F_BD) {
    __syncthreads();  // the previous tiles are consumed
    stage();
    __syncthreads();
    if (d0 + F_BD < D) load(d0 + F_BD);  // in flight while this tile is used
#pragma unroll
    for (int dd = ks; dd < F_BD; dd += KS) {
      const float4 wv = *reinterpret_cast<const float4*>(&Ws[dd][4 * cg]);
      const float4 xa = *reinterpret_cast<const float4*>(&Xs[dd][8 * rg]);
      const float4 xb =
          *reinterpret_cast<const float4*>(&Xs[dd][8 * rg + 4]);
      const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][0] += xv[i] * wv.x;
        acc[i][1] += xv[i] * wv.y;
        acc[i][2] += xv[i] * wv.z;
        acc[i][3] += xv[i] * wv.w;
      }
    }
  }

  // sum the KS slices in a fixed order: the warp's halves first, then the
  // KS / 2 pair sums through shared memory
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 16);
  float* part = &Ws[0][0];  // [KS / 2][BR][BF]
  __syncthreads();          // the last tile is consumed
  if (ks % 2 == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float4*>(
          &part[((ks / 2) * BR + 8 * rg + i) * BF + 4 * cg]) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BR * BF; idx += THREADS) {
    const int r = idx / BF, c = idx % BF;
    if (r0 + r >= R || f0 + c >= F) continue;
    float sum = 0.f;
#pragma unroll
    for (int p = 0; p < KS / 2; ++p) sum += part[(p * BR + r) * BF + c];
    out[(static_cast<size_t>(e) * R + r0 + r) * F + f0 + c] = sum;
  }
}

template <int BR>
void launch_f32(const void* x, const void* w, void* out, int E, int R, int D,
                int F, int x_vec, int w_vec, cudaStream_t stream) {
  const dim3 grid((F + F_BF - 1) / F_BF, E, (R + BR - 1) / BR);
  moe_gmm_f32_kernel<BR><<<grid, F_THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), R, D, F, x_vec, w_vec);
}

// The row tile: the smallest of 8, 16, 32, 64 that holds all R rows, else
// 64 with a grid axis over row tiles.
int launch_f32_rows(const void* x, const void* w, void* out, int E, int R,
                    int D, int F, int x_vec, int w_vec, cudaStream_t stream) {
  if (R <= 8)
    launch_f32<8>(x, w, out, E, R, D, F, x_vec, w_vec, stream);
  else if (R <= 16)
    launch_f32<16>(x, w, out, E, R, D, F, x_vec, w_vec, stream);
  else if (R <= 32)
    launch_f32<32>(x, w, out, E, R, D, F, x_vec, w_vec, stream);
  else
    launch_f32<64>(x, w, out, E, R, D, F, x_vec, w_vec, stream);
  return static_cast<int>(cudaGetLastError());
}


}  // namespace

// x_vec / w_vec: 1 when every row of x (w) starts on a 16-byte boundary,
// so whole segments may be read as one 16-byte load.  bf16 takes the
// plan of plan_gmm (tile, n_items, f_tiles, r_tiles, grid) and a planted
// fault (0 for none); fp32 ignores them.
extern "C" int moe_gmm_launch(const void* x, const void* w, void* out, int E,
                              int R, int D, int F, int x_vec, int w_vec,
                              int dtype, int tile, int n_items, int f_tiles,
                              int r_tiles, int grid, int fault,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_f32_rows(x, w, out, E, R, D, F, x_vec, w_vec, s);
  if (dtype == kBFloat16)
    return launch_bf16(tile, x, w, out, R, D, F, n_items, f_tiles, r_tiles,
                       grid, x_vec, w_vec, fault, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
