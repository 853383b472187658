// Gradient of the grouped expert matmul (moe_gmm.cu): given x [E, R, D],
// w [E, D, F] and dy = dL/dout [E, R, F], all contiguous in one dtype
// (fp32 or bf16), it writes
//
//   dx[e] = dy[e] w[e]^T   [E, R, D]   (a sum over F)
//   dw[e] = x[e]^T dy[e]   [E, D, F]   (a sum over the R capacity rows)
//
// each sum taken in fp32 and written in the inputs' dtype.
//
// The port's own: the TPU kernel repro/kernels/moe_gmm.py has no backward,
// and the reference differentiates its einsums (repro/models/moe.py:93-96)
// with jax.grad.
//
// What bounds it on the H100: bytes.  At deepseek-v2-lite-16b's train row
// (E 64, R 128, D 2048, F 1408) launch dx reads all of w (369 MB) and
// launch dw writes all of dw (369 MB), each for ~47 GFLOP (~0.05 ms at the
// bf16 peak against ~0.13 ms of bytes).
//   * Two launches in order on one stream, dx then dw.  A block owns whole
//     output tiles and sums each one's contraction in registers: no
//     atomics and no scratch, so two runs give the same bits.
//   * bf16: the forward's wgmma kernel, with each operand read as it is
//     stored and wgmma's transpose bits saying which of its axes is
//     contiguous, so neither product copies an operand transposed.  A
//     persistent grid of one block per SM walks (expert, N tile, M tile)
//     items of 128 x 256 outputs (two warpgroups of 64 rows), M tiles
//     fastest; both operands reach shared memory by cp.async through a
//     ring of four stages 64 deep, swizzled by 128 B, which runs on across
//     items.  dw's outputs leave through the two ring stages no load is
//     filling, so device memory sees whole rows in 16-byte stores.  The
//     plan (items, tiles, grid) is a Python function of the shapes and the
//     SM count: repro_torch/kernels/moe_gmm.py:plan_gmm_backward.
//       dx: M = R, N = D, the sum over F.  A = dy [R][F], K-major (as the
//           forward's x); B = w^T, read from w [D][F] as stored: 256 rows
//           of D, each 64 contiguous F, K-major.  Where one M tile holds
//           all of R, each element of w is read once, evict-first.
//       dw: M = D, N = F, the sum over R.  A = x^T, read from x [R][D]:
//           64 rows of R, each 128 contiguous D, MN-major; B = dy [R][F]:
//           64 rows of R, each 256 contiguous F, MN-major (as the
//           forward's w).  An expert's x and dy (0.9 MB at the train row)
//           stay in L2 while the blocks side by side walk its items.
//   * fp32 (the parity path) stays on the CUDA cores, as the forward's
//     fp32 path does (TF32 could not meet the fp32 limit): a block per
//     64 x 64 output tile, 16-deep tiles of both operands staged in shared
//     memory along whichever of their axes is contiguous, each thread
//     summing a 4 x 4 patch.
// No divisibility of R, D or F is required: the ragged edge is masked
// with zeros, and an operand whose rows are not 16-byte aligned is staged
// through registers.
#include "gmm.cuh"

namespace {

using namespace gmm;

constexpr int kDx = 0, kDw = 1;  // the two launches
// planted faults, for the checks only (repro_torch/kernels/moe_gmm.py)
constexpr int kStaleTile = 1;     // dx: each w stage holds the step before's F
constexpr int kDropRowGroup = 2;  // dw: the last 8-row group of R left out

// ------------------------------------------------------ bf16: wgmma --
constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int THREADS = 256;                  // two warpgroups of 64 rows
constexpr int A_BYTES = BM * BK * 2;          // 16 KB
constexpr int B_BYTES = BK * BN * 2;          // 32 KB
constexpr int STAGE = A_BYTES + B_BYTES;
// + 1 KB to put the ring on a 1024-byte boundary (the swizzle's period)
constexpr int SMEM_BYTES = STAGES * STAGE + 1024;

// The 128 threads of warpgroup wg wait for each other (named barrier
// 1 + wg; barrier 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// MODE kDx: a = dy, b = w, out = dx; kDw: a = x, b = dy, out = dw.
// ONCE: b is read once (kDx with one M tile).
template <int MODE, bool ONCE>
__global__ void __launch_bounds__(THREADS, 1)
    gmm_bwd_wgmma_kernel(const bf16* __restrict__ a,
                         const bf16* __restrict__ b, bf16* __restrict__ out,
                         int R, int D, int F, int n_items, int n_tiles,
                         int m_tiles, int a_vec, int b_vec, int fault) {
  extern __shared__ __align__(16) unsigned char gmm_smem[];
  unsigned char* ring = gmm_smem + ((1024 - static_cast<int>(
      __cvta_generic_to_shared(gmm_smem) & 1023)) & 1023);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4;  // this warpgroup's 64 rows of the item
  const int M = MODE == kDx ? R : D, N = MODE == kDx ? D : F;
  const int K = MODE == kDx ? F : R;
  // the rows of R that take part in dw's sum (all but a planted fault)
  const int k_rows = fault == kDropRowGroup ? (R - 1) / 8 * 8 : R;
  const int k_steps = max(1, (K + BK - 1) / BK);
  const int steps = block_steps(n_items, k_steps);
  const int grid = gridDim.x;

  Cursor ld{0, 0, 0, 0, 0}, cu{0, 0, 0, 0, 0};
  ld.seek(blockIdx.x, n_tiles, m_tiles, BN, BM);
  cu.seek(blockIdx.x, n_tiles, m_tiles, BN, BM);
  int ld_stage = 0;
  auto load = [&]() {
    const int k0 = ld.ks * BK;
    unsigned char* st = ring + ld_stage * STAGE;
    bf16* as = reinterpret_cast<bf16*>(st);
    bf16* bs = reinterpret_cast<bf16*>(st + A_BYTES);
    if (MODE == kDx) {
      const int kb = fault == kStaleTile && ld.ks > 0 ? k0 - BK : k0;
      const bf16* ae = a + (static_cast<size_t>(ld.e) * R + ld.r0) * F + k0;
      const bf16* be = b + (static_cast<size_t>(ld.e) * D + ld.f0) * F + kb;
#pragma unroll
      for (int k = 0; k < BM * 8 / THREADS; ++k) {  // dy: 128 rows of R x 8
        const int i = tid + THREADS * k, r = i / 8, c = i % 8;
        const int n = ld.r0 + r < R ? F - k0 - 8 * c : 0;
        stage_chunk<false>(as + sw128(r, c) / 2,
                           ae + static_cast<size_t>(r) * F + 8 * c, a,
                           min(n, 8), a_vec);
      }
#pragma unroll
      for (int k = 0; k < BN * 8 / THREADS; ++k) {  // w: 256 rows of D x 8
        const int i = tid + THREADS * k, r = i / 8, c = i % 8;
        const int n = ld.f0 + r < D ? F - kb - 8 * c : 0;
        stage_chunk<ONCE>(bs + sw128(r, c) / 2,
                          be + static_cast<size_t>(r) * F + 8 * c, b,
                          min(n, 8), b_vec);
      }
    } else {
      const bf16* ae = a + (static_cast<size_t>(ld.e) * R + k0) * D + ld.r0;
      const bf16* be = b + (static_cast<size_t>(ld.e) * R + k0) * F + ld.f0;
#pragma unroll
      for (int k = 0; k < BK * BM / 8 / THREADS; ++k) {  // x: 64 of R x 16
        const int i = tid + THREADS * k, r = i / (BM / 8), c = i % (BM / 8);
        const int n = k0 + r < k_rows ? D - ld.r0 - 8 * c : 0;
        stage_chunk<false>(as + ((c / 8) * 8192 + sw128(r, c % 8)) / 2,
                           ae + static_cast<size_t>(r) * D + 8 * c, a,
                           min(n, 8), a_vec);
      }
#pragma unroll
      for (int k = 0; k < BK * BN / 8 / THREADS; ++k) {  // dy: 64 of R x 32
        const int i = tid + THREADS * k, r = i / (BN / 8), c = i % (BN / 8);
        const int n = k0 + r < k_rows ? F - ld.f0 - 8 * c : 0;
        stage_chunk<false>(bs + ((c / 8) * 8192 + sw128(r, c % 8)) / 2,
                           be + static_cast<size_t>(r) * F + 8 * c, b,
                           min(n, 8), b_vec);
      }
    }
    ld_stage = ld_stage + 1 == STAGES ? 0 : ld_stage + 1;
    ld.step(k_steps, grid, n_tiles, m_tiles, BN, BM);
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < steps) load();
    cp_async_commit();  // possibly empty: every thread counts alike
  }
  int stage = 0;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 3>();
    fence_proxy_async();  // the landed chunks, to wgmma's async proxy
    // step s has landed, and every warpgroup's products of step s - 2
    // are done (each waits below for all but its newest group), so that
    // step's stage is free
    __syncthreads();
    if (s + STAGES - 2 < steps) load();
    cp_async_commit();

    const unsigned char* st = ring + stage * STAGE;
    stage = stage + 1 == STAGES ? 0 : stage + 1;
    const bool live = cu.r0 + 64 * wg < M;  // rows 64 wg + [0, 64)
    const bool item_end = cu.ks + 1 == k_steps;
    if (live) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        if (MODE == kDx) {
          // both K-major: 16 depths are 32 bytes into each 128-byte row
          // (dy: the warpgroup's 64 rows; w: all 256)
          const unsigned long long da =
              gmma_desc(st + 64 * wg * 128 + 32 * kk, 16, 1024);
          const unsigned long long db =
              gmma_desc(st + A_BYTES + 32 * kk, 16, 1024);
          wgmma_bf16_256<0, 0>(acc, da, db);
        } else {
          // both MN-major: depth rows 16 kk.. (2 KB each); x's 64 rows of
          // the warpgroup are the 64-column block wg, dy's four blocks
          const unsigned long long da =
              gmma_desc(st + wg * 8192 + 16 * kk * 128, 8192, 1024);
          const unsigned long long db =
              gmma_desc(st + A_BYTES + 16 * kk * 128, 8192, 1024);
          wgmma_bf16_256<1, 1>(acc, da, db);
        }
      }
      wgmma_commit();
      if (item_end)
        wgmma_wait<0>();  // the sums are read below
      else
        wgmma_wait<1>();
    }

    const int e = cu.e, n0 = cu.f0, m0 = cu.r0;
    if (cu.step(k_steps, grid, n_tiles, m_tiles, BN, BM)) {
      // the item is summed: write it, start anew.  dw (two ring steps an
      // item, 369 MB of output at the train row) writes through shared
      // memory, so device memory sees whole rows in 16-byte stores: the
      // loads in flight fill the stages of steps s + 1 and s + 2, and the
      // stages of steps s and s - 1, free once both warpgroups' products
      // are done, take one warpgroup's [64][BN + 8] tile each, which
      // measured faster at the train row; dx (22 steps an item) stores two
      // columns a thread from the registers, which measured faster there
      // (the staged form costs it registers and spills).
      if constexpr (MODE == kDw) {
        __syncthreads();
        if (live) {
          const int cur = (stage + STAGES - 1) % STAGES;
          bf16* tile = reinterpret_cast<bf16*>(
              ring + (wg == 0 ? cur : (cur + STAGES - 1) % STAGES) * STAGE);
          constexpr int TS = BN + 8;  // row stride: 16 bytes of pad
          const int rl = 16 * (warp % 4) + lane / 4;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<unsigned*>(tile + (rl + 8 * h) * TS + 8 * j +
                                           2 * (lane % 4)) =
                  pack_bf16x2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          warpgroup_sync(wg);
          const int rows = min(64, M - m0 - 64 * wg), cols = min(BN, N - n0);
          bf16* oe =
              out + (static_cast<size_t>(e) * M + m0 + 64 * wg) * N + n0;
          const int t = tid % 128;
          if (N % 8 == 0) {  // whole 16-byte chunks, each 16-byte aligned
            for (int i = t; i < rows * (BN / 8); i += 128) {
              const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
              if (c < cols)
                *reinterpret_cast<uint4*>(oe + static_cast<size_t>(r) * N +
                                          c) =
                    *reinterpret_cast<const uint4*>(tile + r * TS + c);
            }
          } else {
            for (int i = t; i < rows * BN; i += 128) {
              const int r = i / BN, c = i % BN;
              if (c < cols)
                oe[static_cast<size_t>(r) * N + c] = tile[r * TS + c];
            }
          }
        }
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      } else {
        const int r_lo = m0 + 64 * wg + 16 * (warp % 4) + lane / 4;
        bf16* oe = out + static_cast<size_t>(e) * M * N;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r_lo + 8 * h;
            const int c = n0 + 8 * j + 2 * (lane % 4);
            const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
            bf16* o = oe + static_cast<size_t>(r) * N + c;
            if (live && r < M) {
              if (N % 2 == 0 && c + 1 < N) {
                *reinterpret_cast<unsigned*>(o) = pack_bf16x2(v0, v1);
              } else {
                if (c < N) o[0] = __float2bfloat16_rn(v0);
                if (c + 1 < N) o[1] = __float2bfloat16_rn(v1);
              }
            }
            acc[4 * j + 2 * h] = acc[4 * j + 2 * h + 1] = 0.f;
          }
      }
    }
  }
  cp_async_wait<0>();
}

using BwdKernel = void (*)(const bf16*, const bf16*, bf16*, int, int, int,
                           int, int, int, int, int, int);

// dynamic shared memory above 48 KB, raised once before the first launch
template <BwdKernel Kern>
cudaError_t raise_smem() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  return attr;
}

cudaError_t launch_wgmma(BwdKernel kern, cudaError_t attr, const void* a,
                         const void* b, void* out, int R, int D, int F,
                         int n_items, int n_tiles, int m_tiles, int grid,
                         int a_vec, int b_vec, int fault,
                         cudaStream_t stream) {
  if (attr != cudaSuccess) return attr;
  if (grid < 1 || n_items < 1) return cudaErrorInvalidValue;
  kern<<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<bf16*>(out), R, D, F, n_items, n_tiles, m_tiles, a_vec,
      b_vec, fault);
  return cudaGetLastError();
}

// ------------------------------------------------ fp32: CUDA cores --
constexpr int F_BM = 64, F_BN = 64, F_BK = 16;
constexpr int F_THREADS = 256;   // 16 x 16 threads of 4 x 4 outputs

// MODE kDx: A(m, k) = dy[e, m, k], B(k, n) = w[e, n, k] (both contiguous
// along k); kDw: A(m, k) = x[e, k, m], B(k, n) = dy[e, k, n] (contiguous
// along m and n).  Tiles are staged so that neighbouring threads read
// neighbouring addresses.
template <int MODE>
__global__ void __launch_bounds__(F_THREADS)
    gmm_bwd_f32_kernel(const float* __restrict__ a,
                       const float* __restrict__ b, float* __restrict__ out,
                       int R, int D, int F, int fault) {
  __shared__ __align__(16) float As[F_BK][F_BM + 4];
  __shared__ __align__(16) float Bs[F_BK][F_BN + 4];
  const int M = MODE == kDx ? R : D, N = MODE == kDx ? D : F;
  const int K = MODE == kDx ? F : R;
  const int k_rows = fault == kDropRowGroup ? (R - 1) / 8 * 8 : R;
  const int n0 = blockIdx.x * F_BN, m0 = blockIdx.y * F_BM, e = blockIdx.z;
  const int tid = threadIdx.x, tn = tid % 16, tm = tid / 16;
  const float* ae = a + static_cast<size_t>(e) * R * (MODE == kDx ? F : D);
  const float* be = b + static_cast<size_t>(e) * (MODE == kDx ? D : R) * F;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += F_BK) {
    const int kb = MODE == kDx && fault == kStaleTile && k0 > 0 ? k0 - F_BK
                                                                : k0;
    __syncthreads();  // the last tiles are consumed
#pragma unroll
    for (int t = 0; t < F_BK * F_BM / F_THREADS; ++t) {
      const int i = tid + F_THREADS * t;
      if (MODE == kDx) {  // dy rows of F: 16 threads a row
        const int m = i / F_BK, kk = i % F_BK;
        As[kk][m] = m0 + m < M && k0 + kk < K
                        ? ae[static_cast<size_t>(m0 + m) * F + k0 + kk]
                        : 0.f;
        const int n = i / F_BK;  // w rows of F
        Bs[kk][n] = n0 + n < N && kb + kk < K
                        ? be[static_cast<size_t>(n0 + n) * F + kb + kk]
                        : 0.f;
      } else {  // x rows of D, dy rows of F: 64 threads a row
        const int kk = i / F_BM, m = i % F_BM;
        const bool row = k0 + kk < k_rows;
        As[kk][m] = row && m0 + m < M
                        ? ae[static_cast<size_t>(k0 + kk) * D + m0 + m]
                        : 0.f;
        Bs[kk][m] = row && n0 + m < N
                        ? be[static_cast<size_t>(k0 + kk) * F + n0 + m]
                        : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][4 * tm]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][4 * tn]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += ar[i] * br[j];
    }
  }
  float* oe = out + static_cast<size_t>(e) * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * tm + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tn + j;
      if (m < M && n < N) oe[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

template <int MODE>
cudaError_t launch_f32(const void* a, const void* b, void* out, int E, int R,
                       int D, int F, int fault, cudaStream_t stream) {
  const int M = MODE == kDx ? R : D, N = MODE == kDx ? D : F;
  const dim3 grid((N + F_BN - 1) / F_BN, (M + F_BM - 1) / F_BM, E);
  gmm_bwd_f32_kernel<MODE><<<grid, F_THREADS, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), R, D, F, fault);
  return cudaGetLastError();
}

}  // namespace

// x_vec / w_vec / dy_vec: 1 when every row of that tensor starts on a
// 16-byte boundary.  bf16 takes the plan of plan_gmm_backward for each
// launch (items, N tiles, M tiles, grid); fp32 ignores it.  fault: 0, or
// a planted fault for the checks (kStaleTile: dx; kDropRowGroup: dw).
extern "C" int moe_gmm_backward_launch(
    const void* x, const void* w, const void* dy, void* dx, void* dw, int E,
    int R, int D, int F, int x_vec, int w_vec, int dy_vec, int dtype,
    int dx_items, int dx_n_tiles, int dx_m_tiles, int dx_grid, int dw_items,
    int dw_n_tiles, int dw_m_tiles, int dw_grid, int fault, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kFloat32) {
    err = launch_f32<kDx>(dy, w, dx, E, R, D, F, fault, s);
    if (err == cudaSuccess)
      err = launch_f32<kDw>(x, dy, dw, E, R, D, F, fault, s);
    return static_cast<int>(err);
  }
  if (dtype != kBFloat16) return static_cast<int>(cudaErrorInvalidValue);
  err = dx_m_tiles == 1
            ? launch_wgmma(gmm_bwd_wgmma_kernel<kDx, true>,
                           raise_smem<gmm_bwd_wgmma_kernel<kDx, true>>(), dy,
                           w, dx, R, D, F, dx_items, dx_n_tiles, dx_m_tiles,
                           dx_grid, dy_vec, w_vec, fault, s)
            : launch_wgmma(gmm_bwd_wgmma_kernel<kDx, false>,
                           raise_smem<gmm_bwd_wgmma_kernel<kDx, false>>(), dy,
                           w, dx, R, D, F, dx_items, dx_n_tiles, dx_m_tiles,
                           dx_grid, dy_vec, w_vec, fault, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_wgmma(gmm_bwd_wgmma_kernel<kDw, false>,
                     raise_smem<gmm_bwd_wgmma_kernel<kDw, false>>(), x, dy,
                     dw, R, D, F, dw_items, dw_n_tiles, dw_m_tiles, dw_grid,
                     x_vec, dy_vec, fault, s);
  return static_cast<int>(err);
}
