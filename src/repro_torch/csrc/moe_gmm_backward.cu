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
// bf16 peak against ~0.13 ms of bytes); at mixtral-8x22b's (E 8, R 320,
// D 6144, F 16384) the operations and the bytes weigh about the same.
//   * Two launches in order on one stream, dx then dw.  A block owns whole
//     output tiles of 128 x 256 and sums each one's contraction in
//     registers: no atomics and no scratch, so two runs give the same bits.
//     Each operand is read as it is stored, wgmma's transpose bits saying
//     which of its axes is contiguous:
//       dx: M = R, N = D, the sum over F.  A = dy [R][F], K-major; B = w^T,
//           read from w [D][F] as stored (K-major).
//       dw: M = D, N = F, the sum over R.  A = x^T, read from x [R][D]
//           (MN-major); B = dy [R][F] (MN-major).
//   * bf16 with every row 16-byte aligned (D and F multiples of 8; the
//     plan's `tma`): a warp-specialised persistent block per SM.  One
//     thread of the producer warpgroup keeps TMA loads (128-byte swizzle,
//     zeros past the edges) in flight through a ring of stages, each with
//     a full and an empty mbarrier; two consumer warpgroups of 64 rows run
//     wgmma on the stages that have landed and release each when its
//     products are done; setmaxnreg moves registers from the producer to
//     the consumers.  Nothing in the main loop waits on the whole block.
//       dx (22 ring steps an item at the train row): a ring of 4 stages
//           64 deep; outputs stored from the registers while the producer
//           loads on (the ring runs on across items).
//       dw (two ring steps an item at the train row): each warpgroup's
//           outputs go to a shared buffer of its own and leave by TMA
//           stores, which overlap the next item's loads and products (the
//           buffer is written again once the stores have read it; outputs
//           from the registers measured 2.6x slower).  Where R <= 128 (the
//           plan's `resident`) a block walks whole units (expert, F tile)
//           of items, one per D tile: dy's [R x 256] tile (64 KB) stays
//           resident for the unit and only x's D tiles stream, through 6
//           stages, so each output tile reads 32 KB of x and a 16th of the
//           dy tile instead of both; else both stream through 3 stages.
//           With dy resident, dw is launched by programmatic
//           serialization, so it starts on the SMs dx's tail leaves idle.
//     The plan (items, tiles, units, grid) is a Python function of the
//     shapes and the SM count: repro_torch/kernels/moe_gmm.py:
//     plan_gmm_backward.
//   * bf16 with rows not 16-byte aligned: a persistent block of two
//     warpgroups that stages both operands by cp.async (through registers
//     where a row segment is not aligned) into a ring of four stages, the
//     forward's wgmma kernel shape.
//   * fp32 (the parity path) stays on the CUDA cores, as the forward's
//     fp32 path does (TF32 could not meet the fp32 limit): a block per
//     64 x 64 output tile, 16-deep tiles of both operands staged in shared
//     memory along whichever of their axes is contiguous, each thread
//     summing a 4 x 4 patch.
// No divisibility of R, D or F is required: the ragged edge is masked
// with zeros.
#include <cuda.h>  // CUtensorMap; the driver's encoder is found at run time

#include "gmm.cuh"

namespace {

using namespace gmm;

constexpr int kDx = 0, kDw = 1;  // the two launches
// planted faults, for the checks only (repro_torch/kernels/moe_gmm.py)
constexpr int kStaleTile = 1;     // dx: each w stage holds the step before's F
constexpr int kDropRowGroup = 2;  // dw: the last 8-row group of R left out
// dw with dy resident: a block's later units keep its first unit's dy tile
constexpr int kStaleResident = 3;

// ------------------------------------ bf16, unaligned rows: cp.async --
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
      // the item is summed: each thread stores its two columns of each
      // 8-column group from the registers and starts anew
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

// -------------------------- bf16, rows 16-byte aligned: TMA, specialised --
constexpr int T_BM = 128, T_BN = 256, T_BK = 64;
constexpr int T_THREADS = 384;  // warpgroups 0, 1: wgmma; 2: the producer
constexpr int DX_STAGES = 4, DW_STAGES = 3, DWR_STAGES = 6;
constexpr int T_A = T_BM * T_BK * 2;    // 16 KB: dy [128][64] or x [64][128]
constexpr int T_B = T_BK * T_BN * 2;    // 32 KB: w [256][64] or dy [64][256]
constexpr int T_OUT = T_BM * T_BN * 2;  // 64 KB: dw's output buffer
constexpr int T_RES = 2 * T_B;          // 64 KB: dy [128][256], resident
// the producer keeps 40 registers a thread, the consumers take 232: 256 x
// 232 + 128 x 40 = 384 x 168, what __launch_bounds__(384, 1) gives
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}

__device__ __forceinline__ unsigned long long evict_last_policy() {
  unsigned long long pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}

// Shared memory of launch MODE (RES: dy resident), from a 1024-byte
// boundary: the ring, dw's output buffer, the resident tile, then the
// barriers (full[STAGES], empty[STAGES], res_full, res_empty).
template <int MODE, bool RES>
struct TmaLayout {
  static constexpr int STAGES =
      MODE == kDx ? DX_STAGES : (RES ? DWR_STAGES : DW_STAGES);
  static constexpr int STAGE = RES ? T_A : T_A + T_B;
  static constexpr int OUT = STAGES * STAGE;
  static constexpr int RESIDENT = OUT + (MODE == kDw ? T_OUT : 0);
  static constexpr int BARS = RESIDENT + (RES ? T_RES : 0);
  static constexpr int SMEM = BARS + 8 * (2 * STAGES + 2) + 1024;
};

// MODE kDx: map_a = dy (box [128][64]), map_b = w ([64][64], four a stage),
// the outputs stored from the registers into `out`; kDw: map_a = x
// ([64][64]), map_b = dy ([64][64]), map_out = dw ([64][64]).  (M, N, K) =
// (R, D, F) or (D, F, R).  Items (expert, N tile, M tile), M tiles fastest,
// are walked in chunks of `chunk` (RES: a unit of all the M tiles of one
// (expert, N tile)): block b takes chunks b, b + grid, ...  With `cluster` >
// 1 (dx only) a thread block cluster of that many blocks takes a chunk of as
// many M tiles that share B, block r the r-th: each loads its quarters q of
// the B tile with q % cluster = r and multicasts them to all, and each
// consumer warp releases a stage in every block of the cluster, so B comes
// from L2 once for `cluster` items.  L2: dx's dy tiles, read again by each D
// tile of the expert, evict-last; with dy resident, dw's outputs evict-first
// (measured faster at the train row, slower with dw streamed at mixtral's).
// dw with dy resident is launched by programmatic serialization
// (launch_tma), so its blocks take the SMs that dx's free; each then waits
// for dx's end before it exits, which keeps the stream's order for what
// follows.
template <int MODE, bool RES>
__global__ void __launch_bounds__(T_THREADS, 1)
    gmm_bwd_tma_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b,
                       const __grid_constant__ CUtensorMap map_out,
                       bf16* __restrict__ out, int M, int N, int K,
                       int n_items, int n_tiles, int m_tiles, int chunk,
                       int cluster, int fault) {
  using L = TmaLayout<MODE, RES>;
  extern __shared__ __align__(16) unsigned char gmm_smem[];
  unsigned char* base = gmm_smem + ((1024 - static_cast<int>(
      smem_u32(gmm_smem) & 1023)) & 1023);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(base + L::BARS);
  unsigned long long* empty = full + L::STAGES;
  unsigned long long* res_full = empty + L::STAGES;
  unsigned long long* res_empty = res_full + 1;
  unsigned char* res = base + L::RESIDENT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k_steps = (K + T_BK - 1) / T_BK;
  const int n_chunks = (n_items + chunk - 1) / chunk;
  // the chunks this block (its cluster) walks, and its item in each
  const int rank = cluster > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int first = blockIdx.x / cluster, stride = gridDim.x / cluster;
  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full + s, 1);  // the producer's expect_tx
      // lane 0 of each consumer warp of each block of the cluster
      mbar_init(empty + s, 8 * cluster);
    }
    mbar_init(res_full, 1);
    mbar_init(res_empty, 8);
    mbar_fence_init();
  }
  if (cluster > 1)
    cluster_sync();  // no block multicasts into barriers not yet made
  else
    __syncthreads();
  if (MODE == kDx) trigger_dependents();  // dw may take SMs as they free

  if (warp >= 8) {
    // ---- the producer warpgroup: one thread issues every load ----
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 8 && lane == 0) {
      const unsigned long long dy_policy = evict_last_policy();
      // dx's F column of w at ring step ks (the planted fault: the step
      // before's)
      auto kb_of = [&](int ks) {
        return fault == kStaleTile && ks > 0 ? T_BK * (ks - 1) : T_BK * ks;
      };
      const unsigned short everyone = (1u << cluster) - 1;
      int stage = 0, phase = 0, res_phase = 0;
      for (int c = first; c < n_chunks; c += stride) {
        const int i0 = c * chunk + rank;
        const int i1 = cluster > 1 ? i0 + 1 : min(c * chunk + chunk, n_items);
        for (int i = i0; i < i1; ++i) {
          const int mt = i % m_tiles, rest = i / m_tiles;
          const int m0 = mt * T_BM, n0 = (rest % n_tiles) * T_BN;
          const int e = rest / n_tiles;
          for (int ks = 0; ks < k_steps; ++ks) {
            mbar_wait(empty + stage, phase ^ 1);
            unsigned char* st = base + stage * L::STAGE;
            mbar_expect_tx(full + stage, L::STAGE);
            if (MODE == kDx) {
              tma_load_3d_hint(st, &map_a, full + stage, T_BK * ks, m0, e,
                               dy_policy);
            } else {
#pragma unroll
              for (int h = 0; h < 2; ++h)  // x: the item's two 64-col blocks
                tma_load_3d(st + h * (T_A / 2), &map_a, full + stage,
                            m0 + 64 * h, T_BK * ks, e);
            }
            // B in quarters: w's 64-row blocks of D, or dy's 64-column
            // blocks of F
            for (int q = rank; q < 4 && !RES; q += cluster) {
              const int c0 = MODE == kDx ? kb_of(ks) : n0 + 64 * q;
              const int c1 = MODE == kDx ? n0 + 64 * q : T_BK * ks;
              unsigned char* dst = st + T_A + q * (T_B / 4);
              if (cluster > 1)
                tma_load_3d_multicast(dst, &map_b, full + stage, c0, c1, e,
                                      everyone);
              else
                tma_load_3d(dst, &map_b, full + stage, c0, c1, e);
            }
            if (++stage == L::STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
          if (RES && i == i0) {
            // the unit's dy tile, once the consumers are done with the last
            // unit's; issued after the unit's first x tiles, which so load
            // while the last unit ends
            mbar_wait(res_empty, res_phase ^ 1);
            if (fault == kStaleResident && c != first) {
              mbar_arrive(res_full);
            } else {
              mbar_expect_tx(res_full, k_steps * T_B);
              for (int ks = 0; ks < k_steps; ++ks)
#pragma unroll
                for (int nb = 0; nb < 4; ++nb)
                  tma_load_3d(res + ks * T_B + nb * (T_B / 4), &map_b,
                              res_full, n0 + 64 * nb, T_BK * ks, e);
            }
            res_phase ^= 1;
          }
        }
      }
      // with a cluster: every block's consumers have released every
      // stage of this one before it exits (no arrival comes later)
      for (int s = 0; s < L::STAGES && cluster > 1; ++s) {
        mbar_wait(empty + stage, phase ^ 1);
        if (++stage == L::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (MODE == kDw) grid_dependency_wait();
    }
  } else {
    // ---- two consumer warpgroups, rows 64 wg + [0, 64) of each item ----
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = warp / 4, t = tid % 128;
    float acc[T_BN / 2];
    // a stage's products are done: release it in every block that loads
    // into it
    auto release = [&](int s) {
      if (lane != 0) return;
      for (int r = 0; r < cluster; ++r) {
        if (r == rank)
          mbar_arrive(empty + s);
        else
          mbar_arrive_cluster(empty + s, r);
      }
    };
    int stage = 0, phase = 0, res_phase = 0;
    for (int c = first; c < n_chunks; c += stride) {
      const int i0 = c * chunk + rank;
      const int i1 = cluster > 1 ? i0 + 1 : min(c * chunk + chunk, n_items);
      if (RES) mbar_wait(res_full, res_phase);
      for (int i = i0; i < i1; ++i) {
        const int mt = i % m_tiles, rest = i / m_tiles;
        const int m0 = mt * T_BM, n0 = (rest % n_tiles) * T_BN;
        const int e = rest / n_tiles;
        const bool live = m0 + 64 * wg < M;
#pragma unroll
        for (int j = 0; j < T_BN / 2; ++j) acc[j] = 0.f;
        int prev = 0;
        for (int ks = 0; ks < k_steps; ++ks) {
          mbar_wait(full + stage, phase);
          const unsigned char* st = base + stage * L::STAGE;
          if (live) {
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < T_BK / 16; ++kk) {
              if (MODE == kDx) {
                // both K-major: 16 depths are 32 bytes into each 128-byte
                // row (dy: the warpgroup's 64 rows; w: all 256)
                wgmma_bf16_256<0, 0>(
                    acc, gmma_desc(st + 64 * wg * 128 + 32 * kk, 16, 1024),
                    gmma_desc(st + T_A + 32 * kk, 16, 1024));
              } else {
                // both MN-major: depth rows 16 kk.. (2 KB each); x's 64
                // rows of the warpgroup are its 64-column block, dy's four
                // blocks 8 KB apart
                const unsigned char* bs = RES ? res + ks * T_B : st + T_A;
                wgmma_bf16_256<1, 1>(
                    acc, gmma_desc(st + wg * 8192 + 16 * kk * 128, 8192, 1024),
                    gmma_desc(bs + 16 * kk * 128, 8192, 1024));
              }
            }
            wgmma_commit();
            // dx: the step before's products are done, this step's run on;
            // dw (few steps an item): this step's are done, so its stage
            // is released at once (measured faster at mixtral's shape)
            if (MODE == kDx)
              wgmma_wait<1>();
            else
              wgmma_wait<0>();
          }
          if (MODE == kDw) release(stage);
          if (MODE == kDx && ks > 0) release(prev);
          prev = stage;
          if (++stage == L::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        if (MODE == kDx && live) wgmma_wait<0>();
        if (MODE == kDx) release(prev);
        if (RES && i + 1 == i1 && lane == 0) mbar_arrive(res_empty);

        if (MODE == kDx) {
          // each thread's two columns of each 8-column group, from the
          // registers (N = D is a multiple of 8 on this path)
          const int r_lo = m0 + 64 * wg + 16 * (warp % 4) + lane / 4;
          bf16* oe = out + static_cast<size_t>(e) * M * N;
#pragma unroll
          for (int j = 0; j < T_BN / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = r_lo + 8 * h, col = n0 + 8 * j + 2 * (lane % 4);
              if (live && r < M && col < N)
                *reinterpret_cast<unsigned*>(oe + static_cast<size_t>(r) * N +
                                             col) =
                    pack_bf16x2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            }
        } else {
          // the warpgroup's [64][256] into its buffer (four 128-byte-
          // swizzled [64][64] blocks, the TMA store's boxes) once its last
          // stores have read it, then out by TMA
          unsigned char* ob = base + L::OUT + wg * (T_OUT / 2);
          if (t == 0) bulk_wait_read();
          warpgroup_sync(wg);
          if (live) {
            const int rl = 16 * (warp % 4) + lane / 4;
#pragma unroll
            for (int j = 0; j < T_BN / 8; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = rl + 8 * h;
                *reinterpret_cast<unsigned*>(
                    ob + (j / 8) * 8192 + r * 128 +
                    (((j % 8) ^ (r & 7)) << 4) + 4 * (lane % 4)) =
                    pack_bf16x2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
              }
            fence_proxy_async();  // the writes, to the TMA's async proxy
          }
          warpgroup_sync(wg);
          if (t == 0 && live) {
            for (int nb = 0; nb < 4 && n0 + 64 * nb < N; ++nb) {
              if (RES)
                tma_store_3d_hint(&map_out, ob + nb * 8192, n0 + 64 * nb,
                                  m0 + 64 * wg, e, evict_first_policy());
              else
                tma_store_3d(&map_out, ob + nb * 8192, n0 + 64 * nb,
                             m0 + 64 * wg, e);
            }
            bulk_commit();
          }
        }
      }
      if (RES) res_phase ^= 1;
    }
    if (MODE == kDw && t == 0) bulk_wait();  // before the block's memory goes
    if (MODE == kDw) grid_dependency_wait();
  }
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

// ------------------------------------------- TMA: maps and launches --
// cuTensorMapEncodeTiled, found through the runtime: the library links
// the CUDA runtime only (no -lcuda), and the driver may have no libcuda.so
// link name on the machine that runs it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a contiguous bf16 tensor [E][stride_rows][cols] of which it
// sees the first `rows` rows an expert: boxes [box_rows][64], 128-byte
// swizzled (a 64-element row of a box is one 128-byte line); no L2
// promotion (256-byte promotion measured slower for dx's w).
cudaError_t make_map(CUtensorMap* map, const void* p, int E, int rows,
                     int stride_rows, int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(cols) * 2,
      static_cast<cuuint64_t>(stride_rows) * cols * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// one launch by its plan: items, N tiles, M tiles, grid, chunk, cluster.
// A clustered grid is lowered to the clusters the card holds at once
// (a persistent block whose cluster waited for another's end would walk
// its share after everyone else's).
template <int MODE, bool RES>
cudaError_t launch_tma(const CUtensorMap& a, const CUtensorMap& b,
                       const CUtensorMap& o, void* out, int M, int N, int K,
                       const int* plan, int fault, cudaStream_t stream) {
  using L = TmaLayout<MODE, RES>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gmm_bwd_tma_kernel<MODE, RES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (attr != cudaSuccess) return attr;
  const int cluster = plan[5];
  if (plan[0] < 1 || plan[3] < 1 || plan[4] < 1 || cluster < 1 ||
      cluster > 4 || plan[3] % cluster != 0 ||
      (MODE == kDw && cluster != 1))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan[3]);
  cfg.blockDim = dim3(T_THREADS);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  cfg.attrs = attrs;
  if (RES) {  // dw with dy resident: started on the SMs dx's tail frees
    attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attrs[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.numAttrs = 1;
  } else if (cluster > 1) {
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = cluster;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    cfg.numAttrs = 1;
    static int fits[5] = {};  // clusters held at once, by cluster size
    if (fits[cluster] == 0) {
      const cudaError_t err = cudaOccupancyMaxActiveClusters(
          &fits[cluster], gmm_bwd_tma_kernel<MODE, RES>, &cfg);
      if (err != cudaSuccess) return err;
      if (fits[cluster] < 1) return cudaErrorInvalidConfiguration;
    }
    cfg.gridDim = dim3(cluster * min(plan[3] / cluster, fits[cluster]));
  }
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, gmm_bwd_tma_kernel<MODE, RES>, a, b, o, static_cast<bf16*>(out),
      M, N, K, plan[0], plan[1], plan[2], plan[4], cluster, fault);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t launch_tma_pair(const void* x, const void* w, const void* dy,
                            void* dx, void* dw, int E, int R, int D, int F,
                            int resident, const int* dx_plan,
                            const int* dw_plan, int fault,
                            cudaStream_t stream) {
  if (resident && R > 2 * T_BK) return cudaErrorInvalidValue;  // 64 KB tile
  // kDropRowGroup: x's map sees R's rows without the last 8-row group
  const int x_rows = fault == kDropRowGroup ? max(1, (R - 1) / 8 * 8) : R;
  CUtensorMap dy_k, w_k, x_mn, dy_mn, dw_out;
  cudaError_t err;
  if ((err = make_map(&dy_k, dy, E, R, R, F, T_BM)) != cudaSuccess ||
      (err = make_map(&w_k, w, E, D, D, F, T_BK)) != cudaSuccess ||
      (err = make_map(&x_mn, x, E, x_rows, R, D, T_BK)) != cudaSuccess ||
      (err = make_map(&dy_mn, dy, E, R, R, F, T_BK)) != cudaSuccess ||
      (err = make_map(&dw_out, dw, E, D, D, F, T_BK)) != cudaSuccess)
    return err;
  err = launch_tma<kDx, false>(dy_k, w_k, w_k, dx, R, D, F, dx_plan, fault,
                               stream);
  if (err != cudaSuccess) return err;
  return resident ? launch_tma<kDw, true>(x_mn, dy_mn, dw_out, dw, D, F, R,
                                          dw_plan, fault, stream)
                  : launch_tma<kDw, false>(x_mn, dy_mn, dw_out, dw, D, F, R,
                                           dw_plan, fault, stream);
}

}  // namespace

// x_vec / w_vec / dy_vec: 1 when every row of that tensor starts on a
// 16-byte boundary.  bf16 takes the plan of plan_gmm_backward: `tma` (the
// TMA kernels, which need every row aligned), `resident` (dw keeps dy's
// tile), and for each launch items, N tiles, M tiles, grid, the chunk of
// items a block (a cluster) walks in a row and the cluster; fp32 ignores
// it.  fault: 0, or a planted fault for the checks (kStaleTile: dx;
// kDropRowGroup: dw; kStaleResident: dw with dy resident).
extern "C" int moe_gmm_backward_launch(
    const void* x, const void* w, const void* dy, void* dx, void* dw, int E,
    int R, int D, int F, int x_vec, int w_vec, int dy_vec, int dtype, int tma,
    int resident, int dx_items, int dx_n_tiles, int dx_m_tiles, int dx_grid,
    int dx_chunk, int dx_cluster, int dw_items, int dw_n_tiles,
    int dw_m_tiles, int dw_grid, int dw_chunk, int dw_cluster, int fault,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kFloat32) {
    err = launch_f32<kDx>(dy, w, dx, E, R, D, F, fault, s);
    if (err == cudaSuccess)
      err = launch_f32<kDw>(x, dy, dw, E, R, D, F, fault, s);
    return static_cast<int>(err);
  }
  if (dtype != kBFloat16) return static_cast<int>(cudaErrorInvalidValue);
  if (tma) {
    if (!(x_vec && w_vec && dy_vec))
      return static_cast<int>(cudaErrorMisalignedAddress);
    const int dx_plan[6] = {dx_items, dx_n_tiles, dx_m_tiles,
                            dx_grid,  dx_chunk,   dx_cluster};
    const int dw_plan[6] = {dw_items, dw_n_tiles, dw_m_tiles,
                            dw_grid,  dw_chunk,   dw_cluster};
    return static_cast<int>(launch_tma_pair(x, w, dy, dx, dw, E, R, D, F,
                                            resident, dx_plan, dw_plan, fault,
                                            s));
  }
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
