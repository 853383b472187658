// Mamba2 SSD chunk scan with the state carried across chunks.
//
//   xbar [B, S, nh, P] fp32; Bm, Cm [B, S, N]; cum [B, S, nh] fp32 (the
//   log-decay cumsum, restarted at every caller chunk of Q rows; S = nc *
//   Q); y [B, S, nh, P] fp32; state [B, nh, P, N] fp32, all contiguous.
//   For each chunk, with h the state entering it:
//     y_i = sum_{j<=i} (C_i . B_j) e^{cum_i - cum_j} xbar_j + e^{cum_i} C_i h
//     h  <- h e^{cum_last} + sum_j e^{cum_last - cum_j} xbar_j B_j^T
//
// Replaces repro/kernels/mamba_scan.py:mamba_chunk_scan_chunked (Pallas),
// whose grid (B, nc) walks the chunks in order with every head's state
// h [nh, P, N] in VMEM (1 MiB a batch row at zamba2's width).
//
// What bounds it on the H100: operations at zamba2's widths, in fp32
// (Q^2 N + Q^2 P + 2 Q P N multiply-adds a (b, head, chunk) against one
// read of the inputs and one write of y).  The design cuts the work to
// fill the 132 SMs even for one chunk of 128 rows, as the mLSTM scan does
// (mlstm_scan.cu): kernel chunks of kL = 64 rows with cum rebased
// (scan::rebase_chunk), then
//  * mamba_scan_chunk_kernel, two kinds of block in one grid.  State
//    blocks, one per (b, head, 16 rows of P), take the kernel chunks four
//    at a time (each warp one chunk's gates and its sum from zero; for
//    bf16 B on the tensor cores, xbar split in three bf16 parts,
//    scan::split_bf16x2, which meets the fp32 limit), fold the sums into
//    h's tile in order, and write the state entering each chunk c >= 1 to
//    scratch (hin[c - 1]) and the final state.  Score
//    blocks, one per (b, kernel chunk), form C B^T once for all the heads
//    (the Mamba2 B/C group is shared): on the tensor cores for bf16 B and
//    C (bf16 products are exact in fp32), on the CUDA cores for fp32.
//  * mamba_scan_out_kernel, one block per (b, kernel chunk, head, 64
//    columns of P): y = e^{g} C hin + (C B^T ⊙ decay) xbar.  The carried
//    term runs on the tensor cores for bf16 C (exact), hin split in three
//    bf16 parts; the intra-chunk product stays fp32 on the CUDA cores (it
//    fails the fp32 limit with both operands split into two bf16 halves),
//    each warp summing only the keys up to its last row.
// Every sum runs in a fixed order with no atomics, so two runs give
// identical bits.
#include <type_traits>

#include "scan.cuh"

namespace {

using namespace scan;
using bf16 = __nv_bfloat16;

constexpr int kPT = 16;    // rows of P a state block owns
constexpr int kPO = 64;    // columns of P an output block owns
constexpr int kMaxN = 64;
constexpr int kMaxQ = 256;
constexpr int kLdB = kMaxN + 8;  // bf16 tile row stride (16-byte rows)

struct Args {
  const float* x;
  const void* Bm;
  const void* Cm;
  const float* cum;
  float* y;
  float* state;
  float* hin;  // [chunks - 1][B][nh][P][N]: the state entering chunk c at c-1
  float* G;    // [B][chunks][kL][kL]: C B^T of each kernel chunk
  int B, S, Q, nh, P, N, chunks, fault;
};

// A state block takes the kernel chunks four at a time: their rows land
// together (cp.async), warp w forms chunk 4 k + w's gates and its sum
// from zero, and the block folds the four sums into the state in order.
constexpr int kGroup = 4;

template <typename T>
struct StateSmem {  // bf16: 76,832 bytes (three blocks an SM)
  T b[kGroup][kL][kMaxN + 16 / sizeof(T)];  // B rows of the chunks
  float x[kGroup][kL][kPT + 4];             // xbar rows, this P tile
  float g[kGroup][kL];
  float w[kGroup][kL];                      // e^{g_last - g_j}
  float gl[kGroup];
  float part[kGroup][kPT][kMaxN + 4];       // each chunk's sum, from zero
};

struct ScoreSmemBf16 {
  bf16 c[kL][kLdB];
  bf16 b[kL][kLdB];
};

struct ScoreSmemF32 {
  float cT[kMaxN][kL + 1];
  float bT[kMaxN][kL + 1];
};

constexpr int kLdO = kL + 4;  // fp32 tile row stride (16-byte rows)
// the carried term's operands: bf16 C rows [i][n] and hin [p][n] split
// in kParts (tensor cores), or fp32 C rows and hin^T [n][p] (CUDA cores)
struct CarryBf16 {
  bf16 c[kL][kLdB];
  bf16 h[kParts][kPO][kLdB];
};
struct CarryF32 {
  float c[kL][kLdO];
  float hT[kMaxN][kLdO];
};
template <typename T>
struct OutSmem {  // 71,936 bytes (bf16): three blocks an SM
  float G[kL][kLdO];  // C B^T [i][j], then masked and decayed
  float x[kL][kLdO];  // xbar rows [j][p]
  typename std::conditional<sizeof(T) == 2, CarryBf16, CarryF32>::type cy;
  float g[kL];
};

// One (b, head, P tile): the state entering every kernel chunk.  h[m]
// holds row p0 + p, column n0 + 8 m.
template <typename T>
__device__ void state_block(const Args& a, int bid, StateSmem<T>& sm) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int ptiles = (a.P + kPT - 1) / kPT;
  const int pt = bid % ptiles, hd = bid / ptiles % a.nh;
  const int b = bid / (ptiles * a.nh);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int p = t / 8, n0 = t % 8;
  const int p0 = pt * kPT;
  const size_t xld = static_cast<size_t>(a.nh) * a.P;
  const size_t row0 = static_cast<size_t>(b) * a.S;
  const float* xp = a.x + row0 * xld + static_cast<size_t>(hd) * a.P + p0;
  const T* bp = static_cast<const T*>(a.Bm) + row0 * a.N;
  const float* cum = a.cum + row0 * a.nh + hd;
  const size_t head = static_cast<size_t>(b) * a.nh + hd;
  const size_t per_chunk = static_cast<size_t>(a.B) * a.nh;
  constexpr int kPerPiece = 16 / sizeof(T), kPieces = kMaxN / kPerPiece;
  auto rows_of = [&](int c) { return min(kL, a.S - c * kL); };
  auto store = [&](float* dst, const float (&h)[8]) {
    if (p0 + p >= a.P) return;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int n = n0 + 8 * m;
      if (n < a.N) dst[static_cast<size_t>(p0 + p) * a.N + n] = h[m];
    }
  };

  float h[8] = {};
  for (int c0 = 0; c0 < a.chunks; c0 += kGroup) {
    const int nq = min(kGroup, a.chunks - c0);
    __syncthreads();  // the group before is done with the tiles and sums
    for (int q = 0; q < nq; ++q) {
      const int s0 = (c0 + q) * kL, rows = rows_of(c0 + q);
      for (int i = t; i < kL * kPieces; i += kThreads) {
        const int r = i / kPieces, e = i % kPieces * kPerPiece;
        const bool ok = r < rows && e < a.N;
        cp_async16(&sm.b[q][r][e],
                   ok ? bp + static_cast<size_t>(s0 + r) * a.N + e : bp, ok);
      }
      for (int i = t; i < kL * (kPT / 4); i += kThreads) {
        const int r = i / (kPT / 4), e = i % (kPT / 4) * 4;
        const bool ok = r < rows && p0 + e < a.P;
        cp_async16(&sm.x[q][r][e],
                   ok ? xp + static_cast<size_t>(s0 + r) * xld + e : xp, ok);
      }
    }
    cp_async_commit();
    const int q = warp, c = c0 + q;  // this warp's chunk
    if (q < nq) {
      Gates v;
      gates_load(cum, nullptr, a.nh, c * kL, rows_of(c), a.Q, v);
      const float gl = gates_rebase(v, c * kL, rows_of(c), a.Q,
                                    a.fault & kFaultNoRebase, sm.g[q], sm.w[q]);
      if (lane == 0) sm.gl[q] = gl;
    }
    cp_async_wait<0>();
    __syncthreads();  // the group's rows and gates
    if (q < nq) {  // part[p][n] = sum_j (w_j xbar_j[p]) B_j[n]
      if constexpr (kBf16) {
        // tensor cores: A = (w xbar)^T split in kParts, B = the bf16 rows
        const int gq = lane / 4, tq = lane % 4;
        float acc[kMaxN / 8][4] = {};
#pragma unroll
        for (int ks = 0; ks < kL / 16; ++ks) {
          unsigned af[kParts][4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int pp = gq + 8 * (x & 1), j = 16 * ks + 2 * tq + 8 * (x >> 1);
            unsigned pr[kParts];
            split_bf16x2(sm.w[q][j] * sm.x[q][j][pp],
                         sm.w[q][j + 1] * sm.x[q][j + 1][pp], pr);
#pragma unroll
            for (int s = 0; s < kParts; ++s) af[s][x] = pr[s];
          }
#pragma unroll
          for (int np = 0; np < kMaxN / 16; ++np) {
            unsigned bv[4];
            ldmatrix_x4_trans(
                bv, &sm.b[q][16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8]
                            [16 * np + (lane >> 4) * 8]);
#pragma unroll
            for (int s = 0; s < kParts; ++s) {
              if (s > 0 && (a.fault & kFaultSplitLow)) break;
              mma_bf16_16816(acc[2 * np], af[s], bv[0], bv[1]);
              mma_bf16_16816(acc[2 * np + 1], af[s], bv[2], bv[3]);
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < kMaxN / 8; ++nt)
#pragma unroll
          for (int x = 0; x < 2; ++x)
            *reinterpret_cast<float2*>(&sm.part[q][gq + 8 * x][8 * nt + 2 * tq]) =
                make_float2(acc[nt][2 * x], acc[nt][2 * x + 1]);
      } else {
        // CUDA cores: lane (row lane % 16, columns 32 (lane / 16) + k)
        const int pp = lane % 16, nb = lane / 16 * 32;
        float acc[32] = {};
        for (int j = 0; j < rows_of(c); ++j) {
          const float xv = sm.w[q][j] * sm.x[q][j][pp];
#pragma unroll
          for (int k = 0; k < 32; k += 4) {
            const float4 bv = *reinterpret_cast<const float4*>(&sm.b[q][j][nb + k]);
            acc[k] += xv * bv.x;
            acc[k + 1] += xv * bv.y;
            acc[k + 2] += xv * bv.z;
            acc[k + 3] += xv * bv.w;
          }
        }
#pragma unroll
        for (int k = 0; k < 32; k += 4)
          *reinterpret_cast<float4*>(&sm.part[q][pp][nb + k]) =
              make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
      }
    }
    __syncthreads();  // the group's sums
    for (int qq = 0; qq < nq; ++qq) {  // fold them in, in order
      if (c0 + qq > 0)
        store(a.hin + ((c0 + qq - 1) * per_chunk + head) * a.P * a.N, h);
      const float decay = expf(sm.gl[qq]);
#pragma unroll
      for (int m = 0; m < 8; ++m)
        h[m] = h[m] * decay + sm.part[qq][p][n0 + 8 * m];
    }
  }
  store(a.state + head * a.P * a.N, h);
}

// One (b, kernel chunk): G = C B^T [kL][kL], shared by every head.
template <typename T>
__device__ void score_block(const Args& a, int sid, unsigned char* raw) {
  const int c = sid % a.chunks, b = sid / a.chunks;
  const int s0 = c * kL, rows = min(kL, a.S - s0);
  const int t = threadIdx.x;
  const size_t row0 = static_cast<size_t>(b) * a.S + s0;
  const T* cp = static_cast<const T*>(a.Cm) + row0 * a.N;
  const T* bp = static_cast<const T*>(a.Bm) + row0 * a.N;
  float* G = a.G + (static_cast<size_t>(b) * a.chunks + c) * kL * kL;
  if constexpr (sizeof(T) == 2) {
    ScoreSmemBf16& sm = smem_as<ScoreSmemBf16>(raw);
    const int warp = t / 32, lane = t % 32, gq = lane / 4, tq = lane % 4;
    for (int i = t; i < kL * (kMaxN / 8); i += kThreads) {
      const int r = i / (kMaxN / 8), p = i % (kMaxN / 8) * 8;
      const bool ok = r < rows && p < a.N;
      const size_t off = static_cast<size_t>(r) * a.N + p;
      cp_async16(&sm.c[r][p], ok ? cp + off : cp, ok);
      cp_async16(&sm.b[r][p], ok ? bp + off : bp, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float acc[8][4] = {};
    for (int ks = 0; ks < (a.N + 15) / 16; ++ks) {
      unsigned af[4];
      ldmatrix_x4(af, &sm.c[16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8]
                           [16 * ks + (lane >> 4) * 8]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned bf[4];
        ldmatrix_x4(bf, &sm.b[16 * np + (lane & 7) + (lane >> 4) * 8]
                             [16 * ks + ((lane >> 3) & 1) * 8]);
        mma_bf16_16816(acc[2 * np], af, bf[0], bf[1]);
        mma_bf16_16816(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(G + (16 * warp + gq + 8 * h) * kL + 8 * nt +
                                   2 * tq) =
            make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
  } else {
    ScoreSmemF32& sm = smem_as<ScoreSmemF32>(raw);
    stage<kL, kMaxN, true>(&sm.cT[0][0], kL + 1, cp, a.N, rows, a.N);
    stage<kL, kMaxN, true>(&sm.bT[0][0], kL + 1, bp, a.N, rows, a.N);
    __syncthreads();
    float acc[4][8] = {};
    fma_tile<8>(acc, &sm.cT[0][0], kL + 1, &sm.bT[0][0], kL + 1, a.N);
    const int r0 = t / 8, c0 = t % 8;
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 8; ++y) G[(r0 + 16 * x) * kL + c0 + 8 * y] = acc[x][y];
  }
}

template <typename T>
constexpr size_t kChunkSmem =
    cmax(sizeof(StateSmem<T>), cmax(sizeof(ScoreSmemBf16), sizeof(ScoreSmemF32)));

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mamba_scan_chunk_kernel(const Args a, int state_blocks) {
  extern __shared__ __align__(16) unsigned char raw[];
  if (static_cast<int>(blockIdx.x) < state_blocks)
    state_block<T>(a, blockIdx.x, smem_as<StateSmem<T>>(raw));
  else
    score_block<T>(a, blockIdx.x - state_blocks, raw);
}

// One (b, kernel chunk, head, P tile) of y.  Each warp owns 16 rows of
// the tile and every thread the mma accumulator layout (rows 16 warp + gq
// (+8), columns 8 nt + 2 tq (+1)), so the carried term (tensor cores for
// bf16 C) and the causal intra-chunk term (CUDA cores, fp32, keys up to
// the warp's last row) sum into the same registers.
template <typename T>
__global__ void __launch_bounds__(kThreads) mamba_scan_out_kernel(const Args a) {
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char raw[];
  OutSmem<T>& sm = smem_as<OutSmem<T>>(raw);
  const int ptiles = (a.P + kPO - 1) / kPO;
  const int bid = blockIdx.x;
  const int pt = bid % ptiles, hd = bid / ptiles % a.nh;
  const int c = bid / (ptiles * a.nh) % a.chunks;
  const int b = bid / (ptiles * a.nh * a.chunks);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int gq = lane / 4, tq = lane % 4, i0 = 16 * warp + gq;
  const int s0 = c * kL, rows = min(kL, a.S - s0), p0 = pt * kPO;
  const size_t xld = static_cast<size_t>(a.nh) * a.P;
  const size_t row0 = static_cast<size_t>(b) * a.S + s0;
  const float* xp = a.x + row0 * xld + static_cast<size_t>(hd) * a.P + p0;
  const T* cp = static_cast<const T*>(a.Cm) + row0 * a.N;
  const float* G = a.G + (static_cast<size_t>(b) * a.chunks + c) * kL * kL;
  const size_t gate0 = static_cast<size_t>(b) * a.S * a.nh + hd;
  // the chunk whose entering state is read (chunk 0's is zero)
  const int src = (a.fault & kFaultWrongState) ? c - 1 : c;
  const size_t head = static_cast<size_t>(b) * a.nh + hd;
  const float* h = a.hin +
                   ((max(src, 1) - 1) * static_cast<size_t>(a.B) * a.nh + head) *
                       a.P * a.N +
                   static_cast<size_t>(p0) * a.N;

  cp_tile_f32<kL, kL / 4>(&sm.G[0][0], kLdO, G, kL, kL, kL);
  cp_tile_f32<kL, kPO / 4>(&sm.x[0][0], kLdO, xp, xld, rows, a.P - p0);
  if constexpr (kBf16) {
    if (src > 0)
      for (int i = t; i < kL * (kMaxN / 8); i += kThreads) {
        const int r = i / (kMaxN / 8), e = i % (kMaxN / 8) * 8;
        const bool ok = r < rows && e < a.N;
        cp_async16(&sm.cy.c[r][e],
                   ok ? cp + static_cast<size_t>(r) * a.N + e : cp, ok);
      }
  }
  cp_async_commit();
  if (src > 0) {
    if constexpr (kBf16) {  // hin through registers into kParts bf16 parts
      float4 hv[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int i = t + kThreads * m, r = i / (kMaxN / 4),
                  e = i % (kMaxN / 4) * 4;
        hv[m] = (p0 + r < a.P && e < a.N)
                    ? *reinterpret_cast<const float4*>(
                          h + static_cast<size_t>(r) * a.N + e)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int i = t + kThreads * m, r = i / (kMaxN / 4),
                  e = i % (kMaxN / 4) * 4;
        unsigned q0[kParts], q1[kParts];
        split_bf16x2(hv[m].x, hv[m].y, q0);
        split_bf16x2(hv[m].z, hv[m].w, q1);
#pragma unroll
        for (int s = 0; s < kParts; ++s)
          *reinterpret_cast<uint2*>(&sm.cy.h[s][r][e]) = make_uint2(q0[s], q1[s]);
      }
    } else {
      stage<kL, kMaxN, false>(&sm.cy.c[0][0], kLdO, cp, a.N, rows, a.N);
      stage<kPO, kMaxN, true>(&sm.cy.hT[0][0], kLdO, h, a.N, a.P - p0, a.N);
    }
  }
  if (warp == 0)
    rebase_chunk(a.cum + gate0, a.nh, s0, rows, a.Q, a.fault & kFaultNoRebase,
                 sm.g);
  cp_async_wait<0>();
  __syncthreads();
  // (C B^T ⊙ decay)[i][j], causal, over the warp's own 16 rows and the
  // keys up to its last row (all that its intra-chunk term reads); the
  // decay by the special-function unit's 2^x (relative error ~2^-22)
  const int kmax = min(rows, 16 * warp + 16);
  constexpr float kLog2e = 1.4426950408889634f;
  for (int r = 16 * warp; r < 16 * warp + 16; ++r)
    for (int j = lane; j < kmax; j += 32)
      sm.G[r][j] = (j <= r && r < rows)
                       ? sm.G[r][j] * exp2_approx((sm.g[r] - sm.g[j]) * kLog2e)
                       : 0.f;
  float acc[kPO / 8][4] = {};
  if (src > 0) {  // acc[i][p] = e^{g_i} sum_n C_i[n] hin[p][n]
    if constexpr (kBf16) {
      const bool drop_lo = a.fault & kFaultSplitLow;
#pragma unroll
      for (int ks = 0; ks < kMaxN / 16; ++ks) {
        unsigned af[4];
        ldmatrix_x4(af, &sm.cy.c[16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8]
                                [16 * ks + (lane >> 4) * 8]);
#pragma unroll
        for (int np = 0; np < kPO / 16; ++np)
#pragma unroll
          for (int s = 0; s < kParts; ++s) {
            if (s > 0 && drop_lo) break;
            unsigned bh[4];
            ldmatrix_x4(bh, &sm.cy.h[s][16 * np + (lane & 7) + (lane >> 4) * 8]
                                    [16 * ks + ((lane >> 3) & 1) * 8]);
            mma_bf16_16816(acc[2 * np], af, bh[0], bh[1]);
            mma_bf16_16816(acc[2 * np + 1], af, bh[2], bh[3]);
          }
      }
    } else {
      for (int n = 0; n < a.N; ++n) {
        const float c0 = sm.cy.c[i0][n], c1 = sm.cy.c[i0 + 8][n];
#pragma unroll
        for (int nt = 0; nt < kPO / 8; ++nt) {
          const float2 hv =
              *reinterpret_cast<const float2*>(&sm.cy.hT[n][8 * nt + 2 * tq]);
          acc[nt][0] += c0 * hv.x;
          acc[nt][1] += c0 * hv.y;
          acc[nt][2] += c1 * hv.x;
          acc[nt][3] += c1 * hv.y;
        }
      }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int i = i0 + 8 * x;
      const float eg = i < rows ? expf(sm.g[i]) : 0.f;
#pragma unroll
      for (int nt = 0; nt < kPO / 8; ++nt) {
        acc[nt][2 * x] *= eg;
        acc[nt][2 * x + 1] *= eg;
      }
    }
  }
  __syncwarp();  // the warp's decayed scores
  // the intra-chunk term: keys j <= the warp's last row
  for (int j = 0; j < kmax; ++j) {
    const float m0 = sm.G[i0][j], m1 = sm.G[i0 + 8][j];
#pragma unroll
    for (int nt = 0; nt < kPO / 8; ++nt) {
      const float2 xv =
          *reinterpret_cast<const float2*>(&sm.x[j][8 * nt + 2 * tq]);
      acc[nt][0] += m0 * xv.x;
      acc[nt][1] += m0 * xv.y;
      acc[nt][2] += m1 * xv.x;
      acc[nt][3] += m1 * xv.y;
    }
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int i = i0 + 8 * x;
    if (i >= rows) continue;
#pragma unroll
    for (int nt = 0; nt < kPO / 8; ++nt) {
      const int p = p0 + 8 * nt + 2 * tq;
      if (p < a.P)
        *reinterpret_cast<float2*>(a.y + (row0 + i) * xld +
                                   static_cast<size_t>(hd) * a.P + p) =
            make_float2(acc[nt][2 * x], acc[nt][2 * x + 1]);
    }
  }
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  static const cudaError_t attr_chunk = cudaFuncSetAttribute(  // once
      mamba_scan_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kChunkSmem<T>);
  if (attr_chunk != cudaSuccess) return static_cast<int>(attr_chunk);
  const int state_blocks = a.B * a.nh * ((a.P + kPT - 1) / kPT);
  const int score_blocks = a.B * a.chunks;
  mamba_scan_chunk_kernel<T><<<state_blocks + score_blocks, kThreads,
                               kChunkSmem<T>, stream>>>(a, state_blocks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  static const cudaError_t attr = cudaFuncSetAttribute(  // once
      mamba_scan_out_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      sizeof(OutSmem<T>));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int out_blocks = a.B * a.chunks * a.nh * ((a.P + kPO - 1) / kPO);
  mamba_scan_out_kernel<T><<<out_blocks, kThreads, sizeof(OutSmem<T>),
                             stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch: hin [chunks - 1, B, nh, P, N] and G [B, chunks, 64, 64] fp32
// (the wrapper's torch.empty; nothing is allocated here).  `chunk` must
// be 64 and `chunks` ceil(S / 64), S = nc * Q (kernels/mamba_scan.py:
// plan_scan).
extern "C" int mamba_chunk_scan_launch(const void* xbar, const void* Bm,
                                       const void* Cm, const void* cum,
                                       void* y, void* state, void* hin,
                                       void* G, int B, int nc, int Q, int nh,
                                       int P, int N, int chunk, int chunks,
                                       int dtype, int fault, void* stream) {
  const int S = nc * Q;
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN || nc < 1 || P < 1 ||
      B < 1 || nh < 1 || chunk != kL || chunks != (S + kL - 1) / kL ||
      P % 4 != 0 || N % (dtype == kBFloat16 ? 8 : 4) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(xbar), Bm, Cm,
               static_cast<const float*>(cum), static_cast<float*>(y),
               static_cast<float*>(state), static_cast<float*>(hin),
               static_cast<float*>(G), B, S, Q, nh, P, N, chunks, fault};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(a, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
