// Chunkwise mLSTM with the matrix memory carried across chunks.
//
//   q, k, v [B, S, nh, dh]; cumf, li [B, S, nh] fp32 (the forget-gate
//   log cumsum, restarted at every caller chunk of Q rows, and the bounded
//   input gate; S = nc * Q); y [B, S, nh, dh] fp32; C [B, nh, dh, dh] and
//   n [B, nh, dh] fp32, all contiguous.  For each chunk, with (C, n) the
//   state entering it and D_ij = e^{cumf_i - cumf_j + li_j} for j <= i:
//     num_i = sum_{j<=i} (q_i . k_j) D_ij v_j + e^{cumf_i} q_i C
//     den_i = sum_{j<=i} (q_i . k_j) D_ij     + e^{cumf_i} q_i . n
//     y_i   = num_i / max(|den_i|, 1)
//     C <- C e^{cumf_last} + sum_j e^{cumf_last - cumf_j + li_j} k_j^T v_j
//     n <- n e^{cumf_last} + sum_j e^{cumf_last - cumf_j + li_j} k_j
//   Every exponent is at most li <= 8 (cumf falls), so fp32 needs no
//   stabiliser state, as in the reference.
//
// Replaces repro/kernels/mlstm.py:mlstm_chunk_scan (Pallas), whose grid
// (B, nc) walks the chunks in order with C [nh, dh, dh] in VMEM (1 MiB a
// head at xlstm-350m's dh = 512).
//
// What bounds it on the H100: bytes (one read of q, k, v, one write of y
// and the state); the products are small for the tensor cores.  So the
// work is cut to fill the 132 SMs even for one chunk of 128 rows:
//  * The caller's chunks are regrouped into kernel chunks of kL = 64 rows
//    (the function is the same: the decay between two rows depends only
//    on the gates between them); cumf is rebased per kernel chunk
//    (scan::rebase_chunk).  Q = 1 then costs no pass per token.
//  * mlstm_scan_chunk_kernel runs two kinds of block in one grid.  State
//    blocks, one per (b, head, 64 rows of d, 64 columns of e), walk the
//    kernel chunks in order with C's tile in registers (the next chunk's
//    rows and gates load while one is summed) and write the state
//    entering each chunk c >= 1 to scratch (Cin[c - 1]) and the final
//    (C, n); the e-tile 0 blocks carry n as one more column of the same
//    product, against a column of ones.  Score blocks, one per (b,
//    kernel chunk, head), form P = (q k^T) masked and decayed and its row
//    sums once, for every value tile.
//  * mlstm_scan_out_kernel, one block per (b, kernel chunk, head, 32
//    columns of e): y = (P v + e^{g} q Cin) / max(|rowsum P + e^{g} q .
//    nin|, 1), the slices of d streamed through a ring of three, q . nin
//    one more column of the q Cin product.
// bf16 inputs run on the tensor cores (mma.sync m16n8k16, fp32 sums).
// q k^T is exact (bf16 products, fp32 sums).  The three other products
// have one fp32 operand (w k, P, Cin): it is split into kParts = 3 bf16
// parts (scan::split_bf16x2) and takes a product of each against the
// exact bf16 one; one bf16 rounding would miss the fp32 limit by 500x,
// and two parts missed it on the card.  Each product's chain on the
// tensor cores is kept short (a chunk, or a 64-wide slice of d, from
// zero) and summed into fp32 registers.  fp32 inputs take the same
// stages on the CUDA cores.  Every sum runs in a fixed order with no
// atomics, so two runs give identical bits.
#include <type_traits>

#include "scan.cuh"

namespace {

using namespace scan;
using bf16 = __nv_bfloat16;

constexpr int kT = 64;        // rows of d and columns of e a state block owns
constexpr int kE = 32;        // columns of e an output block owns
constexpr int kLdB = kT + 8;  // bf16 tile row stride (16-byte rows, no
                              // ldmatrix bank clash)
constexpr int kLdE = kE + 8;  // bf16 tile row stride (the out block keeps
                              // nin in column kE of Cin's parts)
constexpr int kMaxQ = 256;
constexpr int kMaxDh = 512;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* cumf;
  const float* li;
  float* y;
  float* C;
  float* n;
  float* Cin;  // [chunks - 1][B][nh][dh][dh]: the state entering chunk c
  float* nin;  // [chunks - 1][B][nh][dh]      at index c - 1
  float* P;    // [B][chunks][nh][kL][kL]: masked, decayed scores
  float* den;  // [B][chunks][nh][kL]: their row sums
  int B, S, Q, nh, dh, chunks, fault;
};

// ------------------------------------------------------------- bf16 -----
struct StateSmemBf16 {
  bf16 k[2][kL][kLdB];  // k rows of a chunk, this d tile (double buffer)
  bf16 v[2][kL][kLdB];  // v rows, this e tile; column kT holds ones
  float g[2][kL];
  float w[2][kL];       // e^{g_last - g_j + li_j}
  float gl[2];
};

struct ScoreSmemBf16 {
  bf16 q[2][kL][kLdB];  // a 64-wide slice of d of the chunk's q and k rows
  bf16 k[2][kL][kLdB];
  float g[kL];
  float li[kL];
};

constexpr int kRing = 3;     // slices of d in flight in an output block
struct OutSmemBf16 {         // 73,728 bytes: three blocks an SM
  bf16 q[kRing][kL][kLdB];   // a 64-wide slice of d of the chunk's q rows
  float cf[kRing][kT][kE];   // Cin[d slice][e tile] and nin[d slice], as
  float n[kRing][kT];        // they arrive
  bf16 c[kParts][kT][kLdE];  // Cin[d slice][e tile] | nin[d slice], split
  bf16 v[kL][kLdE];          // v rows, this e tile
  float g[kL];
};

// ldmatrix row addresses (lane l): A from a row-major [m][k] tile, B from
// an [n][k] tile (both as in mma's row.col), and B from a [k][n] tile.
__device__ __forceinline__ const bf16* a_addr(const bf16* base, int ld, int m0,
                                              int k0, int l) {
  return base + (m0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + k0 + (l >> 4) * 8;
}
__device__ __forceinline__ const bf16* bnk_addr(const bf16* base, int ld,
                                                int n0, int k0, int l) {
  return base + (n0 + (l & 7) + (l >> 4) * 8) * ld + k0 + ((l >> 3) & 1) * 8;
}
__device__ __forceinline__ const bf16* bkn_addr(const bf16* base, int ld,
                                                int k0, int n0, int l) {
  return base + (k0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + n0 + (l >> 4) * 8;
}

// One (b, head, d tile, e tile): the state entering every kernel chunk.
__device__ void state_block_bf16(const Args& a, int bid, StateSmemBf16& sm) {
  const int dtiles = (a.dh + kT - 1) / kT;
  const int et = bid % dtiles, dt = bid / dtiles % dtiles;
  const int hd = bid / (dtiles * dtiles) % a.nh;
  const int b = bid / (dtiles * dtiles * a.nh);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int d0 = dt * kT, e0 = et * kT;
  const size_t ld = static_cast<size_t>(a.nh) * a.dh;
  const size_t row0 = static_cast<size_t>(b) * a.S;
  const bf16* kp = static_cast<const bf16*>(a.k) + row0 * ld + hd * a.dh + d0;
  const bf16* vp = static_cast<const bf16*>(a.v) + row0 * ld + hd * a.dh + e0;
  const float* cum = a.cumf + row0 * a.nh + hd;
  const float* lip = a.li + row0 * a.nh + hd;
  const bool drop_lo = a.fault & kFaultSplitLow;

  auto load = [&](int c, int buf) {
    const int s0 = c * kL, rows = min(kL, a.S - s0);
    for (int i = t; i < kL * (kT / 8); i += kThreads) {
      const int r = i / (kT / 8), p = i % (kT / 8) * 8;
      const size_t off = static_cast<size_t>(s0 + r) * ld + p;
      const bool okk = r < rows && d0 + p < a.dh;
      const bool okv = r < rows && e0 + p < a.dh;
      cp_async16(&sm.k[buf][r][p], okk ? kp + off : kp, okk);
      cp_async16(&sm.v[buf][r][p], okv ? vp + off : vp, okv);
    }
  };
  // acc[nt]: rows d0 + 16 warp + gq (+8), columns e0 + 8 nt + 2 tq (+1)
  auto store = [&](float* dst, const float (&acc)[8][4]) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = d0 + 16 * warp + gq + 8 * h, e = e0 + 8 * nt + 2 * tq;
        if (d < a.dh && e < a.dh)
          *reinterpret_cast<float2*>(dst + static_cast<size_t>(d) * a.dh + e) =
              make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
      }
  };
  const size_t head = static_cast<size_t>(b) * a.nh + hd;
  const size_t per_chunk = static_cast<size_t>(a.B) * a.nh;
  auto store_n = [&](float* dst, const float (&nv)[2]) {
    if (et != 0 || tq != 0) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = d0 + 16 * warp + gq + 8 * h;
      if (d < a.dh) dst[d] = nv[h];
    }
  };

  const bool no_rebase = a.fault & kFaultNoRebase;
  auto rows_of = [&](int c) { return min(kL, a.S - c * kL); };
  // the next chunk's gates wait in warp 0's registers, its rows in the
  // other buffer, while this chunk is summed
  Gates nxt;
  if (warp == 0) {
    gates_load(cum, lip, a.nh, 0, rows_of(0), a.Q, nxt);
    const float gl = gates_rebase(nxt, 0, rows_of(0), a.Q, no_rebase, sm.g[0],
                                  sm.w[0]);
    if (t == 0) sm.gl[0] = gl;
    if (a.chunks > 1) gates_load(cum, lip, a.nh, kL, rows_of(1), a.Q, nxt);
  }
  float acc[8][4] = {};
  // n[d0 + 16 warp + gq (+8)], on the e-tile-0 blocks' lanes with tq = 0:
  // sum_j w_j k_j[d] is one more column of the product, against a column
  // of ones that every v tile carries in its padding (column kT)
  float nacc[2] = {0.f, 0.f};
  if (et == 0)
    for (int r = t; r < 2 * kL; r += kThreads)
      *reinterpret_cast<unsigned*>(&sm.v[r / kL][r % kL][kT]) =
          pack_bf16x2(1.f, 0.f);
  load(0, 0);
  cp_async_commit();
  for (int c = 0; c < a.chunks; ++c) {
    const int rows = rows_of(c), buf = c & 1;
    __syncthreads();  // chunk c's gates; chunk c - 1 is done with buf ^ 1
    if (c + 1 < a.chunks) load(c + 1, buf ^ 1);
    cp_async_commit();
    if (warp == 0 && c + 1 < a.chunks) {
      const float gl = gates_rebase(nxt, (c + 1) * kL, rows_of(c + 1), a.Q,
                                    no_rebase, sm.g[buf ^ 1], sm.w[buf ^ 1]);
      if (t == 0) sm.gl[buf ^ 1] = gl;
      if (c + 2 < a.chunks)
        gates_load(cum, lip, a.nh, (c + 2) * kL, rows_of(c + 2), a.Q, nxt);
    }
    if (c > 0) {  // the state entering chunk c
      const size_t slot = (c - 1) * per_chunk + head;
      store(a.Cin + slot * a.dh * a.dh, acc);
      store_n(a.nin + slot * a.dh, nacc);
    }
    cp_async_wait<1>();
    __syncthreads();  // chunk c's tiles
    // the chunk's sum_j (w_j k_j[d]) v_j[e], from zero (short chains on
    // the tensor cores): A = (w k)^T split, B = v
    float part[8][4] = {};
    float npart[4] = {};
#pragma unroll
    for (int ks = 0; ks < kL / 16; ++ks) {
      unsigned af[kParts][4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int d = 16 * warp + gq + 8 * (x & 1);
        const int j = 16 * ks + 2 * tq + 8 * (x >> 1);
        unsigned p[kParts];
        split_bf16x2(sm.w[buf][j] * __bfloat162float(sm.k[buf][j][d]),
                     sm.w[buf][j + 1] * __bfloat162float(sm.k[buf][j + 1][d]),
                     p);
#pragma unroll
        for (int s = 0; s < kParts; ++s) af[s][x] = p[s];
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, bkn_addr(&sm.v[buf][0][0], kLdB, 16 * ks,
                                       16 * np, lane));
#pragma unroll
        for (int s = 0; s < kParts; ++s) {
          if (s > 0 && drop_lo) break;
          mma_bf16_16816(part[2 * np], af[s], bv[0], bv[1]);
          mma_bf16_16816(part[2 * np + 1], af[s], bv[2], bv[3]);
        }
      }
      if (et == 0) {  // the column of ones: sum_j w_j k_j[d]
        unsigned bn[2];
        ldmatrix_x2_trans(bn, bkn_addr(&sm.v[buf][0][0], kLdB, 16 * ks, kT,
                                       lane));
#pragma unroll
        for (int s = 0; s < kParts; ++s) {
          if (s > 0 && drop_lo) break;
          mma_bf16_16816(npart, af[s], bn[0], bn[1]);
        }
      }
    }
    const float decay = expf(sm.gl[buf]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[nt][x] = acc[nt][x] * decay + part[nt][x];
    if (et == 0) {
      nacc[0] = nacc[0] * decay + npart[0];
      nacc[1] = nacc[1] * decay + npart[2];
    }
  }
  store(a.C + head * a.dh * a.dh, acc);
  store_n(a.n + head * a.dh, nacc);
}

// A masked, decayed score p_ij = (q_i . k_j) e^{g_i - g_j + li_j}, j <= i.
__device__ __forceinline__ float decayed(float s, int i, int j, int rows,
                                         const float* g, const float* li) {
  return (j <= i && i < rows) ? s * expf(g[i] - g[j] + li[j]) : 0.f;
}

__device__ void score_block_bf16(const Args& a, int sid, ScoreSmemBf16& sm) {
  const int hd = sid % a.nh, c = sid / a.nh % a.chunks;
  const int b = sid / (a.nh * a.chunks);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int s0 = c * kL, rows = min(kL, a.S - s0);
  const size_t ld = static_cast<size_t>(a.nh) * a.dh;
  const size_t row0 = static_cast<size_t>(b) * a.S + s0;
  const bf16* qp = static_cast<const bf16*>(a.q) + row0 * ld + hd * a.dh;
  const bf16* kp = static_cast<const bf16*>(a.k) + row0 * ld + hd * a.dh;
  const size_t gate0 = static_cast<size_t>(b) * a.S * a.nh + hd;

  auto load = [&](int dc, int buf) {
    for (int i = t; i < kL * (kT / 8); i += kThreads) {
      const int r = i / (kT / 8), p = i % (kT / 8) * 8;
      const size_t off = static_cast<size_t>(r) * ld + dc * kT + p;
      const bool ok = r < rows && dc * kT + p < a.dh;
      cp_async16(&sm.q[buf][r][p], ok ? qp + off : qp, ok);
      cp_async16(&sm.k[buf][r][p], ok ? kp + off : kp, ok);
    }
  };
  const int nd = (a.dh + kT - 1) / kT;
  load(0, 0);
  cp_async_commit();
  if (warp == 0)
    rebase_chunk(a.cumf + gate0, a.nh, s0, rows, a.Q,
                 a.fault & kFaultNoRebase, sm.g);
  if (t < kL)
    sm.li[t] = t < rows ? a.li[gate0 + static_cast<size_t>(s0 + t) * a.nh]
                        : 0.f;
  float acc[8][4] = {};
  for (int dc = 0; dc < nd; ++dc) {
    const int buf = dc & 1;
    if (dc + 1 < nd) load(dc + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // slice dc landed
    float part[8][4] = {};  // this slice's products, from zero
#pragma unroll
    for (int ks = 0; ks < kT / 16; ++ks) {
      unsigned af[4];
      ldmatrix_x4(af, a_addr(&sm.q[buf][0][0], kLdB, 16 * warp, 16 * ks, lane));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned bk[4];
        ldmatrix_x4(bk, bnk_addr(&sm.k[buf][0][0], kLdB, 16 * np, 16 * ks,
                                 lane));
        mma_bf16_16816(part[2 * np], af, bk[0], bk[1]);
        mma_bf16_16816(part[2 * np + 1], af, bk[2], bk[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[nt][x] += part[nt][x];
    __syncthreads();  // slice dc is refilled next
  }
  const size_t tile = (static_cast<size_t>(b) * a.chunks + c) * a.nh + hd;
  float* P = a.P + tile * kL * kL;
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 16 * warp + gq + 8 * h, j = 8 * nt + 2 * tq;
      const float p0 = decayed(acc[nt][2 * h], i, j, rows, sm.g, sm.li);
      const float p1 = decayed(acc[nt][2 * h + 1], i, j + 1, rows, sm.g,
                               sm.li);
      rs[h] += p0;
      rs[h] += p1;
      *reinterpret_cast<float2*>(P + i * kL + j) = make_float2(p0, p1);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
    rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
    if (tq == 0) a.den[tile * kL + 16 * warp + gq + 8 * h] = rs[h];
  }
}

// One (b, kernel chunk, head, e tile) of y.
__device__ void out_block_bf16(const Args& a, OutSmemBf16& sm) {
  const int etiles = (a.dh + kE - 1) / kE;
  const int bid = blockIdx.x;
  const int et = bid % etiles, hd = bid / etiles % a.nh;
  const int c = bid / (etiles * a.nh) % a.chunks;
  const int b = bid / (etiles * a.nh * a.chunks);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int s0 = c * kL, rows = min(kL, a.S - s0), e0 = et * kE;
  const size_t ld = static_cast<size_t>(a.nh) * a.dh;
  const size_t row0 = static_cast<size_t>(b) * a.S + s0;
  const bf16* qp = static_cast<const bf16*>(a.q) + row0 * ld + hd * a.dh;
  const bf16* vp = static_cast<const bf16*>(a.v) + row0 * ld + hd * a.dh + e0;
  const size_t gate0 = static_cast<size_t>(b) * a.S * a.nh + hd;
  const bool drop_lo = a.fault & kFaultSplitLow;
  // the chunk whose entering state is read (chunk 0's is zero)
  const int src = (a.fault & kFaultWrongState) ? c - 1 : c;
  const size_t head = static_cast<size_t>(b) * a.nh + hd;
  const size_t slot =
      (static_cast<size_t>(max(src, 1)) - 1) * a.B * a.nh + head;
  const float* Cin = a.Cin + slot * a.dh * a.dh + e0;
  const float* nin = a.nin + slot * a.dh;

  const size_t tile = (static_cast<size_t>(b) * a.chunks + c) * a.nh + hd;
  // the chunk's v rows, this e tile (group 0)
  for (int i = t; i < kL * (kE / 8); i += kThreads) {
    const int r = i / (kE / 8), p = i % (kE / 8) * 8;
    const bool ok = r < rows && e0 + p < a.dh;
    cp_async16(&sm.v[r][p], ok ? vp + static_cast<size_t>(r) * ld + p : vp,
               ok);
  }
  cp_async_commit();
  if (warp == 0)
    rebase_chunk(a.cumf + gate0, a.nh, s0, rows, a.Q,
                 a.fault & kFaultNoRebase, sm.g);

  float acc[kE / 8][4] = {};
  float qacc[4] = {};  // q . nin in the mma layout of a column tile
  if (src > 0) {
    // acc[i][e] = sum_d q_i[d] Cin[d][e]: A = q, B = Cin split.  Slices
    // dc + 1 and dc + 2 of q, Cin and nin arrive (cp.async, a ring of
    // kRing) while dc is summed.
    auto load = [&](int dc, int buf) {
      for (int i = t; i < kL * (kT / 8); i += kThreads) {
        const int r = i / (kT / 8), p = i % (kT / 8) * 8;
        const bool ok = r < rows && dc * kT + p < a.dh;
        cp_async16(&sm.q[buf][r][p],
                   ok ? qp + static_cast<size_t>(r) * ld + dc * kT + p : qp,
                   ok);
      }
      cp_tile_f32<kT, kE / 4>(&sm.cf[buf][0][0], kE,
                              Cin + static_cast<size_t>(dc) * kT * a.dh, a.dh,
                              a.dh - dc * kT, a.dh - e0);
      for (int i = t; i < kT / 4; i += kThreads) {
        const bool ok = dc * kT + 4 * i < a.dh;
        cp_async16(&sm.n[buf][4 * i], ok ? nin + dc * kT + 4 * i : nin, ok);
      }
    };
    const int nd = (a.dh + kT - 1) / kT;
    for (int dc = 0; dc < kRing - 1; ++dc) {
      if (dc < nd) load(dc, dc);
      cp_async_commit();
    }
    for (int dc = 0; dc < nd; ++dc) {
      const int buf = dc % kRing;
      cp_async_wait<kRing - 2>();
      __syncthreads();  // slice dc landed; slice dc - 1 is done with its
                        // stage and with c
      if (dc + kRing - 1 < nd) load(dc + kRing - 1, (dc + kRing - 1) % kRing);
      cp_async_commit();
#pragma unroll
      for (int m = 0; m < kT * kE / 4 / kThreads; ++m) {
        const int i = t + kThreads * m, r = i / (kE / 4), p = i % (kE / 4) * 4;
        const float4 cv = *reinterpret_cast<const float4*>(&sm.cf[buf][r][p]);
        unsigned p0[kParts], p1[kParts];
        split_bf16x2(cv.x, cv.y, p0);
        split_bf16x2(cv.z, cv.w, p1);
#pragma unroll
        for (int s = 0; s < kParts; ++s)
          *reinterpret_cast<uint2*>(&sm.c[s][r][p]) = make_uint2(p0[s], p1[s]);
      }
      if (t < kT) {  // nin[d] as column kE (kE + 1 zero)
        unsigned pn[kParts];
        split_bf16x2(sm.n[buf][t], 0.f, pn);
#pragma unroll
        for (int s = 0; s < kParts; ++s)
          *reinterpret_cast<unsigned*>(&sm.c[s][t][kE]) = pn[s];
      }
      __syncthreads();  // the parts of Cin and nin
      float part[kE / 8][4] = {};  // this slice's products, from zero
      float qpart[4] = {};
#pragma unroll
      for (int ks = 0; ks < kT / 16; ++ks) {
        unsigned af[4];
        ldmatrix_x4(af, a_addr(&sm.q[buf][0][0], kLdB, 16 * warp, 16 * ks,
                               lane));
#pragma unroll
        for (int np = 0; np < kE / 16; ++np)
#pragma unroll
          for (int s = 0; s < kParts; ++s) {
            if (s > 0 && drop_lo) break;
            unsigned bc[4];
            ldmatrix_x4_trans(bc, bkn_addr(&sm.c[s][0][0], kLdE, 16 * ks,
                                           16 * np, lane));
            mma_bf16_16816(part[2 * np], af, bc[0], bc[1]);
            mma_bf16_16816(part[2 * np + 1], af, bc[2], bc[3]);
          }
#pragma unroll
        for (int s = 0; s < kParts; ++s) {  // q . nin, column kE
          if (s > 0 && drop_lo) break;
          unsigned bn[2];
          ldmatrix_x2_trans(bn, bkn_addr(&sm.c[s][0][0], kLdE, 16 * ks, kE,
                                         lane));
          mma_bf16_16816(qpart, af, bn[0], bn[1]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < kE / 8; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[nt][x] += part[nt][x];
#pragma unroll
      for (int x = 0; x < 4; ++x) qacc[x] += qpart[x];
    }
  }
  // q_i . nin of rows gq, gq + 8, from the quad's first lane (column kE)
  const float qn[2] = {__shfl_sync(0xffffffffu, qacc[0], lane & ~3),
                       __shfl_sync(0xffffffffu, qacc[2], lane & ~3)};
  // P's fragments for P v, from device memory (0 above the diagonal, so
  // warp w reads key tiles 0 .. w)
  const float* P = a.P + tile * kL * kL;
  float2 pf[kL / 16][4];
#pragma unroll
  for (int ks = 0; ks < kL / 16; ++ks)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = 16 * warp + gq + 8 * (x & 1);
      const int j = 16 * ks + 2 * tq + 8 * (x >> 1);
      pf[ks][x] = ks <= warp ? *reinterpret_cast<const float2*>(P + i * kL + j)
                             : make_float2(0.f, 0.f);
    }
  cp_async_wait<0>();
  __syncthreads();  // v, g

  // the carried term's rows decay by e^{g_i}; then acc += P v (P split)
  float eg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = 16 * warp + gq + 8 * h;
    eg[h] = i < rows ? expf(sm.g[i]) : 0.f;
#pragma unroll
    for (int nt = 0; nt < kE / 8; ++nt) {
      acc[nt][2 * h] *= eg[h];
      acc[nt][2 * h + 1] *= eg[h];
    }
  }
  float part[kE / 8][4] = {};  // P v, from zero
#pragma unroll
  for (int ks = 0; ks < kL / 16; ++ks) {
    if (ks > warp) break;
    unsigned af[kParts][4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float2 pv = pf[ks][x];
      unsigned p[kParts];
      split_bf16x2(pv.x, pv.y, p);
#pragma unroll
      for (int s = 0; s < kParts; ++s) af[s][x] = p[s];
    }
#pragma unroll
    for (int np = 0; np < kE / 16; ++np) {
      unsigned bv[4];
      ldmatrix_x4_trans(bv, bkn_addr(&sm.v[0][0], kLdE, 16 * ks, 16 * np,
                                     lane));
#pragma unroll
      for (int s = 0; s < kParts; ++s) {
        if (s > 0 && drop_lo) break;
        mma_bf16_16816(part[2 * np], af[s], bv[0], bv[1]);
        mma_bf16_16816(part[2 * np + 1], af[s], bv[2], bv[3]);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < kE / 8; ++nt)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[nt][x] += part[nt][x];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = 16 * warp + gq + 8 * h;
    if (i >= rows) continue;
    const float den =
        fmaxf(fabsf(a.den[tile * kL + i] + eg[h] * qn[h]), 1.f);
#pragma unroll
    for (int nt = 0; nt < kE / 8; ++nt) {
      const int e = e0 + 8 * nt + 2 * tq;
      if (e < a.dh)
        *reinterpret_cast<float2*>(a.y + (row0 + i) * ld + hd * a.dh + e) =
            make_float2(acc[nt][2 * h] / den, acc[nt][2 * h + 1] / den);
    }
  }
}

// ------------------------------------------------------------- fp32 -----
// The same roles on the CUDA cores, each thread a 4 x 8 (or 4 x 4) share
// of a 64-row tile (scan::fma_tile), operands staged k-major.
struct StateSmemF32 {
  float kw[kL][kT + 4];  // w_j k_j[d tile]
  float v[kL][kT + 4];   // v_j[e tile]
  float g[kL];
  float w[kL];
  float gl;
};

constexpr int kD = 32;  // the fp32 kernels' slice of d (double-buffered)

struct ScoreSmemF32 {
  float q[2][kL][kD + 4];  // a 32-wide slice of d of the chunk's q and k
  float k[2][kL][kD + 4];
  float g[kL];
  float li[kL];
};

struct OutSmemF32 {
  float q[2][kL][kD + 4];  // a 32-wide slice of d of the chunk's q rows
  float c[2][kD][kE + 4];  // Cin[d slice][e tile]
  float n[2][kD];          // nin[d slice]
  float P[kL][kL + 4];     // the chunk's masked, decayed scores
  float v[kL][kE + 4];     // v rows, this e tile
  float g[kL];
  float qn[kL];
};

__device__ void state_block_f32(const Args& a, int bid, StateSmemF32& sm) {
  const int dtiles = (a.dh + kT - 1) / kT;
  const int et = bid % dtiles, dt = bid / dtiles % dtiles;
  const int hd = bid / (dtiles * dtiles) % a.nh;
  const int b = bid / (dtiles * dtiles * a.nh);
  const int t = threadIdx.x, warp = t / 32;
  const int r0 = t / 8, c0 = t % 8;
  const int d0 = dt * kT, e0 = et * kT;
  const size_t ld = static_cast<size_t>(a.nh) * a.dh;
  const size_t row0 = static_cast<size_t>(b) * a.S;
  const float* kp = static_cast<const float*>(a.k) + row0 * ld + hd * a.dh + d0;
  const float* vp = static_cast<const float*>(a.v) + row0 * ld + hd * a.dh + e0;
  const float* cum = a.cumf + row0 * a.nh + hd;
  const float* lip = a.li + row0 * a.nh + hd;
  const size_t head = static_cast<size_t>(b) * a.nh + hd;
  const size_t per_chunk = static_cast<size_t>(a.B) * a.nh;
  auto store = [&](float* dst, const float (&acc)[4][8]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = d0 + r0 + 16 * i, e = e0 + c0 + 8 * j;
        if (d < a.dh && e < a.dh) dst[static_cast<size_t>(d) * a.dh + e] =
            acc[i][j];
      }
  };

  float acc[4][8] = {};
  float nacc = 0.f;
  for (int c = 0; c < a.chunks; ++c) {
    const int s0 = c * kL, rows = min(kL, a.S - s0);
    __syncthreads();  // chunk c - 1 is done with the tiles, g and w
    if (warp == 0) {
      Gates v;
      gates_load(cum, lip, a.nh, s0, rows, a.Q, v);
      const float gl = gates_rebase(v, s0, rows, a.Q, a.fault & kFaultNoRebase,
                                    sm.g, sm.w);
      if (t == 0) sm.gl = gl;
    }
    if (c > 0) {
      const size_t slot = (c - 1) * per_chunk + head;
      store(a.Cin + slot * a.dh * a.dh, acc);
      if (et == 0 && t < kT && d0 + t < a.dh)
        a.nin[slot * a.dh + d0 + t] = nacc;
    }
    stage<kL, kT, false>(&sm.kw[0][0], kT + 4, kp + static_cast<size_t>(s0) * ld,
                         ld, rows, a.dh - d0);
    stage<kL, kT, false>(&sm.v[0][0], kT + 4, vp + static_cast<size_t>(s0) * ld,
                         ld, rows, a.dh - e0);
    __syncthreads();
    for (int i = t; i < kL * kT; i += kThreads) sm.kw[i / kT][i % kT] *= sm.w[i / kT];
    __syncthreads();
    const float decay = expf(sm.gl);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= decay;
    fma_tile<8>(acc, &sm.kw[0][0], kT + 4, &sm.v[0][0], kT + 4, rows);
    if (et == 0 && t < kT) {
      nacc *= decay;
      for (int j = 0; j < rows; ++j) nacc += sm.kw[j][t];
    }
  }
  store(a.C + head * a.dh * a.dh, acc);
  if (et == 0 && t < kT && d0 + t < a.dh) a.n[head * a.dh + d0 + t] = nacc;
}

__device__ void score_block_f32(const Args& a, int sid, ScoreSmemF32& sm) {
  const int hd = sid % a.nh, c = sid / a.nh % a.chunks;
  const int b = sid / (a.nh * a.chunks);
  const int t = threadIdx.x, warp = t / 32;
  const int r0 = t / 8, c0 = t % 8;
  const int s0 = c * kL, rows = min(kL, a.S - s0);
  const size_t ld = static_cast<size_t>(a.nh) * a.dh;
  const size_t row0 = static_cast<size_t>(b) * a.S + s0;
  const float* qp = static_cast<const float*>(a.q) + row0 * ld + hd * a.dh;
  const float* kp = static_cast<const float*>(a.k) + row0 * ld + hd * a.dh;
  const size_t gate0 = static_cast<size_t>(b) * a.S * a.nh + hd;
  auto load = [&](int dc, int buf) {
    cp_tile_f32<kL, kD / 4>(&sm.q[buf][0][0], kD + 4, qp + dc * kD, ld, rows,
                            a.dh - dc * kD);
    cp_tile_f32<kL, kD / 4>(&sm.k[buf][0][0], kD + 4, kp + dc * kD, ld, rows,
                            a.dh - dc * kD);
  };
  const int nd = (a.dh + kD - 1) / kD;
  load(0, 0);
  cp_async_commit();
  if (warp == 0)
    rebase_chunk(a.cumf + gate0, a.nh, s0, rows, a.Q,
                 a.fault & kFaultNoRebase, sm.g);
  if (t < kL)
    sm.li[t] = t < rows ? a.li[gate0 + static_cast<size_t>(s0 + t) * a.nh]
                        : 0.f;
  float acc[4][8] = {};
  for (int dc = 0; dc < nd; ++dc) {
    const int buf = dc & 1;
    cp_async_wait<0>();
    __syncthreads();  // slice dc landed; slice dc - 1 is done with buf ^ 1
    if (dc + 1 < nd) load(dc + 1, buf ^ 1);
    cp_async_commit();
    fma_tile<8, true, true>(acc, &sm.q[buf][0][0], kD + 4, &sm.k[buf][0][0],
                            kD + 4, kD);
  }
  const size_t tile = (static_cast<size_t>(b) * a.chunks + c) * a.nh + hd;
  float* P = a.P + tile * kL * kL;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int i = r0 + 16 * x;
    float rs = 0.f;
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      const int j = c0 + 8 * y;
      const float p = decayed(acc[x][y], i, j, rows, sm.g, sm.li);
      rs += p;
      P[i * kL + j] = p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    rs += __shfl_xor_sync(0xffffffffu, rs, 4);
    if (c0 == 0) a.den[tile * kL + i] = rs;
  }
}

__device__ void out_block_f32(const Args& a, OutSmemF32& sm) {
  const int etiles = (a.dh + kE - 1) / kE;
  const int bid = blockIdx.x;
  const int et = bid % etiles, hd = bid / etiles % a.nh;
  const int c = bid / (etiles * a.nh) % a.chunks;
  const int b = bid / (etiles * a.nh * a.chunks);
  const int t = threadIdx.x, warp = t / 32;
  const int r0 = t / 8, c0 = t % 8;
  const int s0 = c * kL, rows = min(kL, a.S - s0), e0 = et * kE;
  const size_t ld = static_cast<size_t>(a.nh) * a.dh;
  const size_t row0 = static_cast<size_t>(b) * a.S + s0;
  const float* qp = static_cast<const float*>(a.q) + row0 * ld + hd * a.dh;
  const float* vp = static_cast<const float*>(a.v) + row0 * ld + hd * a.dh + e0;
  const size_t gate0 = static_cast<size_t>(b) * a.S * a.nh + hd;
  const int src = (a.fault & kFaultWrongState) ? c - 1 : c;
  const size_t head = static_cast<size_t>(b) * a.nh + hd;
  const size_t slot =
      (static_cast<size_t>(max(src, 1)) - 1) * a.B * a.nh + head;
  const float* Cin = a.Cin + slot * a.dh * a.dh + e0;
  const float* nin = a.nin + slot * a.dh;
  const size_t tile = (static_cast<size_t>(b) * a.chunks + c) * a.nh + hd;
  // the chunk's scores and v rows, this e tile (group 0)
  cp_tile_f32<kL, kL / 4>(&sm.P[0][0], kL + 4, a.P + tile * kL * kL, kL, kL,
                          kL);
  cp_tile_f32<kL, kE / 4>(&sm.v[0][0], kE + 4, vp, ld, rows, a.dh - e0);
  cp_async_commit();
  if (warp == 0)
    rebase_chunk(a.cumf + gate0, a.nh, s0, rows, a.Q,
                 a.fault & kFaultNoRebase, sm.g);
  float acc[4][kE / 8] = {};
  float qn = 0.f;  // row t (t < kL)
  if (src > 0) {  // acc[i][e] = sum_d q_i[d] Cin[d][e], slice by slice
    const int nd = (a.dh + kD - 1) / kD;
    for (int dc = 0; dc <= nd; ++dc) {  // slice dc arrives, dc - 1 is summed
      const int buf = (dc - 1) & 1;
      if (dc > 0) cp_async_wait<0>();
      __syncthreads();  // slice dc - 1 landed; dc - 2 is done with buf ^ 1
      if (dc < nd) {
        cp_tile_f32<kL, kD / 4>(&sm.q[dc & 1][0][0], kD + 4, qp + dc * kD, ld,
                                rows, a.dh - dc * kD);
        cp_tile_f32<kD, kE / 4>(&sm.c[dc & 1][0][0], kE + 4,
                                Cin + static_cast<size_t>(dc) * kD * a.dh,
                                a.dh, a.dh - dc * kD, a.dh - e0);
        for (int i = t; i < kD / 4; i += kThreads) {
          const bool ok = dc * kD + 4 * i < a.dh;
          cp_async16(&sm.n[dc & 1][4 * i], ok ? nin + dc * kD + 4 * i : nin,
                     ok);
        }
      }
      cp_async_commit();
      if (dc == 0) continue;
      fma_tile<kE / 8, true, false>(acc, &sm.q[buf][0][0], kD + 4,
                                    &sm.c[buf][0][0], kE + 4, kD);
      if (t < kL)
        for (int d = 0; d < kD; ++d) qn += sm.q[buf][t][d] * sm.n[buf][d];
    }
  }
  if (t < kL) sm.qn[t] = qn;
  cp_async_wait<0>();
  __syncthreads();  // P, v, g, qn
  float eg[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int i = r0 + 16 * x;
    eg[x] = i < rows ? expf(sm.g[i]) : 0.f;
#pragma unroll
    for (int y = 0; y < kE / 8; ++y) acc[x][y] *= eg[x];
  }
  fma_tile<kE / 8, true, false>(acc, &sm.P[0][0], kL + 4, &sm.v[0][0], kE + 4,
                                rows);
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int i = r0 + 16 * x;
    if (i >= rows) continue;
    const float den =
        fmaxf(fabsf(a.den[tile * kL + i] + eg[x] * sm.qn[i]), 1.f);
#pragma unroll
    for (int y = 0; y < kE / 8; ++y) {
      const int e = e0 + c0 + 8 * y;
      if (e < a.dh) a.y[(row0 + i) * ld + hd * a.dh + e] = acc[x][y] / den;
    }
  }
}

// ---------------------------------------------------------- kernels -----
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mlstm_scan_chunk_kernel(const Args a, int state_blocks) {
  constexpr bool kBf16 = sizeof(T) == 2;
  using StateS = typename std::conditional<kBf16, StateSmemBf16,
                                           StateSmemF32>::type;
  using ScoreS = typename std::conditional<kBf16, ScoreSmemBf16,
                                           ScoreSmemF32>::type;
  __shared__ __align__(16) unsigned char raw[cmax(sizeof(StateS),
                                                  sizeof(ScoreS))];
  if (static_cast<int>(blockIdx.x) < state_blocks) {
    if constexpr (kBf16)
      state_block_bf16(a, blockIdx.x, smem_as<StateS>(raw));
    else
      state_block_f32(a, blockIdx.x, smem_as<StateS>(raw));
  } else {
    if constexpr (kBf16)
      score_block_bf16(a, blockIdx.x - state_blocks, smem_as<ScoreS>(raw));
    else
      score_block_f32(a, blockIdx.x - state_blocks, smem_as<ScoreS>(raw));
  }
}

template <typename T>
using OutSmem =
    typename std::conditional<sizeof(T) == 2, OutSmemBf16, OutSmemF32>::type;

template <typename T>
__global__ void __launch_bounds__(kThreads) mlstm_scan_out_kernel(const Args a) {
  constexpr bool kBf16 = sizeof(T) == 2;
  using OutS = OutSmem<T>;
  extern __shared__ __align__(16) unsigned char raw[];
  if constexpr (kBf16)
    out_block_bf16(a, smem_as<OutS>(raw));
  else
    out_block_f32(a, smem_as<OutS>(raw));
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  const int dtiles = (a.dh + kT - 1) / kT;
  const int state_blocks = a.B * a.nh * dtiles * dtiles;
  const int score_blocks = a.B * a.chunks * a.nh;
  mlstm_scan_chunk_kernel<T><<<state_blocks + score_blocks, kThreads, 0,
                               stream>>>(a, state_blocks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  static const cudaError_t attr = cudaFuncSetAttribute(  // once
      mlstm_scan_out_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      sizeof(OutSmem<T>));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int out_blocks = a.B * a.chunks * a.nh * ((a.dh + kE - 1) / kE);
  mlstm_scan_out_kernel<T><<<out_blocks, kThreads, sizeof(OutSmem<T>),
                             stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch: Cin [chunks - 1, B, nh, dh, dh], nin [chunks - 1, B, nh, dh],
// P [B, chunks, nh, 64, 64], den [B, chunks, nh, 64] fp32 (the wrapper's
// torch.empty; nothing is allocated here).  `chunk` must be 64 and
// `chunks` ceil(S / 64), S = nc * Q (kernels/mamba_scan.py:plan_scan).
extern "C" int mlstm_chunk_scan_launch(
    const void* q, const void* k, const void* v, const void* cumf,
    const void* li, void* y, void* C, void* n, void* Cin, void* nin, void* P,
    void* den, int B, int nc, int Q, int nh, int dh, int chunk, int chunks,
    int dtype, int fault, void* stream) {
  const int S = nc * Q;
  if (Q < 1 || Q > kMaxQ || dh < 1 || dh > kMaxDh || nc < 1 || B < 1 ||
      nh < 1 || chunk != kL || chunks != (S + kL - 1) / kL ||
      dh % (dtype == kBFloat16 ? 8 : 4) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, static_cast<const float*>(cumf),
               static_cast<const float*>(li), static_cast<float*>(y),
               static_cast<float*>(C), static_cast<float*>(n),
               static_cast<float*>(Cin), static_cast<float*>(nin),
               static_cast<float*>(P), static_cast<float*>(den),
               B, S, Q, nh, dh, chunks, fault};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(a, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
