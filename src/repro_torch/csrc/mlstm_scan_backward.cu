// Gradient of the chunkwise mLSTM scan (mlstm_scan.cu).
//
//   q, k, v [B, S, nh, dh] (fp32 or bf16); g [B, chunks * kL, nh] fp32, the
//   forget-gate log cumsum rebased per kernel chunk of kL rows (0 past S;
//   kernels/mamba_scan.py:rebase); li [B, S, nh] fp32; y, dy [B, S, nh, dh]
//   fp32 (the forward's output and its cotangent); dC [B, nh, dh, dh], dn
//   [B, nh, dh] fp32 (the final state's).  Out: dq, dk, dv in q's dtype,
//   dg [B, chunks * kL, nh] and dli [B, S, nh] fp32 (the wrapper maps dg
//   back through rebase's adjoint to dcumf).
//
// The normaliser is one more value column: with v' = [v, 1] and the state
// C' = [C, n], den_i is num_i with v replaced by 1.  With m_i =
// max(|den_i|, 1), dnum_i = dy_i / m_i and dden_i = -sign(den_i) [|den_i|
// > 1] (dy_i . y_i) / m_i.  Per kernel chunk, with w_ij = e^{g_i - g_j +
// li_j} (j <= i), D_ij = dnum'_i . v'_j, w^s_j = e^{gl - g_j + li_j}, C'_in
// the state entering and dC'_out the cotangent of the state leaving:
//   dC'_in = e^{gl} dC'_out + sum_i e^{g_i} q_i dnum'_i^T
//   dq_i   = sum_j w_ij D_ij k_j + e^{g_i} C'_in dnum'_i
//   dk_j   = sum_i w_ij D_ij q_i + w^s_j dC'_out v'_j
//   dv_j   = sum_i w_ij (q_i . k_j) dnum_i + w^s_j k_j^T dC_out
//   dg     = row sums - column sums of w_ij (q_i . k_j) D_ij,
//            + dnum'_i . (e^{g_i} q_i C'_in), - k_j . (the state part of
//            dk_j), and at the last row e^{gl} <dC'_out, C'_in> + the sum
//            of k_j . (the state part of dk_j);
//   dli_j  = the column sums + k_j . (the state part of dk_j).
//
// The port's own: the TPU kernel repro/kernels/mlstm.py:mlstm_chunk_scan
// has no backward, and the reference differentiates repro/models/
// xlstm.py's pure-JAX scan with jax.grad.  The forward keeps its schema
// and saves only y, so the backward recomputes the state entering each
// kernel chunk and the normaliser.
//
// What bounds it on the H100: operations (at xlstm-350m's dh = 512 the
// products with the [dh, dh] states, about 4 L dh^2 multiply-adds a (b,
// kernel chunk, head)).  With bf16 inputs every 64 x 64 x 64 product runs
// on the tensor cores (mma.sync m16n8k16, fp32 sums; scan::bwd::mma_tile):
// q k^T is exact, an fp32 operand (a state, dy, the weighted scores) is
// split into two bf16 parts, and a product of two fp32 operands keeps hi
// hi + hi lo + lo hi; scale vectors ride on the fp32 side.  fp32 inputs
// take the same tiles as three TF32 products (mma.m16n8k8, hi hi + hi lo
// + lo hi of each operand's TF32 parts, about 2^-21 relative).  Six launches (four with one
// kernel chunk):
//  1. mlstm_bwd_pass_kernel, forward (two kernel chunks or more): one
//     block per (b, head, 64 x 64 tile of C) walks chunks 0 .. n - 2 and
//     writes the state entering chunks 1 .. n - 1 (Cin, and n in the e-tile
//     0 blocks); the last chunk's product is read by nobody and not formed.
//  2. mlstm_bwd_rows_kernel, one block per (b, kernel chunk, head, 64
//     columns of d): that tile's q k^T, dy v^T, q . n_in and dy . y.
//  3. mlstm_bwd_combine_kernel, one block per (b, kernel chunk, head): the
//     tiles summed in order; den, 1 / m, dden and the weighted matrices
//     W1 = w D, W2 = w (q . k) with dg's intra-chunk row and column sums.
//  4. mlstm_bwd_pass_kernel, reverse (two kernel chunks or more): the same
//     blocks walk chunks n - 1 .. 1 from (dC, dn), read in place, and write
//     the cotangent leaving chunks 0 .. n - 2 (dCo, dno); first each
//     block's part of <dC'_out, C'_in> of the chunk it is at.
//  5. mlstm_bwd_out_kernel, three roles of block per (b, kernel chunk,
//     head, 64 columns): dq (the state product with C_in streamed 64
//     columns of e at a time), dk (with dC_out), dv (with dC_out's
//     columns), the next slice staged by cp.async while one is multiplied;
//     dq's and dk's blocks write their parts of dg and dli.
//  6. mlstm_bwd_gates_kernel, one block per (b, kernel chunk, head): the
//     column tiles' parts of dg and dli and the state tiles' parts of
//     <dC'_out, C'_in>, summed in order.
// Around them the rebase of cumf (scan::bwd::rebase_kernel) and its
// adjoint (rebase_adjoint_kernel), one launch each.
// No atomics: two runs give identical bits.
#include "scan.cuh"

namespace {

using scan::kL;
using scan::bwd::first;
using scan::bwd::get;
using scan::bwd::kFLd;
using scan::bwd::kLdOf;
using scan::bwd::load_tile;
using scan::bwd::mma_tile;
using scan::bwd::Opnd;
using scan::bwd::put2;
using scan::bwd::put_tile;
using scan::bwd::quad_sum;

constexpr int kTile = 64;          // rows of d and columns of e a tile holds
constexpr int kLd = kL + 1;        // launch 3's fp32 tiles' row stride
constexpr int kPassThreads = 128;  // launches 1, 2, 4: four warps, 16 rows each
constexpr int kOutThreads = 256;   // launch 5: eight warps, 16 x 32 each
constexpr int kRowsThreads = 256;  // launch 3: 4 x 4 elements a thread

// planted faults (kernels/mlstm.py FAULT_*), for the checks only
constexpr int kFaultWrongCotangent = 1;  // chunk c reads dC'_out of c + 1
constexpr int kFaultDropTile = 2;        // dg's sum drops the last d tile
constexpr int kFaultOnePart = 4;         // every split cut to one part
constexpr int kFaultRowsDropTile = 8;    // launch 3 drops launch 2's last tile
constexpr int kFaultStateDropTile = 16;  // <dC'_out, C'_in> drops a tile

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* g;
  const float* li;
  const float* y;
  const float* dy;
  const float* dC;
  const float* dn;
  float* Cin;   // [chunks - 1][B][nh][dh][dh]: the state entering 1 ..
  float* nin;   // [chunks - 1][B][nh][dh]
  float* dCo;   // [chunks - 1][B][nh][dh][dh]: the cotangent leaving 0 ..
  float* dno;   // [chunks - 1][B][nh][dh]
  float* part;  // [B][chunks][nh][tiles][2][kL][kL]: q k^T, dy v^T a d tile
  float* pv;    // [B][chunks][nh][tiles][2][kL]: q . n_in, dy . y a d tile
  float* W1;    // [B][chunks][nh][kL][kL]: w_ij D_ij
  float* W2;    // [B][chunks][nh][kL][kL]: w_ij (q_i . k_j)
  float* rows;  // [4][B][chunks][nh][kL]: 1 / m, dden, rowA - colA, colA
  float* stp;   // [B][chunks][nh][tiles^2]: <dC'_out, C'_in> a state tile
  float* pq;    // [B][chunks][tiles][kL][nh]: dg's carried part a d tile
  float* pk;    // [B][chunks][tiles][kL][nh]: k . (dk's state part)
  void* dq;
  void* dk;
  void* dv;
  float* dg;
  float* dli;
  int B, S, nh, dh, chunks, tiles, vec, fault;
};

__device__ __forceinline__ float g_at(const Args& a, int b, int t, int hd) {
  return a.g[(static_cast<size_t>(b) * a.chunks * kL + t) * a.nh + hd];
}

__device__ __forceinline__ float li_at(const Args& a, int b, int t, int hd) {
  return a.li[(static_cast<size_t>(b) * a.S + t) * a.nh + hd];
}

// the offset of row s0 of a [B, S, nh, dh] tensor, head hd
__device__ __forceinline__ size_t row_at(const Args& a, int b, int s0, int hd) {
  return ((static_cast<size_t>(b) * a.S + s0) * a.nh + hd) * a.dh;
}

__device__ __forceinline__ size_t row_scalar(const Args& a, int which, int b, int c,
                                             int hd) {
  return (((static_cast<size_t>(which) * a.B + b) * a.chunks + c) * a.nh + hd) * kL;
}

// the [dh, dh] (or [dh]) scratch slot `slot` of head (b, hd)
__device__ __forceinline__ size_t slot_at(const Args& a, int slot, int b, int hd,
                                          size_t size) {
  return ((static_cast<size_t>(slot) * a.B + b) * a.nh + hd) * size;
}

__device__ __forceinline__ int parts(const Args& a) {
  return (a.fault & kFaultOnePart) ? 1 : scan::bwd::kParts;
}

// ---- launches 1 and 4: the ordered passes over the kernel chunks ----
template <typename T>
struct PassSmem {
  Opnd<T> a;  // forward: (w^s k) split, [j][d]; reverse: q exact, [i][d]
  Opnd<T> b;  // forward: v exact, [j][e]; reverse: e^g dy / m split, [i][e]
  union alignas(16) {
    T stk[kL][kLdOf<T>];   // forward: the k rows staged
    float cin[kL][kFLd];   // reverse: C'_in's tile, for <dC'_out, C'_in>
  } u;
  alignas(16) float stdy[kL][kFLd];  // reverse: the dy rows staged
  float sc[kL];  // forward: w^s_j; reverse: e^{g_i} / m_i
  float sn[kL];  // reverse: e^{g_i} dden_i
  float red[kPassThreads / 32];
};

// Forward: C(d, e) <- e^{gl} C + sum_j (w^s_j k_j[d]) v_j[e], n likewise
// against a column of ones, from zero over chunks 0 .. n - 2, each result
// stored as the state entering the next chunk.  Reverse: dC <- e^{gl} dC +
// sum_i q_i[d] (e^{g_i} dnum_i[e]), dn against the column dden, from (dC,
// dn) over chunks n - 1 .. 1, each stored as the cotangent leaving the
// chunk before, and first the chunk's part of <dC'_out, C'_in>.  One
// block per (b, head, d tile, e tile); warp w holds rows 16 w .. 16 w +
// 15 of the tile, all 64 columns.
template <typename T, bool kReverse>
__global__ void __launch_bounds__(kPassThreads) mlstm_bwd_pass_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char raw[];
  PassSmem<T>& sm = *reinterpret_cast<PassSmem<T>*>(raw);
  const int bid = blockIdx.x;
  const int et = bid % a.tiles, dt = bid / a.tiles % a.tiles;
  const int hd = bid / (a.tiles * a.tiles) % a.nh, b = bid / (a.tiles * a.tiles * a.nh);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32, gq = lane / 4, tq = lane % 4;
  const int d0 = dt * kTile, e0 = et * kTile;
  const size_t dd2 = static_cast<size_t>(a.dh) * a.dh;
  const size_t ld = static_cast<size_t>(a.nh) * a.dh;
  const int np = parts(a);
  const bool ncol = et == 0 && t < kTile && d0 + t < a.dh;  // n's row d0 + t
  float h[8][4];
  float hn = 0.f;
  const float* init = a.dC + slot_at(a, 0, b, hd, dd2);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int d = d0 + 16 * warp + gq + 8 * (x >> 1), e = e0 + 8 * nt + 2 * tq + (x & 1);
      h[nt][x] = (kReverse && d < a.dh && e < a.dh) ? init[static_cast<size_t>(d) * a.dh + e]
                                                   : 0.f;
    }
  if (kReverse && ncol) hn = a.dn[slot_at(a, 0, b, hd, a.dh) + d0 + t];
  for (int s = 0; s + 1 < a.chunks; ++s) {
    const int c = kReverse ? a.chunks - 1 - s : s;
    const int s0 = c * kL, rows = min(kL, a.S - s0);
    const float gl = g_at(a, b, s0 + rows - 1, hd);
    __syncthreads();  // the chunk before is done with the tiles
    if (t < kL) {
      const float gr = g_at(a, b, s0 + t, hd);
      if (kReverse) {
        const float eg = t < rows ? expf(gr) : 0.f;
        sm.sc[t] = eg * a.rows[row_scalar(a, 0, b, c, hd) + t];
        sm.sn[t] = eg * a.rows[row_scalar(a, 1, b, c, hd) + t];
      } else {
        sm.sc[t] = t < rows ? expf(gl - gr + li_at(a, b, s0 + t, hd)) : 0.f;
      }
    }
    const size_t r0 = row_at(a, b, s0, hd);
    if (kReverse) {
      load_tile<T, kLdOf<T>, kPassThreads>(first(sm.a), static_cast<const T*>(a.q) + r0 + d0,
                                           ld, rows, a.dh - d0, a.vec);
      load_tile<float, kFLd, kPassThreads>(&sm.stdy[0][0], a.dy + r0 + e0, ld, rows,
                                           a.dh - e0, a.vec);
      load_tile<float, kFLd, kPassThreads>(
          &sm.u.cin[0][0], a.Cin + slot_at(a, c - 1, b, hd, dd2) + static_cast<size_t>(d0) * a.dh + e0,
          a.dh, a.dh - d0, a.dh - e0, a.vec);
    } else {
      load_tile<T, kLdOf<T>, kPassThreads>(&sm.u.stk[0][0], static_cast<const T*>(a.k) + r0 + d0,
                                           ld, rows, a.dh - d0, a.vec);
      load_tile<T, kLdOf<T>, kPassThreads>(first(sm.b), static_cast<const T*>(a.v) + r0 + e0,
                                           ld, rows, a.dh - e0, a.vec);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // the tiles, sc, sn
    if (kReverse) {  // this tile's part of <dC'_out, C'_in> of chunk c
      float acc = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          acc += h[nt][x] * sm.u.cin[16 * warp + gq + 8 * (x >> 1)][8 * nt + 2 * tq + (x & 1)];
      if (ncol) acc += hn * a.nin[slot_at(a, c - 1, b, hd, a.dh) + d0 + t];
      acc = warp_sum(acc);
      if (lane == 0) sm.red[warp] = acc;
      put_tile<kPassThreads>(sm.b, &sm.stdy[0][0], sm.sc);
    } else {
      put_tile<kPassThreads>(sm.a, &sm.u.stk[0][0], sm.sc);
    }
    __syncthreads();  // the operands; red
    if (kReverse && t == 0) {
      float tot = 0.f;
      for (int w = 0; w < kPassThreads / 32; ++w) tot += sm.red[w];
      a.stp[((static_cast<size_t>(b) * a.chunks + c) * a.nh + hd) * a.tiles * a.tiles +
            dt * a.tiles + et] = tot;
    }
    const float decay = expf(gl);  // h <- e^{gl} h, then the chunk's products
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) h[nt][x] *= decay;
    if (kReverse)
      mma_tile<8, true, true>(h, sm.a, 1, sm.b, np, 16 * warp, 0);
    else
      mma_tile<8, true, true>(h, sm.a, np, sm.b, 1, 16 * warp, 0);
    const int slot = kReverse ? c - 1 : c;
    float* dst = (kReverse ? a.dCo : a.Cin) + slot_at(a, slot, b, hd, dd2);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int d = d0 + 16 * warp + gq + 8 * (x >> 1), e = e0 + 8 * nt + 2 * tq + (x & 1);
        if (d < a.dh && e < a.dh) dst[static_cast<size_t>(d) * a.dh + e] = h[nt][x];
      }
    if (ncol) {  // n, one more column
      float pn = 0.f;
      for (int r = 0; r < kL; ++r)
        pn += kReverse ? sm.sn[r] * get(sm.a, r, t) : sm.sc[r] * to_float(sm.u.stk[r][t]);
      hn = hn * decay + pn;
      (kReverse ? a.dno : a.nin)[slot_at(a, slot, b, hd, a.dh) + d0 + t] = hn;
    }
  }
}

// ---- launch 2: q k^T, dy v^T, q . n_in, dy . y of one d tile ----
template <typename T>
struct RowsSmem {
  Opnd<T> q;   // [i][d], exact
  Opnd<T> k;   // [j][d], exact
  Opnd<T> v;   // [j][d], exact
  Opnd<T> dy;  // [i][d], split
  alignas(16) float st[2][kL][kFLd];  // dy, y rows staged
  float nin[kTile];
};

template <typename T>
__global__ void __launch_bounds__(kPassThreads) mlstm_bwd_rows_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char raw[];
  RowsSmem<T>& sm = *reinterpret_cast<RowsSmem<T>*>(raw);
  const int bid = blockIdx.x;
  const int dt = bid % a.tiles, hd = bid / a.tiles % a.nh;
  const int c = bid / (a.tiles * a.nh) % a.chunks, b = bid / (a.tiles * a.nh * a.chunks);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32, gq = lane / 4, tq = lane % 4;
  const int s0 = c * kL, rows = min(kL, a.S - s0), d0 = dt * kTile;
  const size_t ld = static_cast<size_t>(a.nh) * a.dh;
  const size_t r0 = row_at(a, b, s0, hd) + d0;
  load_tile<T, kLdOf<T>, kPassThreads>(first(sm.q), static_cast<const T*>(a.q) + r0, ld, rows,
                                       a.dh - d0, a.vec);
  load_tile<T, kLdOf<T>, kPassThreads>(first(sm.k), static_cast<const T*>(a.k) + r0, ld, rows,
                                       a.dh - d0, a.vec);
  load_tile<T, kLdOf<T>, kPassThreads>(first(sm.v), static_cast<const T*>(a.v) + r0, ld, rows,
                                       a.dh - d0, a.vec);
  load_tile<float, kFLd, kPassThreads>(&sm.st[0][0][0], a.dy + r0, ld, rows, a.dh - d0, a.vec);
  load_tile<float, kFLd, kPassThreads>(&sm.st[1][0][0], a.y + r0, ld, rows, a.dh - d0, a.vec);
  cp_async_commit();
  if (t < kTile)  // chunk 0's entering state is zero
    sm.nin[t] = (c > 0 && d0 + t < a.dh) ? a.nin[slot_at(a, c - 1, b, hd, a.dh) + d0 + t] : 0.f;
  cp_async_wait<0>();
  __syncthreads();
  put_tile<kPassThreads>(sm.dy, &sm.st[0][0][0], nullptr);
  __syncthreads();
  float s[8][4] = {}, dv[8][4] = {};
  mma_tile<8, false, false>(s, sm.q, 1, sm.k, 1, 16 * warp, 0);          // q_i . k_j
  mma_tile<8, false, false>(dv, sm.dy, parts(a), sm.v, 1, 16 * warp, 0);  // dy_i . v_j
  const size_t tile = ((static_cast<size_t>(b) * a.chunks + c) * a.nh + hd) * a.tiles + dt;
  float* P = a.part + tile * 2 * kL * kL;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int hx = 0; hx < 2; ++hx) {
      const int i = 16 * warp + gq + 8 * hx, j = 8 * nt + 2 * tq;
      *reinterpret_cast<float2*>(P + i * kL + j) = make_float2(s[nt][2 * hx], s[nt][2 * hx + 1]);
      *reinterpret_cast<float2*>(P + kL * kL + i * kL + j) =
          make_float2(dv[nt][2 * hx], dv[nt][2 * hx + 1]);
    }
  if (t < kL) {
    float acc = 0.f;
    for (int d = 0; d < kTile; ++d) acc += get(sm.q, t, d) * sm.nin[d];
    a.pv[tile * 2 * kL + t] = acc;
  } else if (t < 2 * kL) {
    const int i = t - kL;
    float acc = 0.f;
    for (int d = 0; d < kTile; ++d) acc += sm.st[0][i][d] * sm.st[1][i][d];
    a.pv[tile * 2 * kL + kL + i] = acc;
  }
}

// ---- launch 3: the rows of each (b, kernel chunk, head) ----
struct CombineSmem {
  float p[kL][kLd];  // w_ij (q_i . k_j)
  float a[kL][kLd];  // w_ij (q_i . k_j) D_ij
  float g[kL], li[kL], qn[kL], dyy[kL], rs[kL], dd[kL];
};

__global__ void __launch_bounds__(kRowsThreads) mlstm_bwd_combine_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char raw[];
  CombineSmem& sm = *reinterpret_cast<CombineSmem*>(raw);
  const int bid = blockIdx.x;
  const int hd = bid % a.nh, c = bid / a.nh % a.chunks, b = bid / (a.nh * a.chunks);
  const int t = threadIdx.x, r0 = t / 16, c0 = t % 16;
  const int s0 = c * kL, rows = min(kL, a.S - s0);
  const int tiles = (a.fault & kFaultRowsDropTile) ? a.tiles - 1 : a.tiles;
  const size_t tile0 = ((static_cast<size_t>(b) * a.chunks + c) * a.nh + hd) * a.tiles;
  if (t < kL) {
    sm.g[t] = t < rows ? g_at(a, b, s0 + t, hd) : 0.f;
    sm.li[t] = t < rows ? li_at(a, b, s0 + t, hd) : 0.f;
    float qn = 0.f;
    for (int tt = 0; tt < tiles; ++tt) qn += a.pv[(tile0 + tt) * 2 * kL + t];
    sm.qn[t] = qn;
  } else if (t < 2 * kL) {
    float dyy = 0.f;
    for (int tt = 0; tt < tiles; ++tt) dyy += a.pv[(tile0 + tt) * 2 * kL + t];
    sm.dyy[t - kL] = dyy;
  }
  float s[4][4] = {}, dv[4][4] = {};  // the d tiles' sums, in order
  for (int tt = 0; tt < tiles; ++tt) {
    const float* P = a.part + (tile0 + tt) * 2 * kL * kL;
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int i = r0 + 16 * x, j = c0 + 16 * y;
        s[x][y] += P[i * kL + j];
        dv[x][y] += P[kL * kL + i * kL + j];
      }
  }
  __syncthreads();  // g, li, qn, dyy
  float w[4][4];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int i = r0 + 16 * x, j = c0 + 16 * y;
      w[x][y] = (j <= i && i < rows) ? expf(sm.g[i] - sm.g[j] + sm.li[j]) : 0.f;
      sm.p[i][j] = w[x][y] * s[x][y];
    }
  __syncthreads();
  const size_t r1 = row_scalar(a, 0, b, c, hd);
  const size_t rstride = static_cast<size_t>(a.B) * a.chunks * a.nh * kL;
  if (t < kL) {  // den, 1 / m, dden
    float den = 0.f;
    for (int j = 0; j < kL; ++j) den += sm.p[t][j];
    den += (t < rows ? expf(sm.g[t]) : 0.f) * sm.qn[t];
    const float m = fmaxf(fabsf(den), 1.f);
    const float rs = 1.f / m;
    const float dd = fabsf(den) > 1.f ? -copysignf(1.f, den) * sm.dyy[t] / m : 0.f;
    sm.rs[t] = rs;
    sm.dd[t] = dd;
    a.rows[r1 + t] = rs;
    a.rows[r1 + rstride + t] = dd;
  }
  __syncthreads();
  float* W1 = a.W1 + ((static_cast<size_t>(b) * a.chunks + c) * a.nh + hd) * kL * kL;
  float* W2 = a.W2 + ((static_cast<size_t>(b) * a.chunks + c) * a.nh + hd) * kL * kL;
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int i = r0 + 16 * x, j = c0 + 16 * y;
      const float D = sm.rs[i] * dv[x][y] + sm.dd[i];
      W1[i * kL + j] = w[x][y] * D;
      W2[i * kL + j] = sm.p[i][j];
      sm.a[i][j] = w[x][y] * D * s[x][y];
    }
  __syncthreads();
  if (t < kL) {
    float ra = 0.f, ca = 0.f;
    for (int j = 0; j < kL; ++j) ra += sm.a[t][j];
    for (int i = 0; i < kL; ++i) ca += sm.a[i][t];
    a.rows[r1 + 2 * rstride + t] = ra - ca;
    a.rows[r1 + 3 * rstride + t] = ca;
  }
}

// ---- launch 5: dq, dk (64 columns of d) and dv (64 columns of e) ----
template <typename T>
struct OutLoop {  // the state product: a 64-wide slice of both operands
  alignas(16) float st[2][kL][kFLd];  // staged (an exact operand as T)
  Opnd<T> op[2];
};
template <typename T>
struct OutEpi {  // the intra-chunk product and the row sums
  Opnd<T> w;  // W1, or W2 with its rows scaled by 1 / m_i, split
  Opnd<T> x;  // dq: k [j][d]; dk: q [i][d]; dv: dy [i][e] split
  Opnd<T> y;  // dq: q [i][d]; dk: k [j][d]
};
template <typename T>
struct OutSmem {
  union {
    OutLoop<T> loop;
    OutEpi<T> epi;
  } u;
  float g[kL], eg[kL], ws[kL], rs[kL], dd[kL];
  float sv[kTile];  // dq: n_in of this d tile; dk: dn_out of it
  float red[2][kL];
};

// Block role (bid % 3): 0 dq, 1 dk, 2 dv.  Warp w holds rows 16 (w % 4)
// .. + 15 and columns 32 (w / 4) .. + 31 of the block's 64 x 64 output.
template <typename T, int role>
__device__ __forceinline__ void out_block(const Args& a, OutSmem<T>& sm) {
  const int bid = blockIdx.x;
  const int tt = bid / 3 % a.tiles, hd = bid / (3 * a.tiles) % a.nh;
  const int c = bid / (3 * a.tiles * a.nh) % a.chunks, b = bid / (3 * a.tiles * a.nh * a.chunks);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32, gq = lane / 4, tq = lane % 4;
  const int m0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
  const int s0 = c * kL, rows = min(kL, a.S - s0), c0 = tt * kTile, clim = a.dh - c0;
  const size_t ld = static_cast<size_t>(a.nh) * a.dh;
  const size_t dd2 = static_cast<size_t>(a.dh) * a.dh;
  const size_t r0 = row_at(a, b, s0, hd);
  const int np = parts(a);
  const int src = (a.fault & kFaultWrongCotangent) ? min(c + 1, a.chunks - 1) : c;
  const bool last = src == a.chunks - 1;  // its dC'_out is (dC, dn), read in place
  const float* dCo = last ? a.dC + slot_at(a, 0, b, hd, dd2) : a.dCo + slot_at(a, src, b, hd, dd2);
  const float* dno = last ? a.dn + slot_at(a, 0, b, hd, a.dh)
                          : a.dno + slot_at(a, src, b, hd, a.dh);
  const T* q = static_cast<const T*>(a.q) + r0;
  const T* k = static_cast<const T*>(a.k) + r0;
  const T* v = static_cast<const T*>(a.v) + r0;
  if (t < kL) {
    const float g = t < rows ? g_at(a, b, s0 + t, hd) : 0.f;
    const float gl = g_at(a, b, s0 + rows - 1, hd);
    const size_t r1 = row_scalar(a, 0, b, c, hd);
    const size_t rstride = static_cast<size_t>(a.B) * a.chunks * a.nh * kL;
    sm.g[t] = g;
    sm.eg[t] = t < rows ? expf(g) : 0.f;
    sm.ws[t] = t < rows ? expf(gl - g + li_at(a, b, s0 + t, hd)) : 0.f;
    sm.rs[t] = a.rows[r1 + t];
    sm.dd[t] = a.rows[r1 + rstride + t];
  } else if (t < kL + kTile) {
    const int d = t - kL;
    const bool ok = d < clim;
    sm.sv[d] = role == 0 ? (ok && c > 0 ? a.nin[slot_at(a, c - 1, b, hd, a.dh) + c0 + d] : 0.f)
                         : (ok ? dno[c0 + d] : 0.f);
  }

  // the state product over the 64-wide slices of e (dq, dk) or d (dv):
  // dq: sum_e dy_i[e] Cin[d][e]; dk: sum_e v_j[e] dCo[d][e]; dv: sum_d
  // k_j[d] dCo[d][e].  Chunk 0's dq has none (its C'_in is zero).
  const int nit = (role == 0 && c == 0) ? 0 : a.tiles;
  // slice it: the row operand (dy, v or k rows) and the state's (C_in's
  // rows of d, dC_out's rows of d, or its columns of e)
  const float* s1 = role == 0 ? a.Cin + slot_at(a, max(c - 1, 0), b, hd, dd2) : dCo;
  const size_t s1step = role == 2 ? static_cast<size_t>(kTile) * a.dh : kTile;
  s1 += role == 2 ? c0 : static_cast<size_t>(c0) * a.dh;
  const int s1rows = role == 2 ? kTile : clim, s1cols = role == 2 ? clim : kTile;
  float st[4][4] = {};
  if (nit > 0) {
    if (role == 0)
      load_tile<float, kFLd, kOutThreads>(&sm.u.loop.st[0][0][0], a.dy + r0, ld, rows, a.dh,
                                          a.vec);
    else
      load_tile<T, kLdOf<T>, kOutThreads>(reinterpret_cast<T*>(&sm.u.loop.st[0][0][0]),
                                          role == 1 ? v : k, ld, rows, a.dh, a.vec);
    load_tile<float, kFLd, kOutThreads>(&sm.u.loop.st[1][0][0], s1, a.dh,
                                        min(s1rows, a.dh), min(s1cols, a.dh), a.vec);
  }
  cp_async_commit();
  for (int it = 0; it < nit; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // slice it landed; slice it - 1 is done with op
    if (role == 0)
      put_tile<kOutThreads>(sm.u.loop.op[0], &sm.u.loop.st[0][0][0], nullptr);
    else
      put_tile<kOutThreads>(sm.u.loop.op[0],
                            reinterpret_cast<const T*>(&sm.u.loop.st[0][0][0]), nullptr);
    put_tile<kOutThreads>(sm.u.loop.op[1], &sm.u.loop.st[1][0][0], nullptr);
    __syncthreads();  // op; the staging is free
    if (it + 1 < nit) {  // slice it + 1 arrives while it is multiplied
      const int k0 = (it + 1) * kTile;
      if (role == 0)
        load_tile<float, kFLd, kOutThreads>(&sm.u.loop.st[0][0][0], a.dy + r0 + k0, ld, rows,
                                            a.dh - k0, a.vec);
      else
        load_tile<T, kLdOf<T>, kOutThreads>(reinterpret_cast<T*>(&sm.u.loop.st[0][0][0]),
                                            (role == 1 ? v : k) + k0, ld, rows, a.dh - k0,
                                            a.vec);
      load_tile<float, kFLd, kOutThreads>(&sm.u.loop.st[1][0][0], s1 + (it + 1) * s1step, a.dh,
                                          role == 2 ? a.dh - k0 : clim,
                                          role == 2 ? clim : a.dh - k0, a.vec);
    }
    cp_async_commit();
    if (role == 0)
      mma_tile<4, false, false>(st, sm.u.loop.op[0], np, sm.u.loop.op[1], np, m0, n0);
    else if (role == 1)
      mma_tile<4, false, false>(st, sm.u.loop.op[0], 1, sm.u.loop.op[1], np, m0, n0);
    else
      mma_tile<4, false, true>(st, sm.u.loop.op[0], 1, sm.u.loop.op[1], np, m0, n0);
  }
  __syncthreads();  // the loop's tiles are free; g, rs, sv

  // the intra-chunk product: dq: sum_j W1_ij k_j[d]; dk: sum_i W1_ij
  // q_i[d]; dv: sum_i W2_ij dnum_i[e]
  {
    const float* W = (role == 2 ? a.W2 : a.W1) +
                     ((static_cast<size_t>(b) * a.chunks + c) * a.nh + hd) * kL * kL;
    for (int i = t; i < kL * kL / 2; i += kOutThreads) {
      const int r = i / (kL / 2), cc = i % (kL / 2) * 2;
      const float2 wv = *reinterpret_cast<const float2*>(W + r * kL + cc);
      const float sc = role == 2 ? sm.rs[r] : 1.f;
      put2(sm.u.epi.w, r, cc, sc * wv.x, sc * wv.y);
    }
    if (role == 2) {
      for (int i = t; i < kL * kL / 2; i += kOutThreads) {
        const int r = i / (kL / 2), cc = i % (kL / 2) * 2;
        const float* p = a.dy + r0 + static_cast<size_t>(r) * ld + c0 + cc;
        put2(sm.u.epi.x, r, cc, r < rows && cc < clim ? p[0] : 0.f,
             r < rows && cc + 1 < clim ? p[1] : 0.f);
      }
    } else {
      load_tile<T, kLdOf<T>, kOutThreads>(first(sm.u.epi.x), (role == 0 ? k : q) + c0, ld, rows,
                                          clim, a.vec);
      load_tile<T, kLdOf<T>, kOutThreads>(first(sm.u.epi.y), (role == 0 ? q : k) + c0, ld, rows,
                                          clim, a.vec);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  float ia[4][4] = {};
  if (role == 0)
    mma_tile<4, false, true>(ia, sm.u.epi.w, np, sm.u.epi.x, 1, m0, n0);
  else if (role == 1)
    mma_tile<4, true, true>(ia, sm.u.epi.w, np, sm.u.epi.x, 1, m0, n0);
  else
    mma_tile<4, true, true>(ia, sm.u.epi.w, np, sm.u.epi.x, np, m0, n0);

  T* out = static_cast<T*>(role == 0 ? a.dq : role == 1 ? a.dk : a.dv) + r0 + c0;
  float rsum[2] = {0.f, 0.f};  // dq: q . cq; dk: k . (dk's state part)
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int hx = x >> 1, r = m0 + gq + 8 * hx, cc = n0 + 8 * nt + 2 * tq + (x & 1);
      float o;
      if (role == 0) {
        const float cq = sm.eg[r] * (sm.rs[r] * st[nt][x] + sm.sv[cc] * sm.dd[r]);
        o = ia[nt][x] + cq;
        rsum[hx] += get(sm.u.epi.y, r, cc) * cq;
      } else if (role == 1) {
        const float dks = sm.ws[r] * (st[nt][x] + sm.sv[cc]);
        o = ia[nt][x] + dks;
        rsum[hx] += get(sm.u.epi.y, r, cc) * dks;
      } else {
        o = ia[nt][x] + sm.ws[r] * st[nt][x];
      }
      if (r < rows && cc < clim) out[static_cast<size_t>(r) * ld + cc] = from_float<T>(o);
    }
  if (role < 2) {  // this d tile's part of dg and dli
#pragma unroll
    for (int hx = 0; hx < 2; ++hx) {
      const float v2 = quad_sum(rsum[hx]);
      if (tq == 0) sm.red[warp >> 2][m0 + gq + 8 * hx] = v2;
    }
    __syncthreads();
    if (t < kL)
      (role == 0 ? a.pq : a.pk)[(((static_cast<size_t>(b) * a.chunks + c) * a.tiles + tt) * kL +
                                 t) * a.nh + hd] = sm.red[0][t] + sm.red[1][t];
  }
}

template <typename T>
__global__ void __launch_bounds__(kOutThreads, 2) mlstm_bwd_out_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char raw[];
  OutSmem<T>& sm = *reinterpret_cast<OutSmem<T>*>(raw);
  switch (blockIdx.x % 3) {  // one role's code a branch
    case 0:
      out_block<T, 0>(a, sm);
      break;
    case 1:
      out_block<T, 1>(a, sm);
      break;
    default:
      out_block<T, 2>(a, sm);
  }
}

// ---- launch 6: dg, dli of one (b, kernel chunk, head), a thread a row:
// the tiles' parts summed in order ----
__global__ void __launch_bounds__(kL) mlstm_bwd_gates_kernel(const Args a) {
  __shared__ float sks[kL];
  __shared__ float sst;
  const int bid = blockIdx.x;
  const int hd = bid % a.nh, c = bid / a.nh % a.chunks, b = bid / (a.nh * a.chunks);
  const int r = threadIdx.x, rows = min(kL, a.S - c * kL);
  const int tiles = (a.fault & kFaultDropTile) ? a.tiles - 1 : a.tiles;
  // part (tt, row) of this (b, c, hd) at base + (tt kL + row) nh
  const size_t base = (static_cast<size_t>(b) * a.chunks + c) * a.tiles * kL * a.nh + hd;
  const size_t r1 = row_scalar(a, 0, b, c, hd) + r;
  const size_t rstride = static_cast<size_t>(a.B) * a.chunks * a.nh * kL;
  float sq = 0.f, sk = 0.f;
  for (int tt = 0; tt < tiles; ++tt) {
    sq += a.pq[base + (static_cast<size_t>(tt) * kL + r) * a.nh];
    sk += a.pk[base + (static_cast<size_t>(tt) * kL + r) * a.nh];
  }
  sks[r] = r < rows ? sk : 0.f;
  if (r == 0) {  // <dC'_out, C'_in> (chunk 0's C'_in is zero)
    float st = 0.f;
    if (c > 0) {
      const int n = a.tiles * a.tiles - ((a.fault & kFaultStateDropTile) ? 1 : 0);
      const float* p = a.stp + ((static_cast<size_t>(b) * a.chunks + c) * a.nh + hd) * a.tiles *
                                   a.tiles;
      for (int u = 0; u < n; ++u) st += p[u];
    }
    sst = st;
  }
  __syncthreads();
  float dg = a.rows[r1 + 2 * rstride] + sq - sk;
  if (r == rows - 1) {  // the state terms
    float kss = 0.f;
    for (int j = 0; j < rows; ++j) kss += sks[j];
    dg += expf(g_at(a, b, c * kL + r, hd)) * sst + kss;
  }
  a.dg[((static_cast<size_t>(b) * a.chunks + c) * kL + r) * a.nh + hd] = r < rows ? dg : 0.f;
  if (r < rows)
    a.dli[(static_cast<size_t>(b) * a.S + c * kL + r) * a.nh + hd] =
        a.rows[r1 + 3 * rstride] + sk;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int launch(const Args& a, const float* cumf, float* dcumf, int Q, cudaStream_t stream) {
  static const cudaError_t attr = [] {  // once
    cudaError_t e = allow_smem(mlstm_bwd_pass_kernel<T, false>, sizeof(PassSmem<T>));
    if (e == cudaSuccess) e = allow_smem(mlstm_bwd_pass_kernel<T, true>, sizeof(PassSmem<T>));
    if (e == cudaSuccess) e = allow_smem(mlstm_bwd_rows_kernel<T>, sizeof(RowsSmem<T>));
    if (e == cudaSuccess) e = allow_smem(mlstm_bwd_out_kernel<T>, sizeof(OutSmem<T>));
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int pass_blocks = a.B * a.nh * a.tiles * a.tiles;
  const size_t gsize = static_cast<size_t>(a.B) * a.chunks * kL * a.nh;
  scan::bwd::rebase_kernel<<<static_cast<unsigned>((gsize + 255) / 256), 256, 0, stream>>>(
      cumf, const_cast<float*>(a.g), a.B, a.S, Q, a.nh, a.chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.chunks > 1) {
    mlstm_bwd_pass_kernel<T, false><<<pass_blocks, kPassThreads, sizeof(PassSmem<T>), stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mlstm_bwd_rows_kernel<T><<<a.B * a.chunks * a.nh * a.tiles, kPassThreads, sizeof(RowsSmem<T>),
                             stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_bwd_combine_kernel<<<a.B * a.chunks * a.nh, kRowsThreads, sizeof(CombineSmem), stream>>>(
      a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.chunks > 1) {
    mlstm_bwd_pass_kernel<T, true><<<pass_blocks, kPassThreads, sizeof(PassSmem<T>), stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mlstm_bwd_out_kernel<T><<<a.B * a.chunks * a.nh * a.tiles * 3, kOutThreads, sizeof(OutSmem<T>),
                            stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_bwd_gates_kernel<<<a.B * a.chunks * a.nh, kL, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t rows = static_cast<size_t>(a.B) * a.S * a.nh;
  scan::bwd::rebase_adjoint_kernel<<<static_cast<unsigned>((rows + 255) / 256), 256, 0,
                                     stream>>>(a.dg, dcumf, a.B, a.S, Q, a.nh, a.chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cumf [B, S, nh] is the caller's forget-gate log cumsum (restarted every
// Q rows), dcumf its gradient; scratch (the wrapper's torch.empty; nothing
// is allocated here): g and dg [B, chunks * 64, nh] (cumf rebased per
// kernel chunk, and its gradient), Cin, dCo
// [chunks - 1, B, nh, dh, dh], nin, dno [chunks - 1, B, nh, dh], part [B,
// chunks, nh, tiles, 2, 64, 64], pv [B, chunks, nh, tiles, 2, 64], W1, W2
// [B, chunks, nh, 64, 64], rows [4, B, chunks, nh, 64], stp [B, chunks, nh,
// tiles^2], pq, pk [B, chunks, tiles, 64, nh] fp32.  `chunks` must be
// ceil(S / 64), `tiles` ceil(dh / 64); `vec`
// says every row of q, k, v, y, dy, dC and the scratch states starts 16
// bytes aligned and dh fills whole 16-byte pieces (else plain loads).
extern "C" int mlstm_chunk_scan_backward_launch(
    const void* q, const void* k, const void* v, const void* cumf, const void* li,
    const void* y, const void* dy, const void* dC, const void* dn, void* g, void* Cin,
    void* nin, void* dCo, void* dno, void* part, void* pv, void* W1, void* W2, void* rows,
    void* stp, void* pq, void* pk, void* dq, void* dk, void* dv, void* dg, void* dcumf,
    void* dli, int B, int S, int Q, int nh, int dh, int chunks, int tiles, int dtype, int vec,
    int fault, void* stream) {
  if (S < 1 || B < 1 || Q < 1 || S % Q || nh < 1 || dh < 1 || dh > 8 * kTile ||
      chunks != (S + kL - 1) / kL || tiles != (dh + kTile - 1) / kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, static_cast<const float*>(g), static_cast<const float*>(li),
               static_cast<const float*>(y), static_cast<const float*>(dy),
               static_cast<const float*>(dC), static_cast<const float*>(dn),
               static_cast<float*>(Cin), static_cast<float*>(nin),
               static_cast<float*>(dCo), static_cast<float*>(dno),
               static_cast<float*>(part), static_cast<float*>(pv),
               static_cast<float*>(W1), static_cast<float*>(W2),
               static_cast<float*>(rows), static_cast<float*>(stp),
               static_cast<float*>(pq), static_cast<float*>(pk), dq, dk, dv,
               static_cast<float*>(dg), static_cast<float*>(dli), B, S, nh, dh, chunks, tiles,
               vec, fault};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cf = static_cast<const float*>(cumf);
  float* dcf = static_cast<float*>(dcumf);
  if (dtype == kFloat32) return launch<float>(a, cf, dcf, Q, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(a, cf, dcf, Q, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
