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
//            dk_j), and at the last row <dC'_out, C'_out>;
//   dli_j  = the column sums + k_j . (the state part of dk_j).
//
// The port's own: the TPU kernel repro/kernels/mlstm.py:mlstm_chunk_scan
// has no backward, and the reference differentiates repro/models/
// xlstm.py's pure-JAX scan with jax.grad.  The forward keeps its schema
// and saves only y, so the backward recomputes the state entering each
// kernel chunk and the normaliser.
//
// What bounds it on the H100: operations, in fp32 on the CUDA cores (at
// xlstm-350m's dh = 512 the products with the [dh, dh] states, about 4 L
// dh^2 multiply-adds a (b, kernel chunk, head), against one read of the
// inputs and one write of the gradients).  Five launches:
//  1. mlstm_bwd_pass_kernel, forward: one block per (b, head, 64 x 64 tile
//     of C) walks the kernel chunks in order and writes the state entering
//     each (Cin, and n in the e-tile 0 blocks).
//  2. mlstm_bwd_rows_kernel, one block per (b, kernel chunk, head): the
//     scores q k^T, den, 1 / m, dden, and the weighted matrices
//     w (dnum' . v') and w (q . k) with dg's intra-chunk row and column
//     sums, to scratch.
//  3. mlstm_bwd_pass_kernel, reverse: the same blocks walk the kernel
//     chunks backwards from (dC, dn) and write the cotangent of the state
//     leaving each (dCo, dno).
//  4. mlstm_bwd_out_kernel, one block per (b, kernel chunk, head, 64
//     columns of d): dq, dk and dv for those columns, the [dh, dh] states
//     streamed 64 x 64 at a time, and its part of dg and dli.
//  5. mlstm_bwd_gates_kernel sums the column tiles' parts of dg and dli in
//     order.
// No atomics: two runs give identical bits.
#include "scan.cuh"

namespace {

using scan::kL;
using scan::kLd;
using scan::mm;
using scan::row_sum16;
constexpr int kThreads = scan::kTileThreads;

constexpr int kTile = 64;      // rows of d and columns of e a tile holds
constexpr int kTileF = kL * kLd;

// planted faults (kernels/mlstm.py FAULT_*), for the checks only
constexpr int kFaultWrongCotangent = 1;  // chunk c reads dC'_out of c + 1
constexpr int kFaultDropTile = 2;        // dg's sum drops the last d tile

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
  float* Cin;  // [chunks][B][nh][dh][dh]: the state entering each chunk
  float* nin;  // [chunks][B][nh][dh]
  float* dCo;  // [chunks][B][nh][dh][dh]: the cotangent leaving each chunk
  float* dno;  // [chunks][B][nh][dh]
  float* W1;   // [B][chunks][nh][kL][kL]: w_ij D_ij
  float* W2;   // [B][chunks][nh][kL][kL]: w_ij (q_i . k_j)
  float* rows;  // [4][B][chunks][nh][kL]: 1 / m, dden, rowA - colA, colA
  float* pg;   // [B][chunks][tiles][kL][nh]: dg's part of each d tile
  float* pli;  // [B][chunks][tiles][kL][nh]
  void* dq;
  void* dk;
  void* dv;
  float* dg;
  float* dli;
  int B, S, nh, dh, chunks, tiles, fault;
};

__device__ __forceinline__ float g_at(const Args& a, int b, int t, int hd) {
  return a.g[(static_cast<size_t>(b) * a.chunks * kL + t) * a.nh + hd];
}

__device__ __forceinline__ float li_at(const Args& a, int b, int t, int hd) {
  return a.li[(static_cast<size_t>(b) * a.S + t) * a.nh + hd];
}

// row r of the chunk starting at s0 of a [B, S, nh, dh] tensor, head hd
__device__ __forceinline__ size_t row_at(const Args& a, int b, int s0, int r, int hd) {
  return ((static_cast<size_t>(b) * a.S + s0 + r) * a.nh + hd) * a.dh;
}

__device__ __forceinline__ size_t row_scalar(const Args& a, int which, int b, int c,
                                             int hd) {
  return (((static_cast<size_t>(which) * a.B + b) * a.chunks + c) * a.nh + hd) * kL;
}

// dst[r][cc] = scale_r * src(row r, column col0 + cc) of a [B, S, nh, dh]
// tensor for r < rows, col0 + cc < dh, else 0 (scale may be null).
template <typename T>
__device__ __forceinline__ void load_rows(const Args& a, float* dst, const T* src, int b,
                                          int s0, int rows, int hd, int col0,
                                          const float* scale) {
  for (int i = threadIdx.x; i < kL * kTile; i += kThreads) {
    const int r = i / kTile, cc = i % kTile;
    const bool ok = r < rows && col0 + cc < a.dh;
    const float s = scale ? scale[r] : 1.f;
    dst[r * kLd + cc] = ok ? s * to_float(src[row_at(a, b, s0, r, hd) + col0 + cc]) : 0.f;
  }
}

// dst[d][e] = state(d0 + d, e0 + e) of one [dh, dh] state, 0 outside it.
__device__ __forceinline__ void load_state(const Args& a, float* dst, const float* st,
                                           int d0, int e0) {
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int d = i / kTile, e = i % kTile;
    const bool ok = d0 + d < a.dh && e0 + e < a.dh;
    dst[d * kLd + e] = ok ? st[static_cast<size_t>(d0 + d) * a.dh + e0 + e] : 0.f;
  }
}

// ---- launches 1 and 3: the ordered passes over the kernel chunks ----
// Forward: C(d, e) <- e^{gl} C + sum_j (w^s_j k_j[d]) v_j[e], n likewise
// against a column of ones, from zero, the state entering each chunk
// stored.  Reverse: dC <- e^{gl} dC + sum_i (e^{g_i} q_i[d]) dnum_i[e], dn
// against the column dden, from (dC, dn), the cotangent leaving each chunk
// stored.  One block per (b, head, d tile, e tile).
template <typename T, bool kReverse>
__global__ void __launch_bounds__(kThreads) mlstm_bwd_pass_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char raw[];
  float* U = reinterpret_cast<float*>(raw);  // [j][d], weighted
  float* V = U + kTileF;                     // [j][e]
  float* ncol = V + kTileF;                  // [j]
  float* scale = ncol + kL;                  // [j]
  const int bid = blockIdx.x;
  const int et = bid % a.tiles, dt = bid / a.tiles % a.tiles;
  const int hd = bid / (a.tiles * a.tiles) % a.nh, b = bid / (a.tiles * a.tiles * a.nh);
  const int t = threadIdx.x, r0 = t / 16, c0 = t % 16;
  const int d0 = dt * kTile, e0 = et * kTile;
  const size_t head = static_cast<size_t>(b) * a.nh + hd;
  const size_t stride = static_cast<size_t>(a.B) * a.nh;
  float* Cout = kReverse ? a.dCo : a.Cin;
  float* nout = kReverse ? a.dno : a.nin;
  float h[4][4], hn[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int d = d0 + r0 + 16 * x;
    hn[x] = (kReverse && d < a.dh) ? a.dn[head * a.dh + d] : 0.f;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int e = e0 + c0 + 16 * y;
      h[x][y] = (kReverse && d < a.dh && e < a.dh)
                    ? a.dC[(head * a.dh + d) * a.dh + e]
                    : 0.f;
    }
  }
  for (int s = 0; s < a.chunks; ++s) {
    const int c = kReverse ? a.chunks - 1 - s : s;
    const int s0 = c * kL, rows = min(kL, a.S - s0);
    const float gl = g_at(a, b, s0 + rows - 1, hd);
    __syncthreads();  // the chunk before is done with U, V
    if (t < kL) {
      const float gr = g_at(a, b, s0 + t, hd);
      if (kReverse) {
        scale[t] = t < rows ? expf(gr) : 0.f;
        ncol[t] = a.rows[row_scalar(a, 1, b, c, hd) + t];  // dden
      } else {
        scale[t] = t < rows ? expf(gl - gr + li_at(a, b, s0 + t, hd)) : 0.f;
        ncol[t] = 1.f;
      }
    }
    __syncthreads();
    if (kReverse) {
      load_rows(a, U, static_cast<const T*>(a.q), b, s0, rows, hd, d0, scale);
      load_rows(a, V, a.dy, b, s0, rows, hd, e0, a.rows + row_scalar(a, 0, b, c, hd));
    } else {
      load_rows(a, U, static_cast<const T*>(a.k), b, s0, rows, hd, d0, scale);
      load_rows(a, V, static_cast<const T*>(a.v), b, s0, rows, hd, e0, nullptr);
    }
    __syncthreads();
    float* dst = Cout + (static_cast<size_t>(c) * stride + head) * a.dh * a.dh;
    float part[4][4] = {};
    mm<true, false>(part, U, V, rows);
    const float decay = expf(gl);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int d = d0 + r0 + 16 * x;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int e = e0 + c0 + 16 * y;
        if (d < a.dh && e < a.dh) dst[static_cast<size_t>(d) * a.dh + e] = h[x][y];
        h[x][y] = h[x][y] * decay + part[x][y];
      }
    }
    if (et == 0 && c0 == 0) {  // n, one more column
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int d = d0 + r0 + 16 * x;
        float pn = 0.f;
        for (int r = 0; r < rows; ++r) pn += U[r * kLd + r0 + 16 * x] * ncol[r];
        if (d < a.dh) nout[(static_cast<size_t>(c) * stride + head) * a.dh + d] = hn[x];
        hn[x] = hn[x] * decay + pn;
      }
    }
  }
}

constexpr size_t kPassSmem = sizeof(float) * (2 * kTileF + 2 * kL);

// ---- launch 2: the rows of each (b, kernel chunk, head) ----
struct RowsSmem {
  float q[kL][kLd];
  float k[kL][kLd];
  float dy[kL][kLd];
  float v[kL][kLd];
  float y[kL][kLd];
  float p[kL][kLd];  // w_ij (q_i . k_j)
  float a[kL][kLd];  // w_ij (q_i . k_j) D_ij
  float g[kL], li[kL], qn[kL], dyy[kL], rs[kL], dd[kL], nin[kTile];
};

template <typename T>
__global__ void __launch_bounds__(kThreads) mlstm_bwd_rows_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char raw[];
  RowsSmem& sm = *reinterpret_cast<RowsSmem*>(raw);
  const int bid = blockIdx.x;
  const int hd = bid % a.nh, c = bid / a.nh % a.chunks, b = bid / (a.nh * a.chunks);
  const int t = threadIdx.x, r0 = t / 16, c0 = t % 16;
  const int s0 = c * kL, rows = min(kL, a.S - s0);
  const size_t head = static_cast<size_t>(b) * a.nh + hd;
  const float* nin = a.nin + (static_cast<size_t>(c) * a.B * a.nh + head) * a.dh;
  if (t < kL) {
    sm.g[t] = t < rows ? g_at(a, b, s0 + t, hd) : 0.f;
    sm.li[t] = t < rows ? li_at(a, b, s0 + t, hd) : 0.f;
    sm.qn[t] = 0.f;
    sm.dyy[t] = 0.f;
  }
  float s[4][4] = {}, dv[4][4] = {};
  for (int dt = 0; dt < a.tiles; ++dt) {
    const int d0 = dt * kTile;
    __syncthreads();  // the tile before is done
    load_rows(a, &sm.q[0][0], static_cast<const T*>(a.q), b, s0, rows, hd, d0, nullptr);
    load_rows(a, &sm.k[0][0], static_cast<const T*>(a.k), b, s0, rows, hd, d0, nullptr);
    load_rows(a, &sm.v[0][0], static_cast<const T*>(a.v), b, s0, rows, hd, d0, nullptr);
    load_rows(a, &sm.dy[0][0], a.dy, b, s0, rows, hd, d0, nullptr);
    load_rows(a, &sm.y[0][0], a.y, b, s0, rows, hd, d0, nullptr);
    if (t < kTile) sm.nin[t] = d0 + t < a.dh ? nin[d0 + t] : 0.f;
    __syncthreads();
    mm<false, true>(s, &sm.q[0][0], &sm.k[0][0], kTile);    // q_i . k_j
    mm<false, true>(dv, &sm.dy[0][0], &sm.v[0][0], kTile);  // dy_i . v_j
    if (t < kL) {
      float acc = 0.f;
      for (int d = 0; d < kTile; ++d) acc += sm.q[t][d] * sm.nin[d];
      sm.qn[t] += acc;
    } else if (t < 2 * kL) {
      const int i = t - kL;
      float acc = 0.f;
      for (int d = 0; d < kTile; ++d) acc += sm.dy[i][d] * sm.y[i][d];
      sm.dyy[i] += acc;
    }
  }
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

// ---- launch 4: dq, dk, dv for 64 columns of d ----
struct OutSmem {
  float w1[kL][kLd];
  float w2[kL][kLd];
  float k[kL][kLd];    // k_j, this tile's columns (then dnum_i's)
  float q[kL][kLd];    // q_i, this tile's columns
  float ci[kTile][kLd];  // Cin [this tile's d][e], then k_j [j][d]
  float dn[kL][kLd];     // dnum_i [i][e]
  float dco[kTile][kLd];  // dCo [this tile's d][e], then [d][this tile's e]
  float vs[kL][kLd];     // v_j [j][e]
  float g[kL], eg[kL], ws[kL], rs[kL], dd[kL], ra[kL], ca[kL];
  float nin[kTile], dno[kTile], car[kL], ks[kL];
  float red[kThreads / 32];
};

template <typename T>
__global__ void __launch_bounds__(kThreads) mlstm_bwd_out_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char raw[];
  OutSmem& sm = *reinterpret_cast<OutSmem*>(raw);
  const int bid = blockIdx.x;
  const int tt = bid % a.tiles, hd = bid / a.tiles % a.nh;
  const int c = bid / (a.tiles * a.nh) % a.chunks, b = bid / (a.tiles * a.nh * a.chunks);
  const int t = threadIdx.x, r0 = t / 16, c0 = t % 16;
  const int s0 = c * kL, rows = min(kL, a.S - s0), d0 = tt * kTile;
  const size_t head = static_cast<size_t>(b) * a.nh + hd;
  const size_t stride = static_cast<size_t>(a.B) * a.nh;
  const int src = (a.fault & kFaultWrongCotangent) ? min(c + 1, a.chunks - 1) : c;
  const float* Cin = a.Cin + (static_cast<size_t>(c) * stride + head) * a.dh * a.dh;
  const float* dCo = a.dCo + (static_cast<size_t>(src) * stride + head) * a.dh * a.dh;
  const size_t r1 = row_scalar(a, 0, b, c, hd);
  const size_t rstride = static_cast<size_t>(a.B) * a.chunks * a.nh * kL;
  const float* W1 = a.W1 + ((static_cast<size_t>(b) * a.chunks + c) * a.nh + hd) * kL * kL;
  const float* W2 = a.W2 + ((static_cast<size_t>(b) * a.chunks + c) * a.nh + hd) * kL * kL;
  for (int i = t; i < kL * kL; i += kThreads) {
    sm.w1[i / kL][i % kL] = W1[i];
    sm.w2[i / kL][i % kL] = W2[i];
  }
  if (t < kL) {
    const float g = t < rows ? g_at(a, b, s0 + t, hd) : 0.f;
    const float gl = g_at(a, b, s0 + rows - 1, hd);
    sm.g[t] = g;
    sm.eg[t] = t < rows ? expf(g) : 0.f;
    sm.ws[t] = t < rows ? expf(gl - g + li_at(a, b, s0 + t, hd)) : 0.f;
    sm.rs[t] = a.rows[r1 + t];
    sm.dd[t] = a.rows[r1 + rstride + t];
    sm.ra[t] = a.rows[r1 + 2 * rstride + t];
    sm.ca[t] = a.rows[r1 + 3 * rstride + t];
  } else if (t < kL + kTile) {
    const int d = t - kL;
    const bool ok = d0 + d < a.dh;
    sm.nin[d] = ok ? a.nin[(static_cast<size_t>(c) * stride + head) * a.dh + d0 + d] : 0.f;
    sm.dno[d] = ok ? a.dno[(static_cast<size_t>(src) * stride + head) * a.dh + d0 + d] : 0.f;
  }
  load_rows(a, &sm.k[0][0], static_cast<const T*>(a.k), b, s0, rows, hd, d0, nullptr);
  load_rows(a, &sm.q[0][0], static_cast<const T*>(a.q), b, s0, rows, hd, d0, nullptr);
  __syncthreads();
  const float gl = sm.g[rows - 1];

  // dq (rows i) and dk (rows j) for this tile's columns d: first the
  // products with a state over the e tiles, then the intra-chunk ones, one
  // output at a time (fewer accumulators live at once)
  float qc[4][4] = {}, kst[4][4] = {};
  float stp = 0.f;
  for (int s = 0; s < a.tiles; ++s) {
    const int e0 = s * kTile;
    __syncthreads();  // the tile before is done
    load_state(a, &sm.ci[0][0], Cin, d0, e0);
    load_state(a, &sm.dco[0][0], dCo, d0, e0);
    load_rows(a, &sm.dn[0][0], a.dy, b, s0, rows, hd, e0, sm.rs);
    load_rows(a, &sm.vs[0][0], static_cast<const T*>(a.v), b, s0, rows, hd, e0, nullptr);
    __syncthreads();
    mm<false, true>(qc, &sm.dn[0][0], &sm.ci[0][0], kTile);    // sum_e dnum_i[e] Cin[d][e]
    mm<false, true>(kst, &sm.vs[0][0], &sm.dco[0][0], kTile);  // sum_e v_j[e] dCo[d][e]
    for (int i = t; i < kTile * kTile; i += kThreads)
      stp += sm.ci[i / kTile][i % kTile] * sm.dco[i / kTile][i % kTile];
  }
  if (t < kTile) stp += sm.dno[t] * sm.nin[t];
  {
    float aq[4][4] = {};
    mm<false, false>(aq, &sm.w1[0][0], &sm.k[0][0], rows);  // sum_j W1_ij k_j[d]
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = r0 + 16 * x;
      float car = 0.f;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int d = c0 + 16 * y;
        const float cq = sm.eg[i] * (qc[x][y] + sm.nin[d] * sm.dd[i]);
        car += sm.q[i][d] * cq;
        if (i < rows && d0 + d < a.dh)
          static_cast<T*>(a.dq)[row_at(a, b, s0, i, hd) + d0 + d] =
              from_float<T>(aq[x][y] + cq);
      }
      car = row_sum16(car);
      if (c0 == 0) sm.car[i] = car;
    }
  }
  {
    float ak[4][4] = {};
    mm<true, false>(ak, &sm.w1[0][0], &sm.q[0][0], rows);   // sum_i W1_ij q_i[d]
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = r0 + 16 * x;
      float ks = 0.f;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int d = c0 + 16 * y;
        const float dks = sm.ws[i] * (kst[x][y] + sm.dno[d]);
        ks += sm.k[i][d] * dks;
        if (i < rows && d0 + d < a.dh)
          static_cast<T*>(a.dk)[row_at(a, b, s0, i, hd) + d0 + d] =
              from_float<T>(ak[x][y] + dks);
      }
      ks = row_sum16(ks);
      if (c0 == 0) sm.ks[i] = ks;
    }
  }
  stp = warp_sum(stp);
  if (t % 32 == 0) sm.red[t / 32] = stp;
  __syncthreads();  // car, ks, red; k's tile is free

  // dv (rows j) for this tile's columns e = d0 + ...
  load_rows(a, &sm.k[0][0], a.dy, b, s0, rows, hd, d0, sm.rs);  // dnum_i, these e
  float av[4][4] = {}, vst[4][4] = {};
  for (int s = 0; s < a.tiles; ++s) {
    const int e0 = s * kTile;  // here the rows of d
    __syncthreads();
    load_rows(a, &sm.ci[0][0], static_cast<const T*>(a.k), b, s0, rows, hd, e0, nullptr);
    load_state(a, &sm.dco[0][0], dCo, e0, d0);
    __syncthreads();
    mm<false, false>(vst, &sm.ci[0][0], &sm.dco[0][0], kTile);  // sum_d k_j[d] dCo[d][e]
    if (s == 0) mm<true, false>(av, &sm.w2[0][0], &sm.k[0][0], rows);  // sum_i W2_ij dnum_i[e]
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int j = r0 + 16 * x;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int e = c0 + 16 * y;
      if (j < rows && d0 + e < a.dh)
        static_cast<T*>(a.dv)[row_at(a, b, s0, j, hd) + d0 + e] =
            from_float<T>(av[x][y] + sm.ws[j] * vst[x][y]);
    }
  }
  if (t < kL) {  // this tile's part of dg and dli
    float pg = sm.car[t] - sm.ks[t], pl = sm.ks[t];
    if (tt == 0) {
      pg += sm.ra[t];
      pl += sm.ca[t];
    }
    if (t == rows - 1) {
      float st = 0.f, kss = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) st += sm.red[w];
      for (int j = 0; j < rows; ++j) kss += sm.ks[j];
      pg += expf(gl) * st + kss;
    }
    const size_t at =
        (((static_cast<size_t>(b) * a.chunks + c) * a.tiles + tt) * kL + t) * a.nh + hd;
    a.pg[at] = t < rows ? pg : 0.f;
    a.pli[at] = t < rows ? pl : 0.f;
  }
}

// ---- launch 5: dg, dli, the tiles' parts summed in order ----
__global__ void __launch_bounds__(kThreads) mlstm_bwd_gates_kernel(const Args a) {
  const size_t total = static_cast<size_t>(a.B) * a.chunks * kL * a.nh;
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int hd = i % a.nh;
  const size_t bcr = i / a.nh;
  const int r = bcr % kL, c = bcr / kL % a.chunks, b = bcr / (static_cast<size_t>(kL) * a.chunks);
  const int tiles = (a.fault & kFaultDropTile) ? a.tiles - 1 : a.tiles;
  float sg = 0.f, sl = 0.f;
  for (int tt = 0; tt < tiles; ++tt) {
    const size_t at =
        (((static_cast<size_t>(b) * a.chunks + c) * a.tiles + tt) * kL + r) * a.nh + hd;
    sg += a.pg[at];
    sl += a.pli[at];
  }
  a.dg[i] = sg;
  const int row = c * kL + r;
  if (row < a.S) a.dli[(static_cast<size_t>(b) * a.S + row) * a.nh + hd] = sl;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  static const cudaError_t attr = [] {  // once
    cudaError_t e = allow_smem(mlstm_bwd_rows_kernel<T>, sizeof(RowsSmem));
    if (e == cudaSuccess) e = allow_smem(mlstm_bwd_out_kernel<T>, sizeof(OutSmem));
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int pass_blocks = a.B * a.nh * a.tiles * a.tiles;
  mlstm_bwd_pass_kernel<T, false><<<pass_blocks, kThreads, kPassSmem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_bwd_rows_kernel<T><<<a.B * a.chunks * a.nh, kThreads, sizeof(RowsSmem), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_bwd_pass_kernel<T, true><<<pass_blocks, kThreads, kPassSmem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_bwd_out_kernel<T><<<a.B * a.chunks * a.nh * a.tiles, kThreads, sizeof(OutSmem),
                            stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(a.B) * a.chunks * kL * a.nh;
  mlstm_bwd_gates_kernel<<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads,
                           0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch: Cin, dCo [chunks, B, nh, dh, dh], nin, dno [chunks, B, nh, dh],
// W1, W2 [B, chunks, nh, 64, 64], rows [4, B, chunks, nh, 64], pg, pli [B,
// chunks, tiles, 64, nh] fp32 (the wrapper's torch.empty; nothing is
// allocated here); g and dg [B, chunks * 64, nh].  `chunks` must be
// ceil(S / 64), `tiles` ceil(dh / 64).
extern "C" int mlstm_chunk_scan_backward_launch(
    const void* q, const void* k, const void* v, const void* g, const void* li,
    const void* y, const void* dy, const void* dC, const void* dn, void* Cin, void* nin,
    void* dCo, void* dno, void* W1, void* W2, void* rows, void* pg, void* pli, void* dq,
    void* dk, void* dv, void* dg, void* dli, int B, int S, int nh, int dh, int chunks,
    int tiles, int dtype, int fault, void* stream) {
  if (S < 1 || B < 1 || nh < 1 || dh < 1 || dh > 8 * kTile ||
      chunks != (S + kL - 1) / kL || tiles != (dh + kTile - 1) / kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, static_cast<const float*>(g), static_cast<const float*>(li),
               static_cast<const float*>(y), static_cast<const float*>(dy),
               static_cast<const float*>(dC), static_cast<const float*>(dn),
               static_cast<float*>(Cin), static_cast<float*>(nin),
               static_cast<float*>(dCo), static_cast<float*>(dno),
               static_cast<float*>(W1), static_cast<float*>(W2),
               static_cast<float*>(rows), static_cast<float*>(pg),
               static_cast<float*>(pli), dq, dk, dv, static_cast<float*>(dg),
               static_cast<float*>(dli), B, S, nh, dh, chunks, tiles, fault};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(a, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
