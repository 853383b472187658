// Gradient of the Mamba2 SSD chunk scan (mamba_scan.cu).
//
//   xbar, dy [B, S, nh, P] fp32; Bm, Cm [B, S, N] (fp32 or bf16); g [B,
//   chunks * kL, nh] fp32, the log-decay cumsum rebased per kernel chunk of
//   kL rows (0 past S; kernels/mamba_scan.py:rebase); dstate [B, nh, P, N]
//   fp32, the cotangent of the final state.  Out: dx [B, S, nh, P] fp32,
//   dB, dC [B, S, N] in Bm's dtype, dg [B, chunks * kL, nh] fp32 (the
//   wrapper maps dg back through rebase's adjoint to dcum).  Per kernel
//   chunk, with gl the g of its last row, h_in the state entering it and
//   dh_out the cotangent of the state leaving it:
//     dh_in = e^{gl} dh_out + sum_i e^{g_i} dy_i C_i^T
//     dx_j  = sum_{i>=j} (C_i . B_j) e^{g_i - g_j} dy_i + e^{gl - g_j} dh_out B_j
//     dB_j  = sum_h [sum_{i>=j} e^{g_i - g_j} (dy_i . x_j) C_i + e^{gl - g_j} x_j^T dh_out]
//     dC_i  = sum_h [sum_{j<=i} e^{g_i - g_j} (dy_i . x_j) B_j + e^{g_i} dy_i^T h_in]
//     dg    = row sums - column sums of e^{g_i - g_j} (C_i . B_j)(dy_i . x_j),
//             + dy_i . y_off_i, - x_j . (the state part of dx_j), and at the
//             last row e^{gl} <dh_out, h_in> + the sum of x_j . (the state
//             part of dx_j).
//
// The port's own: the TPU kernel repro/kernels/mamba_scan.py:
// mamba_chunk_scan_chunked has no backward, and the reference
// differentiates repro/models/ssm.py's pure-JAX scan with jax.grad.  The
// forward keeps its schema and saves nothing, so the backward recomputes
// the state entering each kernel chunk.
//
// What bounds it on the H100: operations and bytes about evenly at
// zamba2's widths (about 4 L^2 (N + P) + 4 L P N multiply-adds a (b,
// kernel chunk, head) against x̄ and dy read and dx written, fp32).  With
// bf16 B and C every 64 x 64 x 64 product runs on the tensor cores
// (mma.sync m16n8k16, fp32 sums; scan::bwd::mma_tile): C B^T is exact,
// an fp32 operand (x̄, dy, a state, the decayed scores) is split into two
// bf16 parts, and a product of two fp32 operands keeps hi hi + hi lo + lo
// hi.  fp32 B and C take the same tiles as three TF32 products
// (mma.m16n8k8, each operand's TF32 parts, about 2^-21 relative).  Three
// launches (two with one kernel chunk), and the two of the rebase:
//  1. mamba_bwd_pass_kernel (two kernel chunks or more): two kinds of
//     block, one per (b, head) each, the [P, N] tile in four warps.
//     Forward blocks walk chunks 0 .. n - 2 and write the state entering
//     chunks 1 .. n - 1 (hin); reverse blocks walk chunks n - 1 .. 1 from
//     dstate, read in place, and write the cotangent leaving chunks 0 ..
//     n - 2 (dho).  The product of the chunk a pass ends on is read by
//     nobody and not formed.
//  2. mamba_bwd_chunk_kernel, one block per (b, kernel chunk, group of
//     heads; kernels/mamba_scan.py:plan_scan_backward): B, C and C B^T
//     once for the group, then head by head (the next head's x̄, dy and
//     states staged by cp.async while one is multiplied) dx, dg and the
//     head's dB and dC, summed in head order into the group's share.
//  3. mamba_bwd_groups_kernel sums the groups' shares of dB and dC, group
//     by group in order.
// Around them the rebase of cum (scan::bwd::rebase_kernel) and its adjoint
// (rebase_adjoint_kernel), one launch each.
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

constexpr int kMaxP = 64;
constexpr int kMaxN = 64;
constexpr int kPassThreads = 128;  // four warps, 16 rows of P each
constexpr int kThreads = 256;      // chunk blocks: eight warps, 16 x 32 each

// planted faults (kernels/mamba_scan.py FAULT_*), for the checks only
constexpr int kFaultWrongCotangent = 1;  // chunk c reads dh_out of c + 1
constexpr int kFaultDropGroup = 2;       // dB's group sum drops the last group
constexpr int kFaultOnePart = 4;         // every split cut to one part

struct Args {
  const float* x;
  const void* Bm;
  const void* Cm;
  const float* g;
  const float* dy;
  const float* dstate;
  float* hin;  // [chunks - 1][B][nh][P][N]: the state entering 1 ..
  float* dho;  // [chunks - 1][B][nh][P][N]: the cotangent leaving 0 ..
  float* dx;
  void* dB;
  void* dC;
  float* dBg;  // [B][chunks][groups][kL][N]: each group's share of dB
  float* dCg;
  float* dg;
  int B, S, nh, P, N, chunks, group, vec, fault;
};

__device__ __forceinline__ float g_at(const Args& a, int b, int t, int hd) {
  return a.g[(static_cast<size_t>(b) * a.chunks * kL + t) * a.nh + hd];
}

// the [P, N] scratch slot `slot` of head (b, hd)
__device__ __forceinline__ size_t slot_at(const Args& a, int slot, int b, int hd) {
  return ((static_cast<size_t>(slot) * a.B + b) * a.nh + hd) * a.P * a.N;
}

__device__ __forceinline__ int parts(const Args& a) {
  return (a.fault & kFaultOnePart) ? 1 : scan::bwd::kParts;
}

// ---- launch 1: the ordered passes over the kernel chunks ----
template <typename T>
struct PassSmem {
  Opnd<T> a;  // (w x̄) or (e^g dy) split, [j][p]
  Opnd<T> b;  // B or C exact, [j][n]
  alignas(16) float st[kL][kFLd];  // the x̄ or dy rows staged
  float sc[kL];
};

// Two kinds of block, one per (b, head) each: forward (the state entering
// chunks 1 .. n - 1, from zero: h <- e^{gl} h + sum_j (e^{gl - g_j} x̄_j)
// B_j^T) and reverse (the cotangent leaving chunks 0 .. n - 2, from
// dstate: dh <- e^{gl} dh + sum_i (e^{g_i} dy_i) C_i^T), one code for both.
// Warp w holds rows 16 w .. 16 w + 15 of P.
template <typename T>
__global__ void __launch_bounds__(kPassThreads) mamba_bwd_pass_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char raw[];
  PassSmem<T>& sm = *reinterpret_cast<PassSmem<T>*>(raw);
  const bool rev = static_cast<int>(blockIdx.x) >= a.B * a.nh;
  const int bid = blockIdx.x - (rev ? a.B * a.nh : 0);
  const int hd = bid % a.nh, b = bid / a.nh;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32, gq = lane / 4, tq = lane % 4;
  const size_t xld = static_cast<size_t>(a.nh) * a.P;
  const int np = parts(a);
  const float* init = a.dstate + slot_at(a, 0, b, hd);
  const float* rowsrc = rev ? a.dy : a.x;
  const T* colsrc = static_cast<const T*>(rev ? a.Cm : a.Bm);
  float h[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int p = 16 * warp + gq + 8 * (x >> 1), n = 8 * nt + 2 * tq + (x & 1);
      h[nt][x] = (rev && p < a.P && n < a.N) ? init[p * a.N + n] : 0.f;
    }
  for (int s = 0; s + 1 < a.chunks; ++s) {
    const int c = rev ? a.chunks - 1 - s : s;
    const int s0 = c * kL, rows = min(kL, a.S - s0);
    const float gl = g_at(a, b, s0 + rows - 1, hd);
    __syncthreads();  // the chunk before is done with the tiles
    if (t < kL) {
      const float gr = g_at(a, b, s0 + t, hd);
      sm.sc[t] = t < rows ? expf(rev ? gr : gl - gr) : 0.f;
    }
    const size_t row0 = static_cast<size_t>(b) * a.S + s0;
    load_tile<float, kFLd, kPassThreads>(&sm.st[0][0], rowsrc + row0 * xld + hd * a.P, xld,
                                         rows, a.P, a.vec);
    load_tile<T, kLdOf<T>, kPassThreads>(first(sm.b), colsrc + row0 * a.N, a.N, rows, a.N,
                                         a.vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    put_tile<kPassThreads>(sm.a, &sm.st[0][0], sm.sc);
    __syncthreads();
    const float decay = expf(gl);  // h <- e^{gl} h, then the chunk's product
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) h[nt][x] *= decay;
    mma_tile<8, true, true>(h, sm.a, np, sm.b, 1, 16 * warp, 0);
    float* dst = (rev ? a.dho : a.hin) + slot_at(a, rev ? c - 1 : c, b, hd);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int p = 16 * warp + gq + 8 * (x >> 1), n = 8 * nt + 2 * tq + (x & 1);
        if (p < a.P && n < a.N) dst[p * a.N + n] = h[nt][x];
      }
  }
}

// ---- launch 2: one (b, kernel chunk, group of heads) ----
template <typename T>
struct ChunkSmem {
  alignas(16) float st[4][kL][kFLd];  // the next head's x̄, dy, h_in, dh_out
  Opnd<T> x;   // x̄ [j][p], split
  Opnd<T> dy;  // dy [i][p], split
  Opnd<T> h;   // h_in [p][n], split
  Opnd<T> dh;  // dh_out [p][n], split
  Opnd<T> m;   // (C_i . B_j) e^{g_i - g_j}, causal, [i][j], split
  Opnd<T> ap;  // (dy_i . x̄_j) e^{g_i - g_j}, causal, [i][j], split
  alignas(16) T b[kL][kLdOf<T>];  // B [j][n], exact
  alignas(16) T c[kL][kLdOf<T>];  // C [i][n], exact
  float g[kL], eg[kL], ws[kL];
  float rowa[2][kL], cola[4][kL], car[2][kL], xd[2][kL];
  float hh[kThreads / 32];
};

// An exact tile (B or C) as the first part of an operand: the same rows,
// read through a view whose other parts are never touched (na = 1).
template <typename T>
__device__ __forceinline__ const Opnd<T>& as_opnd(const T (&t)[kL][kLdOf<T>]) {
  return *reinterpret_cast<const Opnd<T>*>(&t[0][0]);
}

// Warp w holds rows 16 (w % 4) .. + 15 and columns 32 (w / 4) .. + 31 of
// each 64 x 64 product.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) mamba_bwd_chunk_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char raw[];
  ChunkSmem<T>& sm = *reinterpret_cast<ChunkSmem<T>*>(raw);
  const int groups = (a.nh + a.group - 1) / a.group;
  const int bid = blockIdx.x;
  const int gr = bid % groups, c = bid / groups % a.chunks, b = bid / (groups * a.chunks);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32, gq = lane / 4, tq = lane % 4;
  const int m0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
  const int s0 = c * kL, rows = min(kL, a.S - s0);
  const int h0 = gr * a.group, h1 = min(a.nh, h0 + a.group);
  const size_t xld = static_cast<size_t>(a.nh) * a.P;
  const size_t row0 = static_cast<size_t>(b) * a.S + s0;
  const int np = parts(a);
  const int src = (a.fault & kFaultWrongCotangent) ? min(c + 1, a.chunks - 1) : c;

  auto stage = [&](int hd) {
    load_tile<float, kFLd, kThreads>(&sm.st[0][0][0], a.x + row0 * xld + hd * a.P, xld, rows,
                                     a.P, a.vec);
    load_tile<float, kFLd, kThreads>(&sm.st[1][0][0], a.dy + row0 * xld + hd * a.P, xld, rows,
                                     a.P, a.vec);
    if (c > 0)  // chunk 0's h_in is zero
      load_tile<float, kFLd, kThreads>(&sm.st[2][0][0], a.hin + slot_at(a, c - 1, b, hd), a.N,
                                       a.P, a.N, a.vec);
    load_tile<float, kFLd, kThreads>(
        &sm.st[3][0][0],
        src == a.chunks - 1 ? a.dstate + slot_at(a, 0, b, hd) : a.dho + slot_at(a, src, b, hd),
        a.N, a.P, a.N, a.vec);
  };
  load_tile<T, kLdOf<T>, kThreads>(&sm.b[0][0], static_cast<const T*>(a.Bm) + row0 * a.N, a.N,
                                   rows, a.N, a.vec);
  load_tile<T, kLdOf<T>, kThreads>(&sm.c[0][0], static_cast<const T*>(a.Cm) + row0 * a.N, a.N,
                                   rows, a.N, a.vec);
  stage(h0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // C_i . B_j, once for the group
  float s[4][4] = {};
  mma_tile<4, false, false>(s, as_opnd(sm.c), 1, as_opnd(sm.b), 1, m0, n0);
  float dBs[4][4] = {}, dCs[4][4] = {};  // the group's shares, head by head

  for (int hd = h0; hd < h1; ++hd) {
    if (hd > h0) {
      cp_async_wait<0>();
      __syncthreads();  // this head's tiles landed; the head before is done
    }
    put_tile<kThreads>(sm.x, &sm.st[0][0][0], nullptr);
    put_tile<kThreads>(sm.dy, &sm.st[1][0][0], nullptr);
    put_tile<kThreads>(sm.dh, &sm.st[3][0][0], nullptr);
    float hh = 0.f;  // <dh_out, h_in> (chunk 0's h_in is zero), in a fixed order
    if (c > 0) {
      put_tile<kThreads>(sm.h, &sm.st[2][0][0], nullptr);
      for (int i = t; i < kL * kL; i += kThreads)
        hh += sm.st[3][i / kL][i % kL] * sm.st[2][i / kL][i % kL];
    }
    hh = warp_sum(hh);
    if (lane == 0) sm.hh[warp] = hh;
    if (t < kL) {
      const float g = t < rows ? g_at(a, b, s0 + t, hd) : 0.f;
      const float gl = g_at(a, b, s0 + rows - 1, hd);
      sm.g[t] = g;
      sm.eg[t] = t < rows ? expf(g) : 0.f;
      sm.ws[t] = t < rows ? expf(gl - g) : 0.f;
    }
    __syncthreads();  // the parts and gates; the staging is free
    if (hd + 1 < h1) stage(hd + 1);
    cp_async_commit();

    // the decayed causal score matrices: m = s e, ap = (dy . x) e, and
    // dg's intra-chunk terms a = m (dy . x)
    {
      float d[4][4] = {};
      mma_tile<4, false, false>(d, sm.dy, np, sm.x, np, m0, n0);  // dy_i . x_j
      float ra[2] = {0.f, 0.f}, ca[4][2] = {};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hx = 0; hx < 2; ++hx) {
          const int i = m0 + gq + 8 * hx, j = n0 + 8 * nt + 2 * tq;
          float mv[2], av[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float e = (j + u <= i && i < rows) ? expf(sm.g[i] - sm.g[j + u]) : 0.f;
            mv[u] = s[nt][2 * hx + u] * e;
            av[u] = d[nt][2 * hx + u] * e;
            const float am = mv[u] * d[nt][2 * hx + u];
            ra[hx] += am;
            ca[nt][u] += am;
          }
          put2(sm.m, i, j, mv[0], mv[1]);
          put2(sm.ap, i, j, av[0], av[1]);
        }
#pragma unroll
      for (int hx = 0; hx < 2; ++hx) {
        const float v = quad_sum(ra[hx]);
        if (tq == 0) sm.rowa[warp >> 2][m0 + gq + 8 * hx] = v;
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float v = ca[nt][u];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (gq == 0) sm.cola[warp & 3][n0 + 8 * nt + 2 * tq + u] = v;
        }
    }
    __syncthreads();  // m, ap

    // dx_j[p] = sum_i m_ij dy_i[p] + e^{gl - g_j} sum_n B_j[n] dh[p][n]
    float xdp[2] = {0.f, 0.f};
    {
      float acc[4][4] = {}, st[4][4] = {};
      mma_tile<4, true, true>(acc, sm.m, np, sm.dy, np, m0, n0);
      mma_tile<4, false, false>(st, as_opnd(sm.b), 1, sm.dh, np, m0, n0);
      float* dx = a.dx + row0 * xld + hd * a.P;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int j = m0 + gq + 8 * (x >> 1), p = n0 + 8 * nt + 2 * tq + (x & 1);
          const float sv = sm.ws[j] * st[nt][x];
          xdp[x >> 1] += scan::bwd::get_all(sm.x, j, p) * sv;
          if (j < rows && p < a.P) dx[j * xld + p] = acc[nt][x] + sv;
        }
    }
    // this head's dB_j[n] = sum_i ap_ij C_i[n] + e^{gl - g_j} sum_p x_j[p] dh[p][n]
    {
      float acc[4][4] = {}, st[4][4] = {};
      mma_tile<4, true, true>(acc, sm.ap, np, as_opnd(sm.c), 1, m0, n0);
      mma_tile<4, false, true>(st, sm.x, np, sm.dh, np, m0, n0);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          dBs[nt][x] += acc[nt][x] + sm.ws[m0 + gq + 8 * (x >> 1)] * st[nt][x];
    }
    // this head's dC_i[n] = sum_j ap_ij B_j[n] + e^{g_i} sum_p dy_i[p] h[p][n]
    float carp[2] = {0.f, 0.f};
    {
      float acc[4][4] = {}, cr[4][4] = {};
      mma_tile<4, false, true>(acc, sm.ap, np, as_opnd(sm.b), 1, m0, n0);
      if (c > 0) mma_tile<4, false, true>(cr, sm.dy, np, sm.h, np, m0, n0);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int i = m0 + gq + 8 * (x >> 1), n = n0 + 8 * nt + 2 * tq + (x & 1);
          const float cv = sm.eg[i] * cr[nt][x];
          carp[x >> 1] += get(as_opnd(sm.c), i, n) * cv;
          dCs[nt][x] += acc[nt][x] + cv;
        }
    }
#pragma unroll
    for (int hx = 0; hx < 2; ++hx) {
      const float xv = quad_sum(xdp[hx]), cv = quad_sum(carp[hx]);
      if (tq == 0) {
        sm.xd[warp >> 2][m0 + gq + 8 * hx] = xv;
        sm.car[warp >> 2][m0 + gq + 8 * hx] = cv;
      }
    }
    __syncthreads();  // the row and column sums
    if (t < kL) {
      const float xdt = sm.xd[0][t] + sm.xd[1][t];
      float dg = (sm.rowa[0][t] + sm.rowa[1][t]) -
                 (((sm.cola[0][t] + sm.cola[1][t]) + sm.cola[2][t]) + sm.cola[3][t]) +
                 (sm.car[0][t] + sm.car[1][t]) - xdt;
      if (t == rows - 1) {
        float tot = 0.f, xs = 0.f;
        for (int w = 0; w < kThreads / 32; ++w) tot += sm.hh[w];
        for (int j = 0; j < rows; ++j) xs += sm.xd[0][j] + sm.xd[1][j];
        dg += expf(sm.g[t]) * tot + xs;
      }
      a.dg[(static_cast<size_t>(b) * a.chunks * kL + s0 + t) * a.nh + hd] = t < rows ? dg : 0.f;
    }
  }
  // the group's shares of dB and dC
  const size_t share = ((static_cast<size_t>(b) * a.chunks + c) * groups + gr) * kL * a.N;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = m0 + gq + 8 * (x >> 1), n = n0 + 8 * nt + 2 * tq + (x & 1);
      if (n < a.N) {
        a.dBg[share + r * a.N + n] = dBs[nt][x];
        a.dCg[share + r * a.N + n] = dCs[nt][x];
      }
    }
}

// ---- launch 3: dB, dC [B, S, N], the groups' shares summed in order ----
template <typename T>
__global__ void __launch_bounds__(kThreads) mamba_bwd_groups_kernel(const Args a) {
  const size_t total = static_cast<size_t>(a.B) * a.S * a.N;
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int groups = (a.nh + a.group - 1) / a.group;
  const int n = i % a.N;
  const size_t bt = i / a.N;
  const int tt = bt % a.S, b = bt / a.S;
  const int c = tt / kL, r = tt % kL;
  const size_t stride = static_cast<size_t>(kL) * a.N;
  const size_t at = ((static_cast<size_t>(b) * a.chunks + c) * groups) * stride +
                    static_cast<size_t>(r) * a.N + n;
  const int groups_b = (a.fault & kFaultDropGroup) ? groups - 1 : groups;
  float sb = 0.f, sc = 0.f;
  for (int gr = 0; gr < groups; ++gr) {
    if (gr < groups_b) sb += a.dBg[at + gr * stride];
    sc += a.dCg[at + gr * stride];
  }
  static_cast<T*>(a.dB)[i] = from_float<T>(sb);
  static_cast<T*>(a.dC)[i] = from_float<T>(sc);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int launch(const Args& a, const float* cum, float* dcum, int Q, cudaStream_t stream) {
  static const cudaError_t attr = [] {  // once
    cudaError_t e = allow_smem(mamba_bwd_pass_kernel<T>, sizeof(PassSmem<T>));
    if (e == cudaSuccess) e = allow_smem(mamba_bwd_chunk_kernel<T>, sizeof(ChunkSmem<T>));
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t gsize = static_cast<size_t>(a.B) * a.chunks * kL * a.nh;
  scan::bwd::rebase_kernel<<<static_cast<unsigned>((gsize + 255) / 256), 256, 0, stream>>>(
      cum, const_cast<float*>(a.g), a.B, a.S, Q, a.nh, a.chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.chunks > 1) {
    mamba_bwd_pass_kernel<T><<<2 * a.B * a.nh, kPassThreads, sizeof(PassSmem<T>), stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int groups = (a.nh + a.group - 1) / a.group;
  mamba_bwd_chunk_kernel<T><<<a.B * a.chunks * groups, kThreads, sizeof(ChunkSmem<T>),
                              stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(a.B) * a.S * a.N;
  mamba_bwd_groups_kernel<T><<<static_cast<unsigned>((total + kThreads - 1) / kThreads),
                               kThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t rows = static_cast<size_t>(a.B) * a.S * a.nh;
  scan::bwd::rebase_adjoint_kernel<<<static_cast<unsigned>((rows + 255) / 256), 256, 0,
                                     stream>>>(a.dg, dcum, a.B, a.S, Q, a.nh, a.chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cum [B, S, nh] is the caller's log-decay cumsum (restarted every Q
// rows), dcum its gradient; scratch (the wrapper's torch.empty; nothing is
// allocated here): g and dg [B, chunks * 64, nh] (cum rebased per kernel
// chunk, and its gradient), hin, dho [chunks - 1, B, nh, P, N] and dBg,
// dCg [B, chunks, ceil(nh / group), 64, N] fp32.  `chunks` must be
// ceil(S / 64);
// `vec` says every row of x̄, dy, B, C and the states starts 16 bytes
// aligned and P, N fill whole 16-byte pieces (else plain loads).
extern "C" int mamba_chunk_scan_backward_launch(
    const void* xbar, const void* Bm, const void* Cm, const void* cum, const void* dy,
    const void* dstate, void* g, void* hin, void* dho, void* dx, void* dB, void* dC,
    void* dBg, void* dCg, void* dg, void* dcum, int B, int S, int Q, int nh, int P, int N,
    int chunks, int group, int dtype, int vec, int fault, void* stream) {
  if (S < 1 || B < 1 || Q < 1 || S % Q || nh < 1 || P < 1 || P > kMaxP || N < 1 ||
      N > kMaxN || group < 1 ||
      chunks != (S + kL - 1) / kL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(xbar), Bm, Cm,
               static_cast<const float*>(g), static_cast<const float*>(dy),
               static_cast<const float*>(dstate), static_cast<float*>(hin),
               static_cast<float*>(dho), static_cast<float*>(dx), dB, dC,
               static_cast<float*>(dBg), static_cast<float*>(dCg),
               static_cast<float*>(dg), B, S, nh, P, N, chunks, group, vec, fault};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cf = static_cast<const float*>(cum);
  float* dcf = static_cast<float*>(dcum);
  if (dtype == kFloat32) return launch<float>(a, cf, dcf, Q, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(a, cf, dcf, Q, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
