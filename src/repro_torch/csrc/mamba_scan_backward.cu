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
//             last row <dh_out, h_out>.
//
// The port's own: the TPU kernel repro/kernels/mamba_scan.py:
// mamba_chunk_scan_chunked has no backward, and the reference
// differentiates repro/models/ssm.py's pure-JAX scan with jax.grad.  The
// forward keeps its schema and saves nothing, so the backward recomputes
// the state entering each kernel chunk.
//
// What bounds it on the H100: operations, in fp32 on the CUDA cores (about
// 4 L^2 (N + P) + 4 L P N multiply-adds a (b, kernel chunk, head), against
// one read of the inputs and one write of the gradients).  Three launches:
//  1. mamba_bwd_pass_kernel: two kinds of block, one per (b, head, 16 rows
//     of P) each.  Forward blocks walk the kernel chunks in order and
//     write the state entering each (hin); reverse blocks walk them
//     backwards from dstate and write the cotangent of the state leaving
//     each (dho).
//  2. mamba_bwd_chunk_kernel, one block per (b, kernel chunk, head), its
//     x, dy, B, C rows and both [P, N] states in shared memory: dx, this
//     head's share of dB and dC (to scratch) and dg.
//  3. mamba_bwd_heads_kernel sums the heads' shares of dB and dC, head by
//     head in order.
// No atomics: two runs give identical bits.
#include "scan.cuh"

namespace {

using scan::kL;
using scan::kLd;
using scan::mm;
using scan::row_sum16;
constexpr int kThreads = scan::kTileThreads;  // chunk blocks

constexpr int kMaxP = 64;
constexpr int kMaxN = 64;
constexpr int kPT = 16;        // rows of P a pass block owns
constexpr int kPassThreads = 128;

// planted faults (kernels/mamba_scan.py FAULT_*), for the checks only
constexpr int kFaultWrongCotangent = 1;  // chunk c reads dh_out of c + 1
constexpr int kFaultDropHead = 2;        // dB's head sum drops the last head

struct Args {
  const float* x;
  const void* Bm;
  const void* Cm;
  const float* g;
  const float* dy;
  const float* dstate;
  float* hin;  // [chunks][B][nh][P][N]
  float* dho;  // [chunks][B][nh][P][N]
  float* dx;
  void* dB;
  void* dC;
  float* dBh;  // [B][chunks][nh][kL][N]: each head's share of dB
  float* dCh;
  float* dg;
  int B, S, nh, P, N, chunks, fault;
};

__device__ __forceinline__ float g_at(const Args& a, int b, int t, int hd) {
  return a.g[(static_cast<size_t>(b) * a.chunks * kL + t) * a.nh + hd];
}

// One (b, head, P tile), forward (kReverse false: the state entering each
// kernel chunk, from zero) or backwards (the cotangent of the state
// leaving each, from dstate).  Thread t holds row p0 + t / 8 of the tile,
// columns t % 8 + 8 m.
template <typename T, bool kReverse>
__device__ void pass_block(const Args& a, int bid, float* sm) {
  float(*u)[kPT + 1] = reinterpret_cast<float(*)[kPT + 1]>(sm);
  float(*v)[kMaxN + 1] = reinterpret_cast<float(*)[kMaxN + 1]>(sm + kL * (kPT + 1));
  float* w = sm + kL * (kPT + 1) + kL * (kMaxN + 1);
  const int ptiles = (a.P + kPT - 1) / kPT;
  const int pt = bid % ptiles, hd = bid / ptiles % a.nh, b = bid / (ptiles * a.nh);
  const int t = threadIdx.x, p = t / 8, n0 = t % 8, p0 = pt * kPT;
  const size_t head = static_cast<size_t>(b) * a.nh + hd;
  const size_t xld = static_cast<size_t>(a.nh) * a.P;
  // forward: rows x_j, columns B_j, weights e^{gl - g_j}; reverse: rows
  // dy_i, columns C_i, weights e^{g_i}
  const float* rowsrc = kReverse ? a.dy : a.x;
  const T* colsrc = static_cast<const T*>(kReverse ? a.Cm : a.Bm);
  float* out = kReverse ? a.dho : a.hin;
  float h[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int n = n0 + 8 * m;
    h[m] = (kReverse && p0 + p < a.P && n < a.N)
               ? a.dstate[(head * a.P + p0 + p) * a.N + n]
               : 0.f;
  }
  for (int s = 0; s < a.chunks; ++s) {
    const int c = kReverse ? a.chunks - 1 - s : s;
    const int s0 = c * kL, rows = min(kL, a.S - s0);
    const float gl = g_at(a, b, s0 + rows - 1, hd);
    __syncthreads();  // the chunk before is done with u, v, w
    for (int i = t; i < kL * kPT; i += kPassThreads) {
      const int r = i / kPT, pp = i % kPT;
      u[r][pp] = (r < rows && p0 + pp < a.P)
                     ? rowsrc[(static_cast<size_t>(b) * a.S + s0 + r) * xld +
                              static_cast<size_t>(hd) * a.P + p0 + pp]
                     : 0.f;
    }
    for (int i = t; i < kL * kMaxN; i += kPassThreads) {
      const int r = i / kMaxN, e = i % kMaxN;
      v[r][e] = (r < rows && e < a.N)
                    ? to_float(colsrc[(static_cast<size_t>(b) * a.S + s0 + r) * a.N + e])
                    : 0.f;
    }
    for (int r = t; r < kL; r += kPassThreads) {
      const float gr = g_at(a, b, s0 + r, hd);
      w[r] = r < rows ? expf(kReverse ? gr : gl - gr) : 0.f;
    }
    __syncthreads();
    if (p0 + p < a.P) {
      float* dst = out + ((static_cast<size_t>(c) * a.B * a.nh + head) * a.P + p0 + p) * a.N;
#pragma unroll
      for (int m = 0; m < 8; ++m)
        if (n0 + 8 * m < a.N) dst[n0 + 8 * m] = h[m];
    }
    float part[8] = {};
    for (int r = 0; r < rows; ++r) {
      const float uw = w[r] * u[r][p];
#pragma unroll
      for (int m = 0; m < 8; ++m) part[m] += uw * v[r][n0 + 8 * m];
    }
    const float decay = expf(gl);
#pragma unroll
    for (int m = 0; m < 8; ++m) h[m] = h[m] * decay + part[m];
  }
}

constexpr size_t kPassSmem = sizeof(float) * (kL * (kPT + 1) + kL * (kMaxN + 1) + kL);

template <typename T>
__global__ void __launch_bounds__(kPassThreads) mamba_bwd_pass_kernel(const Args a,
                                                                      int per_kind) {
  extern __shared__ __align__(16) unsigned char raw[];
  float* sm = reinterpret_cast<float*>(raw);
  if (static_cast<int>(blockIdx.x) < per_kind)
    pass_block<T, false>(a, blockIdx.x, sm);
  else
    pass_block<T, true>(a, blockIdx.x - per_kind, sm);
}

struct ChunkSmem {
  float x[kL][kLd];    // x_j [j][p]
  float dy[kL][kLd];   // dy_i [i][p]
  float b[kL][kLd];    // B_j [j][n]
  float c[kL][kLd];    // C_i [i][n]
  float h[kMaxP][kLd];   // h_in [p][n]
  float dh[kMaxP][kLd];  // dh_out [p][n]
  float m[kL][kLd];    // (C_i . B_j) e^{g_i - g_j}, causal
  float ap[kL][kLd];   // (dy_i . x_j) e^{g_i - g_j}, causal
  float a[kL][kLd];    // their product (dg's intra-chunk terms)
  float g[kL], rowa[kL], cola[kL], xd[kL], car[kL];
  float red[kThreads / 32];
};

template <typename T>
__global__ void __launch_bounds__(kThreads) mamba_bwd_chunk_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char raw[];
  ChunkSmem& sm = *reinterpret_cast<ChunkSmem*>(raw);
  const int bid = blockIdx.x;
  const int hd = bid % a.nh, c = bid / a.nh % a.chunks, b = bid / (a.nh * a.chunks);
  const int t = threadIdx.x, r0 = t / 16, c0 = t % 16;
  const int s0 = c * kL, rows = min(kL, a.S - s0);
  const size_t xld = static_cast<size_t>(a.nh) * a.P;
  const size_t row0 = static_cast<size_t>(b) * a.S + s0;
  const size_t head = static_cast<size_t>(b) * a.nh + hd;
  const T* bp = static_cast<const T*>(a.Bm) + row0 * a.N;
  const T* cp = static_cast<const T*>(a.Cm) + row0 * a.N;
  const int src = (a.fault & kFaultWrongCotangent) ? min(c + 1, a.chunks - 1) : c;
  const float* hp = a.hin + (static_cast<size_t>(c) * a.B * a.nh + head) * a.P * a.N;
  const float* dhp = a.dho + (static_cast<size_t>(src) * a.B * a.nh + head) * a.P * a.N;

  for (int i = t; i < kL * kL; i += kThreads) {
    const int r = i / kL, e = i % kL;
    const bool okp = r < rows && e < a.P, okn = r < rows && e < a.N;
    const size_t xo = (row0 + r) * xld + static_cast<size_t>(hd) * a.P + e;
    sm.x[r][e] = okp ? a.x[xo] : 0.f;
    sm.dy[r][e] = okp ? a.dy[xo] : 0.f;
    sm.b[r][e] = okn ? to_float(bp[static_cast<size_t>(r) * a.N + e]) : 0.f;
    sm.c[r][e] = okn ? to_float(cp[static_cast<size_t>(r) * a.N + e]) : 0.f;
    const bool oks = r < a.P && e < a.N;
    sm.h[r][e] = oks ? hp[r * a.N + e] : 0.f;
    sm.dh[r][e] = oks ? dhp[r * a.N + e] : 0.f;
  }
  if (t < kL) sm.g[t] = t < rows ? g_at(a, b, s0 + t, hd) : 0.f;
  __syncthreads();
  const float gl = sm.g[rows - 1];

  {  // the decayed causal score matrices
    float s[4][4] = {}, d[4][4] = {};
    mm<false, true>(s, &sm.c[0][0], &sm.b[0][0], a.N);   // C_i . B_j
    mm<false, true>(d, &sm.dy[0][0], &sm.x[0][0], a.P);  // dy_i . x_j
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int i = r0 + 16 * x, j = c0 + 16 * y;
        const float e = (j <= i && i < rows) ? expf(sm.g[i] - sm.g[j]) : 0.f;
        sm.m[i][j] = s[x][y] * e;
        sm.ap[i][j] = d[x][y] * e;
        sm.a[i][j] = s[x][y] * e * d[x][y];
      }
  }
  __syncthreads();
  if (t < kL) {  // row sums
    float s = 0.f;
    for (int j = 0; j < kL; ++j) s += sm.a[t][j];
    sm.rowa[t] = s;
  } else if (t < 2 * kL) {  // column sums
    float s = 0.f;
    for (int i = 0; i < kL; ++i) s += sm.a[i][t - kL];
    sm.cola[t - kL] = s;
  }

  // dx_j[p] = sum_i m_ij dy_i[p] + e^{gl - g_j} sum_n B_j[n] dh[p][n]
  {
    float acc[4][4] = {}, st[4][4] = {};
    mm<true, false>(acc, &sm.m[0][0], &sm.dy[0][0], rows);
    mm<false, true>(st, &sm.b[0][0], &sm.dh[0][0], a.N);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int j = r0 + 16 * x;
      const float wj = j < rows ? expf(gl - sm.g[j]) : 0.f;
      float xd = 0.f;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int p = c0 + 16 * y;
        st[x][y] *= wj;
        xd += sm.x[j][p] * st[x][y];
        if (j < rows && p < a.P)
          a.dx[(row0 + j) * xld + static_cast<size_t>(hd) * a.P + p] = acc[x][y] + st[x][y];
      }
      xd = row_sum16(xd);
      if (c0 == 0) sm.xd[j] = xd;
    }
  }

  // this head's dB_j[n] = sum_i ap_ij C_i[n] + e^{gl - g_j} sum_p x_j[p] dh[p][n]
  float* dBh = a.dBh + ((static_cast<size_t>(b) * a.chunks + c) * a.nh + hd) * kL * a.N;
  float* dCh = a.dCh + ((static_cast<size_t>(b) * a.chunks + c) * a.nh + hd) * kL * a.N;
  {
    float acc[4][4] = {}, st[4][4] = {};
    mm<true, false>(acc, &sm.ap[0][0], &sm.c[0][0], rows);
    mm<false, false>(st, &sm.x[0][0], &sm.dh[0][0], a.P);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int j = r0 + 16 * x;
      const float wj = j < rows ? expf(gl - sm.g[j]) : 0.f;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int n = c0 + 16 * y;
        if (n < a.N) dBh[j * a.N + n] = acc[x][y] + wj * st[x][y];
      }
    }
  }
  // this head's dC_i[n] = sum_j ap_ij B_j[n] + e^{g_i} sum_p dy_i[p] h[p][n]
  {
    float acc[4][4] = {}, cr[4][4] = {};
    mm<false, false>(acc, &sm.ap[0][0], &sm.b[0][0], rows);
    mm<false, false>(cr, &sm.dy[0][0], &sm.h[0][0], a.P);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = r0 + 16 * x;
      const float ei = i < rows ? expf(sm.g[i]) : 0.f;
      float car = 0.f;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int n = c0 + 16 * y;
        cr[x][y] *= ei;
        car += sm.c[i][n] * cr[x][y];
        if (n < a.N) dCh[i * a.N + n] = acc[x][y] + cr[x][y];
      }
      car = row_sum16(car);
      if (c0 == 0) sm.car[i] = car;
    }
  }

  // <dh_out, h_in>, in a fixed order
  float hh = 0.f;
  for (int i = t; i < kMaxP * kMaxN; i += kThreads)
    hh += sm.dh[i / kMaxN][i % kMaxN] * sm.h[i / kMaxN][i % kMaxN];
  hh = warp_sum(hh);
  if (t % 32 == 0) sm.red[t / 32] = hh;
  __syncthreads();
  if (t < kL) {
    float dg = sm.rowa[t] - sm.cola[t] + sm.car[t] - sm.xd[t];
    if (t == rows - 1) {
      float tot = 0.f, xs = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) tot += sm.red[w];
      for (int j = 0; j < rows; ++j) xs += sm.xd[j];
      dg += expf(gl) * tot + xs;
    }
    a.dg[(static_cast<size_t>(b) * a.chunks * kL + s0 + t) * a.nh + hd] = t < rows ? dg : 0.f;
  }
}

// dB, dC [B, S, N]: the heads' shares summed in head order.
template <typename T>
__global__ void __launch_bounds__(kThreads) mamba_bwd_heads_kernel(const Args a) {
  const size_t total = static_cast<size_t>(a.B) * a.S * a.N;
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int n = i % a.N;
  const size_t bt = i / a.N;
  const int tt = bt % a.S, b = bt / a.S;
  const int c = tt / kL, r = tt % kL;
  const size_t stride = static_cast<size_t>(kL) * a.N;
  const size_t at = ((static_cast<size_t>(b) * a.chunks + c) * a.nh) * stride +
                    static_cast<size_t>(r) * a.N + n;
  const int heads_b = (a.fault & kFaultDropHead) ? a.nh - 1 : a.nh;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < a.nh; ++h) {
    if (h < heads_b) sb += a.dBh[at + h * stride];
    sc += a.dCh[at + h * stride];
  }
  static_cast<T*>(a.dB)[i] = from_float<T>(sb);
  static_cast<T*>(a.dC)[i] = from_float<T>(sc);
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  const int per_kind = a.B * a.nh * ((a.P + kPT - 1) / kPT);
  mamba_bwd_pass_kernel<T><<<2 * per_kind, kPassThreads, kPassSmem, stream>>>(a, per_kind);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  static const cudaError_t attr = cudaFuncSetAttribute(  // once
      mamba_bwd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      sizeof(ChunkSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  mamba_bwd_chunk_kernel<T><<<a.B * a.chunks * a.nh, kThreads, sizeof(ChunkSmem), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(a.B) * a.S * a.N;
  mamba_bwd_heads_kernel<T><<<static_cast<unsigned>((total + kThreads - 1) / kThreads),
                              kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch: hin, dho [chunks, B, nh, P, N] and dBh, dCh [B, chunks, nh, 64,
// N] fp32 (the wrapper's torch.empty; nothing is allocated here); g and dg
// [B, chunks * 64, nh].  `chunks` must be ceil(S / 64).
extern "C" int mamba_chunk_scan_backward_launch(
    const void* xbar, const void* Bm, const void* Cm, const void* g, const void* dy,
    const void* dstate, void* hin, void* dho, void* dx, void* dB, void* dC, void* dBh,
    void* dCh, void* dg, int B, int S, int nh, int P, int N, int chunks, int dtype,
    int fault, void* stream) {
  if (S < 1 || B < 1 || nh < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      chunks != (S + kL - 1) / kL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(xbar), Bm, Cm,
               static_cast<const float*>(g), static_cast<const float*>(dy),
               static_cast<const float*>(dstate), static_cast<float*>(hin),
               static_cast<float*>(dho), static_cast<float*>(dx), dB, dC,
               static_cast<float*>(dBh), static_cast<float*>(dCh),
               static_cast<float*>(dg), B, S, nh, P, N, chunks, fault};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(a, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
