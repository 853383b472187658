// Helpers shared by the two chunk scans (mlstm_scan.cu, mamba_scan.cu).
//
// Both scans regroup the caller's chunks (Q rows, the log-decay cumsum
// restarted at each) into kernel chunks of kL rows, and run in stages
// over (b, kernel chunk, head, tile): the state entering each kernel
// chunk, the scores of each chunk, the outputs.  The plan (kernel chunks,
// grid) comes from shapes alone (kernels/mamba_scan.py:plan_scan).
#pragma once

#include "common.cuh"

namespace scan {

constexpr int kL = 64;          // rows of a kernel chunk
constexpr int kThreads = 128;   // four warps a block

// planted faults (kernels/mamba_scan.py FAULT_*), for the checks only
constexpr int kFaultWrongState = 1;  // chunk c reads the state entering c-1
constexpr int kFaultSplitLow = 2;    // each split's parts but the first dropped
constexpr int kFaultNoRebase = 4;    // cum not rebased across caller chunks

// The gates of one kernel chunk (rows s0 .. s0 + rows - 1 of one (b,
// head)), held two rows a lane by one warp between their load and their
// use, so a block can load the next chunk's while it works on this one.
struct Gates {
  float c[2];   // the caller's log-decay cumsum of the lane's two rows
  float li[2];  // the input gate of those rows (0 where there is none)
  float base;   // the cumsum just before s0 inside its caller chunk, or 0
};

// Issue the loads of a chunk's gates (cum_t at cum[t * stride], li_t at
// li[t * stride]; li may be null).
__device__ __forceinline__ void gates_load(const float* __restrict__ cum,
                                           const float* __restrict__ li,
                                           size_t stride, int s0, int rows,
                                           int Q, Gates& v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = 2 * lane + x;
    const size_t at = static_cast<size_t>(s0 + r) * stride;
    v.c[x] = r < rows ? cum[at] : 0.f;
    v.li[x] = r < rows && li ? li[at] : 0.f;
  }
  v.base = s0 % Q ? cum[static_cast<size_t>(s0 - 1) * stride] : 0.f;
}

// The log-decay cumsum rebased to the kernel chunk, into g[0 .. kL) (0
// past `rows`): the caller's cumsum restarts every Q rows, so
//   g_t = cum_t - cum_{s0 - 1} (if s0 is inside a caller chunk)
//         + the last cum of every caller chunk that ends in [s0, t);
// and, where w is given, the weight of each row to the chunk's end,
// w_t = e^{g_last - g_t + li_t} (0 past `rows`).  Returns g_last.  Run by
// one whole warp: one shuffle scan in a fixed order.
__device__ __forceinline__ float gates_rebase(const Gates& v, int s0, int rows,
                                              int Q, bool no_rebase, float* g,
                                              float* w) {
  const int lane = threadIdx.x & 31;
  float e[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = 2 * lane + x;
    e[x] = (r < rows && (s0 + r) % Q == Q - 1 && !no_rebase) ? v.c[x] : 0.f;
  }
  const float s = e[0] + e[1];
  float incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  const float g0 = (v.c[0] - v.base) + excl;
  const float g1 = (v.c[1] - v.base) + (excl + e[0]);
  const float gl = __shfl_sync(0xffffffffu, (rows - 1) & 1 ? g1 : g0,
                               (rows - 1) >> 1);
  const bool ok0 = 2 * lane < rows, ok1 = 2 * lane + 1 < rows;
  g[2 * lane] = ok0 ? g0 : 0.f;
  g[2 * lane + 1] = ok1 ? g1 : 0.f;
  if (w) {
    w[2 * lane] = ok0 ? expf(gl - g0 + v.li[0]) : 0.f;
    w[2 * lane + 1] = ok1 ? expf(gl - g1 + v.li[1]) : 0.f;
  }
  return gl;
}

// Both at once, for a block that needs one chunk's g (whole warp).
__device__ __forceinline__ void rebase_chunk(const float* __restrict__ cum,
                                             size_t stride, int s0, int rows,
                                             int Q, bool no_rebase,
                                             float* g) {
  Gates v;
  gates_load(cum, nullptr, stride, s0, rows, Q, v);
  gates_rebase(v, s0, rows, Q, no_rebase, g, nullptr);
}

// src[r][c] (row stride ld) for r < rows, c < cols, else 0, into the
// R x CN tile dst[r][c] (or dst[c][r] with kTrans), row stride ldd: the
// thread's loads issued in batches of 16 before their stores.
template <int R, int CN, bool kTrans, typename T>
__device__ __forceinline__ void stage(float* dst, int ldd, const T* src,
                                      size_t ld, int rows, int cols) {
  constexpr int kIters = (R * CN + kThreads - 1) / kThreads, kBatch = 16;
#pragma unroll 1
  for (int it0 = 0; it0 < kIters; it0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = threadIdx.x + (it0 + u) * kThreads, r = i / CN,
                c = i % CN;
      v[u] = (i < R * CN && r < rows && c < cols) ? to_float(src[r * ld + c])
                                                  : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = threadIdx.x + (it0 + u) * kThreads, r = i / CN,
                c = i % CN;
      if (i < R * CN) {
        if (kTrans)
          dst[c * ldd + r] = v[u];
        else
          dst[r * ldd + c] = v[u];
      }
    }
  }
}

// The rows r < rows of a [R][4 CN4] fp32 tile (row stride ld floats,
// 16-byte aligned) into dst (row stride ldd), 16 bytes a copy, zeros
// past rows or cols (cols a multiple of 4).
template <int R, int CN4>
__device__ __forceinline__ void cp_tile_f32(float* dst, int ldd,
                                            const float* src, size_t ld,
                                            int rows, int cols) {
  for (int i = threadIdx.x; i < R * CN4; i += kThreads) {
    const int r = i / CN4, c = i % CN4 * 4;
    const bool ok = r < rows && c < cols;
    cp_async16(dst + r * ldd + c, ok ? src + r * ld + c : src, ok);
  }
}

// acc[a][c] += sum_{k < K} A(r0 + 16 a, k) B(k, c0 + 8 c) on the CUDA
// cores, for the thread's 4 x NC share of a 64 x 8 NC tile (r0 = t / 8,
// c0 = t % 8), A and B in shared memory: A(m, k) at A[k * lda + m], or at
// A[m * lda + k] with kAm; B(k, n) at B[k * ldb + n], or at B[n * ldb + k]
// with kBn.
template <int NC, bool kAm = false, bool kBn = false>
__device__ __forceinline__ void fma_tile(float (&acc)[4][NC], const float* A,
                                         int lda, const float* B, int ldb,
                                         int K) {
  const int r0 = threadIdx.x / 8, c0 = threadIdx.x % 8;
  for (int k = 0; k < K; ++k) {
    float a[4], b[NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = kAm ? A[(r0 + 16 * i) * lda + k] : A[k * lda + r0 + 16 * i];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      b[c] = kBn ? B[(c0 + 8 * c) * ldb + k] : B[k * ldb + c0 + 8 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] += a[i] * b[c];
  }
}

// An fp32 operand of a bf16 product as three bf16 parts, x = p0 + p1 + p2
// to about 2^-26 relative (each part the bf16 rounding of what the ones
// before leave; every residual is exact in fp32).  Two parts leave
// 2^-18, which measured on the card put the mLSTM scan over the fp32
// limit.
constexpr int kParts = 3;

// Two fp32 values as kParts registers of two bf16 each (x0 in the low
// halves).
__device__ __forceinline__ void split_bf16x2(float x0, float x1,
                                             unsigned (&p)[kParts]) {
#pragma unroll
  for (int s = 0; s < kParts; ++s) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    p[s] = *reinterpret_cast<const unsigned*>(&h);
    x0 -= hf.x;
    x1 -= hf.y;
  }
}

// The raw shared memory of a block whose roles use different layouts.
template <typename S>
__device__ __forceinline__ S& smem_as(unsigned char* raw) {
  return *reinterpret_cast<S*>(raw);
}

__host__ __device__ constexpr size_t cmax(size_t a, size_t b) {
  return a > b ? a : b;
}

// ---- the backward kernels' 64 x 64 tiles (mamba_scan_backward.cu,
// mlstm_scan_backward.cu): blocks of kTileThreads threads, fp32 tiles in
// shared memory at row stride kLd, each thread holding a 4 x 4 share of a
// 64 x 64 product (rows t / 16 + 16 x, columns t % 16 + 16 y).
constexpr int kTileThreads = 256;
constexpr int kLd = kL + 1;

// acc[x][y] += sum_{k < K} A(r0 + 16 x, k) B(k, c0 + 16 y) (r0 = t / 16,
// c0 = t % 16); A(r, k) at A[r kLd + k] (at A[k kLd + r] with kAT), B(k,
// c) at B[k kLd + c] (at B[c kLd + k] with kBT), all in shared memory.
template <bool kAT, bool kBT>
__device__ __forceinline__ void mm(float (&acc)[4][4], const float* A, const float* Bt,
                                   int K) {
  const int r0 = threadIdx.x / 16, c0 = threadIdx.x % 16;
  for (int k = 0; k < K; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
      av[x] = kAT ? A[k * kLd + r0 + 16 * x] : A[(r0 + 16 * x) * kLd + k];
#pragma unroll
    for (int y = 0; y < 4; ++y)
      bv[y] = kBT ? Bt[(c0 + 16 * y) * kLd + k] : Bt[k * kLd + c0 + 16 * y];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[x][y] += av[x] * bv[y];
  }
}

// The sum over the 16 threads that share a row of mm's layout (one half
// of a warp), in a fixed order.
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace scan
