// Gradient of GQA prefill attention (csrc/flash_attention.cu): given q, k,
// v, the forward's out and dout = dL/dout, it writes dq, dk and dv.
//
//   q, dq [B, Sq, H, hd]; k, dk [B, Sk, Hkv, hd]; v, dv [B, Sk, Hkv,
//   hd_v]; out, dout [B, Sq, H, hd_v]; all contiguous, one dtype (fp32 or
//   bf16).  Query i sits at position pq = i + q_offset, key j at pk = j;
//   causal keeps pq >= pk, a window keeps pq - pk < window; query head h
//   reads KV head h / (H / Hkv).  hd is 16, 32, 64, 96 or 128 with hd_v =
//   hd, or MLA's hd 192 (128 + 64 rope) with hd_v 128.
//
// The port's own: the TPU kernel repro/kernels/flash_attention.py has no
// backward, and the reference differentiates repro/models/layers.py:
// chunked_attention with jax.grad.  With P = softmax(scale q k^T) under
// the mask (fp32), the forward's O = P_v v where P_v is P cast to v's
// dtype; so
//   dv = P_v^T dout,   dP = dout v^T,   dS = P (dP - rowsum(dout out)),
//   dq = scale dS k,   dk = scale dS^T q.
// The forward saves no softmax statistics (its schema stays as it is, so
// a recorded serving program keeps its nodes), so they are recomputed
// here: two launches, in order on one stream.  Launch A, per (b, query
// head, tile of query rows), walks the K tiles its rows can see twice:
// once for each row's log-sum-exp, once for dq; it writes the log-sum-exp
// and D = rowsum(dout out) to fp32 scratch.  Launch B, per (b, KV head,
// tile of keys), walks the query heads of its KV head (in bf16 at hd >=
// 64, those of its split of the group) and, for each, the query tiles
// that can see its keys, and sums dk and dv over them in a fixed order.
// What bounds it on the H100: at the train step's shapes (S = 128) the
// latency of each block's chain of loads and products, not bytes; over
// whisper's 1,500 frames the tensor cores.  It does five products over the
// visible pairs where the forward does two (and pass 1's sixth).
//   * bf16, hd 64, 96, 128 and 192 (the trained path): every product by wgmma
//     (m64nNk16, bf16 in, fp32 accumulate), one warpgroup a block, on
//     64-row tiles swizzled by 128 B in shared memory, loaded by cp.async
//     through a ring of two stages: a step issues its first products,
//     then the next tile's loads, so they run under the products, and
//     leaves its last products in flight until the next step's top.
//     Launch A: a block owns 64 query rows; S = Q K^T and dP = dO V^T
//     from shared memory, dQ += dS K with dS taken from the accumulator
//     as the A operand in registers (rounded to bf16, as FlashAttention-2
//     does) and K read MN-major from the tile S read K-major; where the
//     visible K tiles fit the ring they are loaded once for both passes.
//     Launch B: a block owns 64 keys and walks hp of the group's G query
//     heads (hp and the split G / hp come from repro_torch/kernels/
//     flash_attention.py:plan_flash_backward, a function of the shapes and
//     the SM count, which splits the group so the (b, KV head, key tile,
//     split) blocks cover the SMs: at the qwen2.5-3b train step, G = 8 in
//     4 splits of 2, 128 blocks); S^T = K Q^T, dP^T = V dO^T, then dV +=
//     P_v^T dO and dK += dS^T Q from the registers.  A split's blocks
//     form a thread block cluster and sum their fp32 dK and dV in block
//     order: each stores its share of a row, whole rows a warp, into the
//     row's owner block's shared memory (stores, no round trip of remote
//     loads), and the owner adds the shares.  Launch B is launched with
//     programmatic stream serialization: its blocks start, and load K and
//     V, while launch A's last blocks run, and wait for its lse and D in
//     griddepcontrol.wait.  The masks are two compares against per-thread
//     bounds, skipped on tiles every pair of which is visible; outputs go
//     through shared memory so device memory sees 16-byte stores.  At hd
//     64 the register bound holds three blocks an SM.  MLA's (192, 128)
//     runs the products over q and k (S = Q K^T, dQ, dK) at 192, three
//     64-column blocks a tile, and those over v and dO (dP = dO V^T, dV)
//     at 128; its K [64][192] and V [64][128] tiles with the ring's two Q /
//     dO stages take 124 KB of shared memory, one block an SM, and launch
//     B's dK and dV accumulators 160 registers a thread.  Its group is one
//     head (H = Hkv), so launch B is never split.
//   * bf16, hd 16 and 32 (smoke widths, where a 64-row wgmma tile does not
//     pay): mma.sync m16n8k16 with ldmatrix fragments, launch A 4 warps of
//     16 query rows, launch B 2 warps of 16 keys over all G heads.
//   * fp32 (the parity path) keeps CUDA cores, as the forward's fp32 path
//     does (TF32 could not meet the fp32 limit): a warp per query row
//     (launch A) or per key (launch B), each lane holding dims lane + 32 t,
//     dot products summed by warp shuffles.
// Every sum runs in a fixed order for a given plan and nothing is atomic,
// so two runs give the same bits.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

// ------------------------------------------------ fp32: CUDA cores --
constexpr int BK = 32;        // keys per staged tile (launch A)
constexpr int BQ = 32;        // query rows per staged tile (launch B)
constexpr int A_WARPS = 8;    // launch A: warps per block
constexpr int A_RPW = 2;      // ... rows per warp
constexpr int A_ROWS = A_WARPS * A_RPW;
constexpr int B_WARPS = 8;    // launch B: warps (= keys) per block

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ bool visible(int pq, int pk, int causal,
                                        int window) {
  return (!causal || pq >= pk) && (!window || pq - pk < window);
}

// This lane's dims (lane + 32 t) of the HD-element row at p, as fp32.
template <typename T, int HD>
__device__ __forceinline__ void load_row(const T* p, int lane,
                                         float (&f)[(HD + 31) / 32]) {
#pragma unroll
  for (int t = 0; t < (HD + 31) / 32; ++t) {
    const int d = lane + 32 * t;
    f[t] = (HD % 32 == 0 || d < HD) ? to_float(p[d]) : 0.f;
  }
}

template <typename T, int HD>
__device__ __forceinline__ void store_row(T* p, int lane,
                                          const float (&f)[(HD + 31) / 32],
                                          float mul) {
#pragma unroll
  for (int t = 0; t < (HD + 31) / 32; ++t) {
    const int d = lane + 32 * t;
    if (HD % 32 == 0 || d < HD) p[d] = from_float<T>(f[t] * mul);
  }
}

// sum over this lane's dims of a[t] * row[lane + 32 t] (row in shared)
template <int HD>
__device__ __forceinline__ float lane_dot(const float (&a)[(HD + 31) / 32],
                                          const float* row, int lane) {
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < (HD + 31) / 32; ++t) {
    const int d = lane + 32 * t;
    if (HD % 32 == 0 || d < HD) s += a[t] * row[d];
  }
  return s;
}

// rows [first, first + n) of a [rows, stride]-strided tensor's HD-wide
// head slice into sm [n_max][HD] as fp32, zeros past n; every thread of
// the block takes part.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* sm, const T* base, int first,
                                      int n, int n_max, size_t stride) {
  for (int e = threadIdx.x; e < n_max * HD; e += blockDim.x) {
    const int r = e / HD, d = e % HD;
    sm[e] = r < n ? to_float(base[(first + r) * stride + d]) : 0.f;
  }
}

template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(A_WARPS * 32)
    flash_bwd_dq_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ out,
                        const T* __restrict__ dout, T* __restrict__ dq,
                        float* __restrict__ lse, float* __restrict__ delta,
                        int Sq, int Sk, int H, int Hkv, int causal,
                        int window, float scale, int q_offset,
                        int short_tiles) {
  constexpr int DPL = (HD + 31) / 32, DPLV = (HDV + 31) / 32;
  // at (192, 128): 24.6 + 16.4 KB, under the 48 KB of static shared memory
  __shared__ float ks[BK * HD];
  __shared__ float vs[BK * HDV];
  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / (H / Hkv);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int i0 = blockIdx.x * A_ROWS;
  const size_t qstride = static_cast<size_t>(H) * HD;
  const size_t ostride = static_cast<size_t>(H) * HDV;
  const size_t kstride = static_cast<size_t>(Hkv) * HD;
  const size_t vstride = static_cast<size_t>(Hkv) * HDV;
  const T* kb = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * HD;
  const T* vb = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * HDV;

  float qr[A_RPW][DPL], dor[A_RPW][DPLV], dqr[A_RPW][DPL];
  float m[A_RPW], l[A_RPW], lr[A_RPW], dl[A_RPW];
  int pq[A_RPW];
  bool live[A_RPW];
#pragma unroll
  for (int r = 0; r < A_RPW; ++r) {
    const int i = i0 + warp * A_RPW + r;
    live[r] = i < Sq;
    pq[r] = i + q_offset;
    m[r] = kNegInf, l[r] = 0.f, dl[r] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) qr[r][t] = dqr[r][t] = 0.f;
#pragma unroll
    for (int t = 0; t < DPLV; ++t) dor[r][t] = 0.f;
    if (live[r]) {
      const size_t off = (static_cast<size_t>(b) * Sq + i) * qstride + h * HD;
      const size_t ooff =
          (static_cast<size_t>(b) * Sq + i) * ostride + h * HDV;
      float outr[DPLV];
      load_row<T, HD>(q + off, lane, qr[r]);
      load_row<T, HDV>(dout + ooff, lane, dor[r]);
      load_row<T, HDV>(out + ooff, lane, outr);
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < DPLV; ++t) s += dor[r][t] * outr[t];
      dl[r] = s;
    }
    dl[r] = warp_sum(dl[r]);
  }
  // the keys some row of the block can see
  const int i_last = min(Sq, i0 + A_ROWS) - 1;
  int hi = causal ? min(Sk, i_last + q_offset + 1) : Sk;
  const int lo = window ? max(0, i0 + q_offset - window + 1) : 0;
  hi = max(lo, hi - short_tiles * BK);  // a planted fault when > 0

  // pass 1: each row's max and sum over its visible keys
  for (int j0 = lo; j0 < hi; j0 += BK) {
    const int n = min(BK, hi - j0);
    __syncthreads();
    stage<T, HD>(ks, kb, j0, n, BK, kstride);
    __syncthreads();
#pragma unroll 2
    for (int jj = 0; jj < n; ++jj) {
      float s[A_RPW];
#pragma unroll
      for (int r = 0; r < A_RPW; ++r)
        s[r] = warp_sum(lane_dot<HD>(qr[r], ks + jj * HD, lane)) * scale;
#pragma unroll
      for (int r = 0; r < A_RPW; ++r) {
        if (live[r] && visible(pq[r], j0 + jj, causal, window)) {
          const float mn = fmaxf(m[r], s[r]);
          l[r] = l[r] * expf(m[r] - mn) + expf(s[r] - mn);
          m[r] = mn;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < A_RPW; ++r)
    lr[r] = l[r] > 0.f ? m[r] + logf(l[r]) : pos_inf();  // no key: P = 0

  // pass 2: dq
  for (int j0 = lo; j0 < hi; j0 += BK) {
    const int n = min(BK, hi - j0);
    __syncthreads();
    stage<T, HD>(ks, kb, j0, n, BK, kstride);
    stage<T, HDV>(vs, vb, j0, n, BK, vstride);
    __syncthreads();
#pragma unroll 2
    for (int jj = 0; jj < n; ++jj) {
      const float* kr = ks + jj * HD;
      float s[A_RPW], dp[A_RPW];
#pragma unroll
      for (int r = 0; r < A_RPW; ++r) {
        s[r] = warp_sum(lane_dot<HD>(qr[r], kr, lane)) * scale;
        dp[r] = warp_sum(lane_dot<HDV>(dor[r], vs + jj * HDV, lane));
      }
#pragma unroll
      for (int r = 0; r < A_RPW; ++r) {
        if (live[r] && visible(pq[r], j0 + jj, causal, window)) {
          const float ds = expf(s[r] - lr[r]) * (dp[r] - dl[r]);
#pragma unroll
          for (int t = 0; t < DPL; ++t) {
            const int d = lane + 32 * t;
            if (HD % 32 == 0 || d < HD) dqr[r][t] += ds * kr[d];
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < A_RPW; ++r) {
    if (!live[r]) continue;
    const int i = i0 + warp * A_RPW + r;
    store_row<T, HD>(dq + (static_cast<size_t>(b) * Sq + i) * qstride + h * HD,
                     lane, dqr[r], scale);
    if (lane == 0) {
      const size_t si = (static_cast<size_t>(b) * H + h) * Sq + i;
      lse[si] = lr[r];
      delta[si] = dl[r];
    }
  }
}

template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(B_WARPS * 32)
    flash_bwd_dkdv_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int Sq,
                          int Sk, int H, int Hkv, int causal, int window,
                          float scale, int q_offset) {
  constexpr int DPL = (HD + 31) / 32, DPLV = (HDV + 31) / 32;
  __shared__ float qs[BQ * HD];
  __shared__ float dos[BQ * HDV];
  __shared__ float ls[BQ], dls[BQ];
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv, G = H / Hkv;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int j0 = blockIdx.x * B_WARPS, j = j0 + warp;
  const bool live = j < Sk;
  const size_t qstride = static_cast<size_t>(H) * HD;
  const size_t ostride = static_cast<size_t>(H) * HDV;
  const size_t koff = (static_cast<size_t>(b) * Sk + j) * Hkv * HD + hk * HD;
  const size_t voff =
      (static_cast<size_t>(b) * Sk + j) * Hkv * HDV + hk * HDV;

  float kr[DPL], vr[DPLV], dkr[DPL], dvr[DPLV];
#pragma unroll
  for (int t = 0; t < DPL; ++t) kr[t] = dkr[t] = 0.f;
#pragma unroll
  for (int t = 0; t < DPLV; ++t) vr[t] = dvr[t] = 0.f;
  if (live) {
    load_row<T, HD>(k + koff, lane, kr);
    load_row<T, HDV>(v + voff, lane, vr);
  }
  // the query rows that can see some key of the block
  const int j1 = min(Sk, j0 + B_WARPS);
  const int i_lo = causal ? max(0, j0 - q_offset) : 0;
  const int i_hi = window ? min(Sq, j1 - 1 + window - q_offset) : Sq;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const T* qb = q + static_cast<size_t>(b) * Sq * qstride + h * HD;
    const T* dob = dout + static_cast<size_t>(b) * Sq * ostride + h * HDV;
    const size_t sb = (static_cast<size_t>(b) * H + h) * Sq;
    for (int i0 = i_lo; i0 < i_hi; i0 += BQ) {
      const int n = min(BQ, i_hi - i0);
      __syncthreads();
      stage<T, HD>(qs, qb, i0, n, BQ, qstride);
      stage<T, HDV>(dos, dob, i0, n, BQ, ostride);
      if (threadIdx.x < BQ) {
        ls[threadIdx.x] = threadIdx.x < n ? lse[sb + i0 + threadIdx.x] : 0.f;
        dls[threadIdx.x] = threadIdx.x < n ? delta[sb + i0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int ii = 0; ii < n; ++ii) {
        const float* qrow = qs + ii * HD;
        const float* drow = dos + ii * HDV;
        const float s = warp_sum(lane_dot<HD>(kr, qrow, lane)) * scale;
        const float dp = warp_sum(lane_dot<HDV>(vr, drow, lane));
        if (live && visible(i0 + ii + q_offset, j, causal, window)) {
          const float p = expf(s - ls[ii]);
          const float pv = to_float(from_float<T>(p));  // P_v, as in the forward
          const float ds = p * (dp - dls[ii]);
#pragma unroll
          for (int t = 0; t < DPLV; ++t) {
            const int d = lane + 32 * t;
            if (HDV % 32 == 0 || d < HDV) dvr[t] += pv * drow[d];
          }
#pragma unroll
          for (int t = 0; t < DPL; ++t) {
            const int d = lane + 32 * t;
            if (HD % 32 == 0 || d < HD) dkr[t] += ds * qrow[d];
          }
        }
      }
    }
  }
  if (live) {
    store_row<T, HD>(dk + koff, lane, dkr, scale);
    store_row<T, HDV>(dv + voff, lane, dvr, 1.f);
  }
}

// --------------------------------- bf16, hd 16 and 32: mma.sync --
constexpr int M_PAD = 8;      // bf16 elements of padding per shared row
constexpr int MA_WARPS = 4;   // launch A: warps a block, 16 query rows each
constexpr int MA_BQ = 16 * MA_WARPS;
constexpr int MA_BK = 64;     // launch A: keys a K/V tile
constexpr int MB_WARPS = 2;   // launch B: warps a block, 16 keys each
constexpr int MB_BK = 16 * MB_WARPS;
constexpr int MB_BQ = 32;     // launch B: query rows a Q/dO tile
constexpr float kLog2e = 1.4426950408889634f;
static_assert(2 * MA_BQ == MA_WARPS * 32, "launch A: two threads a row of D");

// Rows [r0, r0 + ROWS) of src (row stride `stride` elements, DIM wide) into
// dst [ROWS][DIM + M_PAD] by cp.async, by the THREADS threads numbered
// `tid`; rows outside [lo, hi) become zeros.
template <int ROWS, int DIM, int THREADS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           size_t stride, int r0, int lo,
                                           int hi, int tid) {
  constexpr int CPR = DIM / 8;  // 16-byte chunks a row
#pragma unroll 4
  for (int i = tid; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int row = r0 + r;
    const bool ok = row >= lo && row < hi;
    cp_async16(dst + r * (DIM + M_PAD) + c,
               ok ? src + static_cast<size_t>(row) * stride + c : src, ok);
  }
}

// acc = A B^T for the warp's 16 rows: A's rows at `a`, B's N8 x 8 rows
// (the output's columns) at `b`, both KD deep, row stride S, in shared
// memory.  acc[t] is the m16n8 tile of columns 8 t + [0, 8).
template <int N8, int KD, int S>
__device__ __forceinline__ void mma_abt(float (&acc)[N8][4], const bf16* a,
                                        const bf16* b, int lane) {
#pragma unroll
  for (int t = 0; t < N8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KD / 16; ++ks) {
    unsigned af[4];
    ldmatrix_x4(af, a + ((lane & 7) + ((lane >> 3) & 1) * 8) * S + ks * 16 +
                        (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < N8 / 2; ++np) {
      unsigned bf[4];
      ldmatrix_x4(bf, b + (np * 16 + (lane & 7) + (lane >> 4) * 8) * S +
                          ks * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16_16816(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16_16816(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc += A B for the warp's 16 rows: A as KD / 16 register fragments, B
// [KD][N8 x 8] row major in shared memory (row stride S), read transposed.
template <int N8, int KD, int S>
__device__ __forceinline__ void mma_ab(float (&acc)[N8][4],
                                       const unsigned (&a)[KD / 16][4],
                                       const bf16* b, int lane) {
#pragma unroll
  for (int ks = 0; ks < KD / 16; ++ks) {
#pragma unroll
    for (int dn = 0; dn < N8 / 2; ++dn) {
      unsigned bf[4];
      ldmatrix_x4_trans(bf, b + (ks * 16 + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * S +
                                dn * 16 + (lane >> 4) * 8);
      mma_bf16_16816(acc[2 * dn], a[ks], bf[0], bf[1]);
      mma_bf16_16816(acc[2 * dn + 1], a[ks], bf[2], bf[3]);
    }
  }
}

// The accumulator tiles of 16 x (N8 x 8) as bf16 A fragments of N8 / 2
// k-steps (the m16n8 accumulator and the m16k16 operand share a layout).
template <int N8>
__device__ __forceinline__ void to_a(unsigned (&a)[N8 / 2][4],
                                     const float (&acc)[N8][4]) {
#pragma unroll
  for (int t = 0; t < N8; ++t) {
    a[t / 2][(t & 1) * 2] = pack_bf16x2(acc[t][0], acc[t][1]);
    a[t / 2][(t & 1) * 2 + 1] = pack_bf16x2(acc[t][2], acc[t][3]);
  }
}

template <int HD>
constexpr int dq_mma_smem() {
  return (2 * MA_BQ + 2 * MA_BK) * (HD + M_PAD) * 2 + MA_BQ * 4;
}

// Launch A in bf16: warp w owns query rows q0 + 16 w + [0, 16); this
// thread's rows are row0 and row0 + 8, its columns of a tile 8 t + 2
// (lane % 4) + {0, 1}.  lse holds the log-sum-exp in base 2 of the scaled
// scores (P = 2^(s scale log2(e) - lse)).
template <int HD>
__global__ void __launch_bounds__(MA_WARPS * 32)
    flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ out,
                            const bf16* __restrict__ dout,
                            bf16* __restrict__ dq, float* __restrict__ lse,
                            float* __restrict__ delta, int Sq, int Sk, int H,
                            int Hkv, int causal, int window, float scale,
                            int q_offset, int short_tiles) {
  constexpr int S = HD + M_PAD, NT = MA_BK / 8, ND = HD / 8;
  constexpr int THREADS = MA_WARPS * 32;
  extern __shared__ __align__(16) unsigned char dq_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(dq_smem);
  bf16* sDO = sQ + MA_BQ * S;
  bf16* sK = sDO + MA_BQ * S;
  bf16* sV = sK + MA_BK * S;
  float* sD = reinterpret_cast<float*>(sV + MA_BK * S);

  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * MA_BQ;
  const size_t qstride = static_cast<size_t>(H) * HD;
  const size_t kstride = static_cast<size_t>(Hkv) * HD;
  const size_t qhead = (static_cast<size_t>(b) * Sq * H + h) * HD;
  const bf16* kb = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * HD;
  const bf16* vb = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * HD;

  stage_rows<MA_BQ, HD, THREADS>(sQ, q + qhead, qstride, q0, 0, Sq,
                                 threadIdx.x);
  stage_rows<MA_BQ, HD, THREADS>(sDO, dout + qhead, qstride, q0, 0, Sq,
                                 threadIdx.x);
  cp_async_commit();
  {  // D = rowsum(dout out), two threads a row
    const int r = threadIdx.x / 2, half = threadIdx.x % 2;
    float acc = 0.f;
    if (q0 + r < Sq) {
      const size_t off = qhead + (q0 + r) * qstride + half * (HD / 2);
#pragma unroll
      for (int d = 0; d < HD / 2; d += 8) {
        const Vec<bf16, 8> x = load_vec<bf16, 8>(dout + off + d);
        const Vec<bf16, 8> y = load_vec<bf16, 8>(out + off + d);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc += to_float(x.v[e]) * to_float(y.v[e]);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) sD[r] = acc;
  }
  cp_async_wait<0>();
  __syncthreads();  // Q, dO and D are in shared memory

  // the keys some row of the block can see, in whole tiles
  const int first_pos = q0 + q_offset;
  const int last_pos = min(q0 + MA_BQ, Sq) - 1 + q_offset;
  const int k_hi = causal ? min(Sk, last_pos + 1) : Sk;
  const int k_lo = window > 0 ? max(0, first_pos - window + 1) : 0;
  const int t_lo = k_lo / MA_BK;
  // short_tiles > 0 only for a planted fault: that many tiles left out
  const int n_tiles =
      k_hi > k_lo ? max(0, (k_hi + MA_BK - 1) / MA_BK - t_lo - short_tiles)
                  : 0;
  const float sl2 = scale * kLog2e;
  const int row0 = q0 + warp * 16 + lane / 4;
  const bf16* wQ = sQ + warp * 16 * S;

  // pass 1: each row's max and sum in base 2 (the forward's online form)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int j = 0; j < n_tiles; ++j) {
    const int kt0 = (t_lo + j) * MA_BK;
    __syncthreads();  // the last tile is read
    stage_rows<MA_BK, HD, THREADS>(sK, kb, kstride, kt0, k_lo, k_hi,
                                   threadIdx.x);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[NT][4];
    mma_abt<NT, HD, S>(s, wQ, sK, lane);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt0 + 8 * t + 2 * (lane & 3) + (e & 1);
        const int pos = row0 + 8 * (e >> 1) + q_offset;
        if (!(key < k_hi && visible(pos, key, causal, window)))
          s[t][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[t][e]);
      }
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r] * sl2;
      l[r] *= exp2_approx(m[r] * sl2 - base[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        l[e >> 1] += exp2_approx(fmaf(s[t][e], sl2, -base[e >> 1]));
  }
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    lse2[r] = l[r] > 0.f ? m[r] * sl2 + log2f(l[r]) : INFINITY;  // no key: P = 0
    dl[r] = sD[warp * 16 + lane / 4 + 8 * r];
  }

  // pass 2: dS = P (dP - D), dQ += dS K
  float dqa[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    const int kt0 = (t_lo + j) * MA_BK;
    __syncthreads();
    stage_rows<MA_BK, HD, THREADS>(sK, kb, kstride, kt0, k_lo, k_hi,
                                   threadIdx.x);
    stage_rows<MA_BK, HD, THREADS>(sV, vb, kstride, kt0, k_lo, k_hi,
                                   threadIdx.x);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[NT][4], dp[NT][4];
    mma_abt<NT, HD, S>(s, wQ, sK, lane);
    mma_abt<NT, HD, S>(dp, sDO + warp * 16 * S, sV, lane);
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt0 + 8 * t + 2 * (lane & 3) + (e & 1);
        const int pos = row0 + 8 * (e >> 1) + q_offset;
        const float p = key < k_hi && visible(pos, key, causal, window)
                            ? exp2_approx(fmaf(s[t][e], sl2, -lse2[e >> 1]))
                            : 0.f;
        s[t][e] = p * (dp[t][e] - dl[e >> 1]);
      }
    unsigned dsa[MA_BK / 16][4];
    to_a<NT>(dsa, s);
    mma_ab<ND, MA_BK, S>(dqa, dsa, sK, lane);
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    bf16* o = dq + qhead + row * qstride + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<unsigned*>(o + 8 * n) =
          pack_bf16x2(dqa[n][2 * r] * scale, dqa[n][2 * r + 1] * scale);
    if ((lane & 3) == 0) {
      const size_t si = (static_cast<size_t>(b) * H + h) * Sq + row;
      lse[si] = lse2[r];
      delta[si] = dl[r];
    }
  }
}

// Launch B in bf16: warp w owns keys k0 + 16 w + [0, 16) (this thread's:
// key0 and key0 + 8); S^T and dP^T tiles are [16 keys][32 query rows].
template <int HD>
__global__ void __launch_bounds__(MB_WARPS * 32)
    flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              int Sq, int Sk, int H, int Hkv, int causal,
                              int window, float scale, int q_offset) {
  constexpr int S = HD + M_PAD, NT = MB_BQ / 8, ND = HD / 8;
  constexpr int THREADS = MB_WARPS * 32;
  __shared__ __align__(16) bf16 sK[MB_BK * S];
  __shared__ __align__(16) bf16 sV[MB_BK * S];
  __shared__ __align__(16) bf16 sQ[MB_BQ * S];
  __shared__ __align__(16) bf16 sDO[MB_BQ * S];
  __shared__ float sL[MB_BQ], sDl[MB_BQ];
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv, G = H / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * MB_BK, k1 = min(Sk, k0 + MB_BK);
  const size_t qstride = static_cast<size_t>(H) * HD;
  const size_t kstride = static_cast<size_t>(Hkv) * HD;
  const size_t khead = (static_cast<size_t>(b) * Sk * Hkv + hk) * HD;
  stage_rows<MB_BK, HD, THREADS>(sK, k + khead, kstride, k0, 0, Sk,
                                 threadIdx.x);
  stage_rows<MB_BK, HD, THREADS>(sV, v + khead, kstride, k0, 0, Sk,
                                 threadIdx.x);
  cp_async_commit();
  // the query rows that can see some key of the block
  const int i_lo = causal ? max(0, k0 - q_offset) : 0;
  const int i_hi = window > 0 ? min(Sq, k1 - 1 + window - q_offset) : Sq;
  const float sl2 = scale * kLog2e;
  const int key0 = k0 + warp * 16 + lane / 4;

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t qhead = (static_cast<size_t>(b) * Sq * H + h) * HD;
    const size_t sb = (static_cast<size_t>(b) * H + h) * Sq;
    for (int i0 = i_lo; i0 < i_hi; i0 += MB_BQ) {
      __syncthreads();  // the last tile is read
      stage_rows<MB_BQ, HD, THREADS>(sQ, q + qhead, qstride, i0, 0, Sq,
                                     threadIdx.x);
      stage_rows<MB_BQ, HD, THREADS>(sDO, dout + qhead, qstride, i0, 0, Sq,
                                     threadIdx.x);
      cp_async_commit();
      if (threadIdx.x < MB_BQ) {
        const int row = i0 + threadIdx.x;
        sL[threadIdx.x] = row < Sq ? lse[sb + row] : INFINITY;
        sDl[threadIdx.x] = row < Sq ? delta[sb + row] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();
      float st[NT][4], dpt[NT][4];
      mma_abt<NT, HD, S>(st, sK + warp * 16 * S, sQ, lane);
      mma_abt<NT, HD, S>(dpt, sV + warp * 16 * S, sDO, lane);
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * t + 2 * (lane & 3) + (e & 1);
          const int key = key0 + 8 * (e >> 1);
          const float p =
              key < Sk && visible(i0 + col + q_offset, key, causal, window)
                  ? exp2_approx(fmaf(st[t][e], sl2, -sL[col]))
                  : 0.f;
          st[t][e] = p;
          dpt[t][e] = p * (dpt[t][e] - sDl[col]);
        }
      unsigned pa[MB_BQ / 16][4], da[MB_BQ / 16][4];
      to_a<NT>(pa, st);   // P_v: P rounded to bf16, as the forward's PV
      to_a<NT>(da, dpt);
      mma_ab<ND, MB_BQ, S>(dva, pa, sDO, lane);
      mma_ab<ND, MB_BQ, S>(dka, da, sQ, lane);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= Sk) continue;
    const size_t off = khead + key * kstride + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<unsigned*>(dk + off + 8 * n) =
          pack_bf16x2(dka[n][2 * r] * scale, dka[n][2 * r + 1] * scale);
      *reinterpret_cast<unsigned*>(dv + off + 8 * n) =
          pack_bf16x2(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, const void* out,
               const void* dout, void* dq, void* dk, void* dv, void* lse,
               void* delta, int B, int Sq, int Sk, int H, int Hkv, int causal,
               int window, float scale, int q_offset, int short_tiles,
               cudaStream_t s) {
  constexpr int smem = dq_mma_smem<HD>();
  // above 48 KB only by request, made once before the first launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 ga((Sq + MA_BQ - 1) / MA_BQ, B * H);
  flash_bwd_dq_mma_kernel<HD><<<ga, MA_WARPS * 32, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq),
      static_cast<float*>(lse), static_cast<float*>(delta), Sq, Sk, H, Hkv,
      causal, window, scale, q_offset, short_tiles);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 gb((Sk + MB_BK - 1) / MB_BK, B * Hkv);
  flash_bwd_dkdv_mma_kernel<HD><<<gb, MB_WARPS * 32, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk, H, Hkv, causal,
      window, scale, q_offset);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------ bf16, hd 64, 96, 128: wgmma --
constexpr int W_ROWS = 64;       // rows of every tile: a warpgroup's M
constexpr int W_THREADS = 128;   // one warpgroup a block
constexpr int W_STAGES = 2;      // ring stages: K/V (launch A), Q/dO (B)
constexpr int BWD_MAX_SPLIT = 8; // launch B's blocks a group: one cluster
constexpr int RECV_ROWS = 70;    // the most of split ceil(64 / split)

// A [64][HD] bf16 tile in shared memory: HDP columns held (hd 96 in 128:
// a column of the pad only ever feeds an output column past HD, which is
// not written), as NB blocks of 64 columns, each [64 rows][128 bytes]
// swizzled by 128 B (chunk c of row r at c ^ (r % 8)), the layout of
// PTX's canonical 128-byte-swizzled wgmma operands.
template <int HD>
struct WTile {
  static constexpr int HDP = (HD + 63) / 64 * 64;
  static constexpr int NB = HDP / 64;
  static constexpr int BYTES = NB * W_ROWS * 128;
  static constexpr int KS = HD / 16;  // k-steps of a product over hd
};

// byte offset of the 16-byte chunk holding columns [c, c + 8) of row r
__device__ __forceinline__ int sw_off(int r, int c) {
  return (c >> 6) * W_ROWS * 128 + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4);
}

// Rows [r0, r0 + 64) of src (row stride `stride` elements, HD wide) into
// a swizzled tile by cp.async; rows outside [lo, hi) become zeros.
template <int HD>
__device__ __forceinline__ void stage_sw(unsigned char* dst, const bf16* src,
                                         size_t stride, int r0, int lo,
                                         int hi, int tid) {
  constexpr int CPR = HD / 8;  // 16-byte chunks a row
#pragma unroll 4
  for (int i = tid; i < W_ROWS * CPR; i += W_THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int row = r0 + r;
    const bool ok = row >= lo && row < hi;
    cp_async16(dst + sw_off(r, c),
               ok ? src + static_cast<size_t>(row) * stride + c : src, ok);
  }
}

// k-step kk of a tile read K-major (depths 16 kk.. of every row: 32 bytes
// into the 128-byte rows of column block kk / 4)
__device__ __forceinline__ unsigned long long desc_k(const unsigned char* t,
                                                     int kk) {
  return gmma_desc(t + (kk >> 2) * W_ROWS * 128 + (kk & 3) * 32, 16, 1024);
}

// k-step kk of a tile read MN-major (its rows are the depth: rows 16 kk..;
// its columns the N side, one 64-column block every W_ROWS * 128 bytes)
__device__ __forceinline__ unsigned long long desc_mn(const unsigned char* t,
                                                      int kk) {
  return gmma_desc(t + kk * 16 * 128, W_ROWS * 128, 1024);
}

// The m64n64 accumulator (keys or query rows on N) as bf16 A fragments of
// its four k-steps of 16 (acc[4 j + e] is mma.sync's acc[j][e]).
__device__ __forceinline__ void acc_to_a(unsigned (&a)[4][4],
                                         const float (&acc)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16x2(acc[8 * kk + 2 * i], acc[8 * kk + 2 * i + 1]);
}

// A [64][HD] bf16 tile's rows [0, rows) from shared memory (row stride
// HD + 8) to device memory (row stride `stride`) in 16-byte pieces, a
// warp covering whole rows.
template <int HD>
__device__ __forceinline__ void copy_rows_out(bf16* dst, size_t stride,
                                              const bf16* tile, int rows,
                                              int tid) {
  constexpr int CPR = HD / 8;
  for (int i = tid; i < rows * CPR; i += W_THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    *reinterpret_cast<uint4*>(dst + r * stride + c) =
        *reinterpret_cast<const uint4*>(tile + r * (HD + 8) + c);
  }
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - static_cast<int>(__cvta_generic_to_shared(p) & 1023)) &
              1023);
}

// Q and dO, W_STAGES (K, V) stages, D, and 1 KB to align to 1024 B
template <int HD, int HDV>
constexpr int dq_wgmma_smem() {
  return (1 + W_STAGES) * (WTile<HD>::BYTES + WTile<HDV>::BYTES) +
         W_ROWS * 4 + 1024;
}

// Launch A in bf16 by wgmma: the warpgroup owns query rows q0 + [0, 64)
// (warp w rows 16 w + [0, 16); this thread's row0 and row0 + 8, its
// columns of the m64n64 accumulator 8 j + 2 (lane % 4) + {0, 1}).  The
// visible K tiles stream through a ring of W_STAGES (K, V) stages, the
// next one loading under this one's products; where they all fit the ring
// (n_tiles <= W_STAGES, as at the train step's 128 keys) they are loaded
// once, K and V together, and both passes read them there.  Pass 1:
// S = Q K^T for each row's max and sum; pass 2: S, dP = dO V^T, dS =
// P (dP - D) in fp32 and dQ += dS K with dS from the registers.  The
// products over q and k run at HD, those over v and dO at HDV.
template <int HD, int HDV>
__global__ void __launch_bounds__(W_THREADS, HD <= 64 ? 3 : 2)
    flash_bwd_dq_wgmma_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ out,
                              const bf16* __restrict__ dout,
                              bf16* __restrict__ dq, float* __restrict__ lse,
                              float* __restrict__ delta, int Sq, int Sk,
                              int H, int Hkv, int causal, int window,
                              float scale, int q_offset, int short_tiles) {
  using TL = WTile<HD>;
  using TV = WTile<HDV>;
  constexpr int T = TL::BYTES, TVB = TV::BYTES;
  extern __shared__ __align__(16) unsigned char fbw_smem[];
  unsigned char* sQ = align1024(fbw_smem);
  unsigned char* sDO = sQ + T;
  unsigned char* ring = sDO + TVB;
  float* sD = reinterpret_cast<float*>(ring + W_STAGES * (T + TVB));

  trigger_dependents();  // launch B may take SMs as this launch's free up
  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * W_ROWS;
  const size_t qstride = static_cast<size_t>(H) * HD;
  const size_t ostride = static_cast<size_t>(H) * HDV;
  const size_t kstride = static_cast<size_t>(Hkv) * HD;
  const size_t vstride = static_cast<size_t>(Hkv) * HDV;
  const size_t qhead = (static_cast<size_t>(b) * Sq * H + h) * HD;
  const size_t ohead = (static_cast<size_t>(b) * Sq * H + h) * HDV;
  const bf16* kb = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * HD;
  const bf16* vb = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * HDV;

  // the keys some row of the block can see, in whole tiles
  const int first_pos = q0 + q_offset;
  const int last_pos = min(q0 + W_ROWS, Sq) - 1 + q_offset;
  const int k_hi = causal ? min(Sk, last_pos + 1) : Sk;
  const int k_lo = window > 0 ? max(0, first_pos - window + 1) : 0;
  const int t_lo = k_lo / W_ROWS;
  // short_tiles > 0 only for a planted fault: that many tiles left out
  const int n = k_hi > k_lo
                    ? max(0, (k_hi + W_ROWS - 1) / W_ROWS - t_lo - short_tiles)
                    : 0;
  const bool resident = n <= W_STAGES;
  const int n_loads = resident ? n : 2 * n;
  // load step s: pass 1 reads K tile s, pass 2 K and V tile s - n
  auto slot = [&](int s) {
    const int j = s < n ? s : s - n;
    return ring + (resident ? j : s % W_STAGES) * (T + TVB);
  };
  auto load = [&](int s) {
    const int kt0 = (t_lo + (s < n ? s : s - n)) * W_ROWS;
    unsigned char* st = slot(s);
    stage_sw<HD>(st, kb, kstride, kt0, k_lo, k_hi, tid);
    if (resident || s >= n)
      stage_sw<HDV>(st + T, vb, vstride, kt0, k_lo, k_hi, tid);
  };

  stage_sw<HD>(sQ, q + qhead, qstride, q0, 0, Sq, tid);
  stage_sw<HDV>(sDO, dout + ohead, ostride, q0, 0, Sq, tid);
#pragma unroll
  for (int s = 0; s < W_STAGES - 1; ++s) {
    if (s < n_loads) load(s);
    cp_async_commit();  // possibly empty: every thread counts alike
  }
  {  // D = rowsum(dout out), two threads a row
    const int r = tid / 2, half = tid % 2;
    float acc = 0.f;
    if (q0 + r < Sq) {
      const size_t off = ohead + (q0 + r) * ostride + half * (HDV / 2);
#pragma unroll
      for (int d = 0; d < HDV / 2; d += 8) {
        const Vec<bf16, 8> x = load_vec<bf16, 8>(dout + off + d);
        const Vec<bf16, 8> y = load_vec<bf16, 8>(out + off + d);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc += to_float(x.v[e]) * to_float(y.v[e]);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) sD[r] = acc;
  }

  const float sl2 = scale * kLog2e;
  const int row0 = q0 + warp * 16 + lane / 4;
  // the keys [klo, khi) row0 + 8 r can see: the mask as two compares
  int klo[2], khi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = row0 + 8 * r + q_offset;
    klo[r] = window > 0 ? pos - window + 1 : 0;
    khi[r] = causal ? min(Sk, pos + 1) : Sk;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float lse2[2] = {INFINITY, INFINITY}, dl[2] = {0.f, 0.f};
  auto finish_stats = [&]() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      lse2[r] = l[r] > 0.f ? m[r] * sl2 + log2f(l[r]) : INFINITY;  // no key
      dl[r] = sD[warp * 16 + lane / 4 + 8 * r];
    }
  };
  float dqa[TL::HDP / 2];
#pragma unroll
  for (int i = 0; i < TL::HDP / 2; ++i) dqa[i] = 0.f;
  unsigned dsa[4][4];  // dS of the last step, read by its dQ product

  for (int s = 0; s < 2 * n; ++s) {
    cp_async_wait<W_STAGES - 2>();
    wgmma_wait<0>();  // the last step's dQ product, issued unawaited
    fence_regs(dsa);
    fence_regs(dqa);
    fence_proxy_async();  // the landed tiles, to wgmma's async proxy
    // step s has landed; step s - 1's stage is consumed (every warp's
    // products of it are done), so it takes the load of step s +
    // W_STAGES - 1, issued under this step's first products
    __syncthreads();
    if (s == n) finish_stats();
    const bool pass2 = s >= n;
    const int kt0 = (t_lo + (pass2 ? s - n : s)) * W_ROWS;
    const unsigned char* sK = slot(s);
    const unsigned char* sV = sK + T;
    // every (row, key) pair of the tile visible: no mask to compute
    const bool full = kt0 + W_ROWS <= k_hi &&
                      (!causal || first_pos >= kt0 + W_ROWS - 1) &&
                      (window <= 0 || first_pos + W_ROWS - 1 - kt0 < window);

    float sa[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TL::KS; ++kk)
      wgmma_ss<64>(sa, desc_k(sQ, kk), desc_k(sK, kk), kk > 0);
    if (pass2) {
#pragma unroll
      for (int kk = 0; kk < TV::KS; ++kk)
        wgmma_ss<64>(dp, desc_k(sDO, kk), desc_k(sV, kk), kk > 0);
    }
    wgmma_commit();
    if (s + W_STAGES - 1 < n_loads) load(s + W_STAGES - 1);
    cp_async_commit();
    wgmma_wait<0>();
    fence_regs(sa);
    const int kc = kt0 + 2 * (lane & 3);  // this thread's first key
    if (!pass2) {  // each row's max and sum in base 2 (the online form)
      auto stats = [&](auto full_tile) {
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kc + 8 * t + (e & 1), r = e >> 1;
            if (!decltype(full_tile)::value &&
                !(key >= klo[r] && key < khi[r]))
              sa[4 * t + e] = -INFINITY;
            mx[r] = fmaxf(mx[r], sa[4 * t + e]);
          }
        float base[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          base[r] = mx[r] == -INFINITY ? 0.f : mx[r] * sl2;
          l[r] *= exp2_approx(m[r] * sl2 - base[r]);
          m[r] = mx[r];
        }
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            l[e >> 1] += exp2_approx(fmaf(sa[4 * t + e], sl2, -base[e >> 1]));
      };
      if (full)
        stats(std::true_type{});
      else
        stats(std::false_type{});
      continue;
    }
    fence_regs(dp);
    auto grad_s = [&](auto full_tile) {  // dS = P (dP - D)
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kc + 8 * t + (e & 1), r = e >> 1;
          const float p = exp2_approx(fmaf(sa[4 * t + e], sl2, -lse2[r]));
          const bool vis = decltype(full_tile)::value ||
                           (key >= klo[r] && key < khi[r]);
          sa[4 * t + e] = vis ? p * (dp[4 * t + e] - dl[r]) : 0.f;
        }
    };
    if (full)
      grad_s(std::true_type{});
    else
      grad_s(std::false_type{});
    acc_to_a(dsa, sa);  // dS rounded to bf16
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tb<TL::HDP>(dqa, dsa[kk], desc_mn(sK, kk));
    wgmma_commit();  // awaited at the next step's top (or below)
  }
  wgmma_wait<0>();
  fence_regs(dsa);
  fence_regs(dqa);
  cp_async_wait<0>();
  if (n == 0) {
    __syncthreads();  // sD is written
    finish_stats();
  }
  // dQ through shared memory (the ring is read no more), so the device
  // memory sees whole rows in 16-byte pieces
  bf16* tile = reinterpret_cast<bf16*>(ring);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<unsigned*>(tile + (row - q0) * (HD + 8) + 8 * j +
                                   2 * (lane & 3)) =
          pack_bf16x2(dqa[4 * j + 2 * r] * scale,
                      dqa[4 * j + 2 * r + 1] * scale);
    if ((lane & 3) == 0 && row < Sq) {
      const size_t si = (static_cast<size_t>(b) * H + h) * Sq + row;
      lse[si] = lse2[r];
      delta[si] = dl[r];
    }
  }
  __syncthreads();
  copy_rows_out<HD>(dq + qhead + q0 * qstride, qstride, tile,
                    min(W_ROWS, Sq - q0), tid);
}

// The sum over a cluster: fp32 [2][split][rp][HDP + 4] (dK, dV), the
// shares a block receives (split rp = split ceil(64 / split) <= 70 rows).
template <int HD>
constexpr int red_bytes() {
  return 2 * RECV_ROWS * (WTile<HD>::HDP + 4) * 4;
}

template <int HD, int HDV>
constexpr int dkdv_ring_bytes() {
  return W_STAGES * (WTile<HD>::BYTES + WTile<HDV>::BYTES + 2 * W_ROWS * 4);
}

// dynamic shared memory of launch B: K, V and the ring, or, where the
// group is split (hd_v = hd only), the larger of the ring and the sum's
// buffers
template <int HD, int HDV>
constexpr int dkdv_wgmma_smem(bool split) {
  return WTile<HD>::BYTES + WTile<HDV>::BYTES +
         (split && red_bytes<HD>() > dkdv_ring_bytes<HD, HDV>()
              ? red_bytes<HD>()
              : dkdv_ring_bytes<HD, HDV>()) +
         1024;
}

// Launch B in bf16 by wgmma: block (split c, key tile, b * Hkv + hk); the
// warpgroup owns keys k0 + [0, 64) (this thread's key0 and key0 + 8) and
// walks query heads [c hp, (c + 1) hp) of the group (hp = heads_per) and,
// for each, the 64-row query tiles that can see its keys, Q and dO (and
// their rows' lse and D) streaming through a ring of W_STAGES stages.  Per
// tile: S^T = K Q^T and dP^T = V dO^T (both operands in shared memory),
// P^T and dS^T = P^T (dP^T - D) in fp32, then dV += P_v^T dO and dK +=
// dS^T Q with P_v and dS rounded to bf16 from the registers, dO and Q read
// MN-major from the tiles the first two products read K-major.  The
// gridDim.x blocks of a unit form a thread block cluster: each writes its
// fp32 dK and dV to its shared memory, and block c sums its share of the
// rows over the cluster's blocks in block order (distributed shared
// memory), so the split needs neither atomics nor a third launch; it is
// taken only where hd_v = hd.  The products over q and k run at HD, those
// over v and dO at HDV.
template <int HD, int HDV>
__global__ void __launch_bounds__(W_THREADS, HD <= 64 ? 3 : 2)
    flash_bwd_dkdv_wgmma_kernel(const bf16* __restrict__ q,
                                const bf16* __restrict__ k,
                                const bf16* __restrict__ v,
                                const bf16* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                bf16* __restrict__ dk, bf16* __restrict__ dv,
                                int Sq, int Sk, int H, int Hkv, int causal,
                                int window, float scale, int q_offset,
                                int heads_per) {
  using TL = WTile<HD>;
  using TV = WTile<HDV>;
  constexpr int T = TL::BYTES, TVB = TV::BYTES;
  constexpr int ND = TL::HDP / 2, NDV = TV::HDP / 2;
  extern __shared__ __align__(16) unsigned char fbw_smem[];
  unsigned char* sK = align1024(fbw_smem);
  unsigned char* sV = sK + T;
  unsigned char* ring = sV + TVB;
  float* sLD = reinterpret_cast<float*>(ring + W_STAGES * (T + TVB));

  const int G = H / Hkv, split = gridDim.x;
  const int g0 = min(G, static_cast<int>(blockIdx.x) * heads_per);
  const int g1 = min(G, g0 + heads_per);
  const int b = blockIdx.z / Hkv, hk = blockIdx.z % Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.y * W_ROWS, k1 = min(Sk, k0 + W_ROWS);
  const size_t qstride = static_cast<size_t>(H) * HD;
  const size_t ostride = static_cast<size_t>(H) * HDV;
  const size_t kstride = static_cast<size_t>(Hkv) * HD;
  const size_t vstride = static_cast<size_t>(Hkv) * HDV;
  const size_t khead = (static_cast<size_t>(b) * Sk * Hkv + hk) * HD;
  const size_t vhead = (static_cast<size_t>(b) * Sk * Hkv + hk) * HDV;
  // the query rows that can see some key of the block
  const int i_lo = causal ? max(0, k0 - q_offset) : 0;
  const int i_hi = window > 0 ? min(Sq, k1 - 1 + window - q_offset) : Sq;
  const int nq = i_hi > i_lo ? (i_hi - i_lo + W_ROWS - 1) / W_ROWS : 0;
  const int steps = (g1 - g0) * nq;

  auto load = [&](int s) {
    const int h = hk * G + g0 + s / nq, i0 = i_lo + (s % nq) * W_ROWS;
    unsigned char* st = ring + (s % W_STAGES) * (T + TVB);
    const size_t qhead = (static_cast<size_t>(b) * Sq * H + h) * HD;
    const size_t ohead = (static_cast<size_t>(b) * Sq * H + h) * HDV;
    stage_sw<HD>(st, q + qhead, qstride, i0, 0, Sq, tid);
    stage_sw<HDV>(st + T, dout + ohead, ostride, i0, 0, Sq, tid);
    // lse (threads 0-63) and D (64-127) of the tile's rows; zeros past Sq
    const int row = i0 + tid % W_ROWS;
    const float* src = (tid < W_ROWS ? lse : delta) +
                       (static_cast<size_t>(b) * H + h) * Sq;
    cp_async4(sLD + (s % W_STAGES) * 2 * W_ROWS + tid,
              row < Sq ? src + row : src, row < Sq);
  };

  stage_sw<HD>(sK, k + khead, kstride, k0, 0, Sk, tid);
  stage_sw<HDV>(sV, v + vhead, vstride, k0, 0, Sk, tid);
  cp_async_commit();
  // launch A's lse and D are written from here on (K and V, which it does
  // not write, are already on their way)
  grid_dependency_wait();
#pragma unroll
  for (int s = 0; s < W_STAGES - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  const float sl2 = scale * kLog2e;
  const int key0 = k0 + warp * 16 + lane / 4;
  // the query rows [rlo, rhi) that see key0 + 8 r: the mask as two compares
  int rlo[2], rhi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    rlo[r] = causal ? key - q_offset : 0;
    rhi[r] = key >= Sk ? rlo[r]
                       : window > 0 ? min(Sq, key - q_offset + window) : Sq;
  }
  float dka[ND], dva[NDV];
#pragma unroll
  for (int i = 0; i < ND; ++i) dka[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NDV; ++i) dva[i] = 0.f;
  unsigned pa[4][4], da[4][4];  // the last step's P_v and dS, still read

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<W_STAGES - 2>();
    wgmma_wait<0>();  // the last step's dV and dK products, issued unawaited
    fence_regs(pa);
    fence_regs(da);
    fence_regs(dka);
    fence_regs(dva);
    fence_proxy_async();
    __syncthreads();
    const unsigned char* sQ = ring + (s % W_STAGES) * (T + TVB);
    const unsigned char* sDO = sQ + T;
    const float* sL = sLD + (s % W_STAGES) * 2 * W_ROWS;
    const int i0 = i_lo + (s % nq) * W_ROWS;
    // every (row, key) pair of the tile visible: no mask to compute
    const bool full = i0 + W_ROWS <= Sq && k0 + W_ROWS <= Sk &&
                      (!causal || i0 + q_offset >= k0 + W_ROWS - 1) &&
                      (window <= 0 ||
                       i0 + W_ROWS - 1 + q_offset - k0 < window);

    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TL::KS; ++kk)
      wgmma_ss<64>(st, desc_k(sK, kk), desc_k(sQ, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < TV::KS; ++kk)
      wgmma_ss<64>(dpt, desc_k(sV, kk), desc_k(sDO, kk), kk > 0);
    wgmma_commit();
    // the next tile loads under this one's products
    if (s + W_STAGES - 1 < steps) load(s + W_STAGES - 1);
    cp_async_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    const int rc = i0 + 2 * (lane & 3);  // this thread's first query row
    auto prob = [&](auto full_tile) {  // P^T and dS^T = P^T (dP^T - D)
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * t + 2 * (lane & 3) + (e & 1), r = e >> 1;
          const int row = rc + 8 * t + (e & 1);
          const float p = exp2_approx(fmaf(st[4 * t + e], sl2, -sL[col]));
          const bool vis = decltype(full_tile)::value ||
                           (row >= rlo[r] && row < rhi[r]);
          st[4 * t + e] = vis ? p : 0.f;
          dpt[4 * t + e] =
              vis ? p * (dpt[4 * t + e] - sL[W_ROWS + col]) : 0.f;
        }
    };
    if (full)
      prob(std::true_type{});
    else
      prob(std::false_type{});
    acc_to_a(pa, st);   // P_v: P rounded to bf16, as the forward's PV
    acc_to_a(da, dpt);  // dS rounded to bf16
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tb<TV::HDP>(dva, pa[kk], desc_mn(sDO, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tb<TL::HDP>(dka, da[kk], desc_mn(sQ, kk));
    wgmma_commit();  // awaited at the next step's top (or below)
  }
  wgmma_wait<0>();
  fence_regs(pa);
  fence_regs(da);
  fence_regs(dka);
  fence_regs(dva);
  cp_async_wait<0>();

  __syncthreads();  // every warp is past its last read of the ring
  if (HD != HDV || split == 1) {  // dK and dV through shared memory, as
                                  // launch A's dQ
    bf16* tk = reinterpret_cast<bf16*>(ring);
    bf16* tv = tk + W_ROWS * (HD + 8);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r - k0;
      const int at = 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<unsigned*>(tk + key * (HD + 8) + at + 8 * j) =
            pack_bf16x2(dka[4 * j + 2 * r] * scale,
                        dka[4 * j + 2 * r + 1] * scale);
#pragma unroll
      for (int j = 0; j < HDV / 8; ++j)
        *reinterpret_cast<unsigned*>(tv + key * (HDV + 8) + at + 8 * j) =
            pack_bf16x2(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
    }
    __syncthreads();
    const int rows = min(W_ROWS, Sk - k0);
    copy_rows_out<HD>(dk + khead + k0 * kstride, kstride, tk, rows, tid);
    copy_rows_out<HDV>(dv + vhead + k0 * vstride, vstride, tv, rows, tid);
    return;
  }
  // The split's sum: block c of the cluster owns rows [c rp, (c + 1) rp)
  // of the tile's dK and dV.  Every block lays its fp32 share of dK (then
  // of dV) out in its shared memory (where K and V were) and stores it,
  // whole rows a warp and 16 bytes a thread, into each row's owner's
  // shared memory (its own slot there: stores, no round trip); then each
  // owner adds its rows' slots in block order.
  constexpr int RS = TL::HDP + 4;
  constexpr int V4 = HD / 4;  // float4s a row
  const int rp = (W_ROWS + split - 1) / split;
  const int rank = static_cast<int>(blockIdx.x);  // = the cluster rank
  float* recv = reinterpret_cast<float*>(ring);   // [2][split][rp][RS]
  // [64][HDP] fp32, float4 q of row r at q ^ (r % 8): a warp's pair
  // stores below spread over the banks
  float* mine = reinterpret_cast<float*>(sK);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block is past its ring: free to receive
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const float* a = which == 0 ? dka : dva;
    if (which == 1) __syncthreads();  // dK's share is sent
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + lane / 4 + 8 * r;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int c = 8 * j + 2 * (lane & 3);
        *reinterpret_cast<float2*>(mine + row * TL::HDP +
                                   (c ^ ((row & 7) << 2))) =
            make_float2(a[4 * j + 2 * r], a[4 * j + 2 * r + 1]);
      }
    }
    __syncthreads();
    for (int i = tid; i < W_ROWS * V4; i += W_THREADS) {
      const int row = i / V4, c = (i % V4) * 4, owner = row / rp;
      *reinterpret_cast<float4*>(
          cluster.map_shared_rank(recv, owner) +
          ((which * split + rank) * rp + row - owner * rp) * RS + c) =
          *reinterpret_cast<const float4*>(mine + row * TL::HDP +
                                           (c ^ ((row & 7) << 2)));
    }
  }
  cluster.sync();  // every share is in its owner's shared memory
  const int r_lo = rank * rp;
  const int n_rows = max(0, min(min(W_ROWS, r_lo + rp), Sk - k0) - r_lo);
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const float mul = which == 0 ? scale : 1.f;
    bf16* o = (which == 0 ? dk : dv) + khead + (k0 + r_lo) * kstride;
    for (int i = tid; i < n_rows * V4; i += W_THREADS) {
      const int rr = i / V4, c = (i % V4) * 4;
      const float* at = recv + (which * split * rp + rr) * RS + c;
      float4 acc = *reinterpret_cast<const float4*>(at);
      for (int src = 1; src < split; ++src) {
        const float4 x = *reinterpret_cast<const float4*>(at + src * rp * RS);
        acc.x += x.x, acc.y += x.y, acc.z += x.z, acc.w += x.w;
      }
      *reinterpret_cast<uint2*>(o + rr * kstride + c) =
          make_uint2(pack_bf16x2(acc.x * mul, acc.y * mul),
                     pack_bf16x2(acc.z * mul, acc.w * mul));
    }
  }
}

template <int HD, int HDV>
int launch_wgmma(const void* q, const void* k, const void* v, const void* out,
                 const void* dout, void* dq, void* dk, void* dv, void* lse,
                 void* delta, int B, int Sq, int Sk, int H, int Hkv,
                 int causal, int window, float scale, int q_offset,
                 int short_tiles, int heads_per, cudaStream_t s) {
  constexpr int smem_a = dq_wgmma_smem<HD, HDV>();
  constexpr int smem_b = dkdv_wgmma_smem<HD, HDV>(HD == HDV);
  // above 48 KB only by request, made once before the first launch
  static const cudaError_t attr_a = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<HD, HDV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
  static const cudaError_t attr_b = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma_kernel<HD, HDV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_b);
  if (attr_a != cudaSuccess) return static_cast<int>(attr_a);
  if (attr_b != cudaSuccess) return static_cast<int>(attr_b);
  const int G = H / Hkv;
  if (heads_per < 1 || heads_per > G)
    return static_cast<int>(cudaErrorInvalidValue);
  const int split = (G + heads_per - 1) / heads_per;
  if (split > BWD_MAX_SPLIT || (HD != HDV && split > 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 ga((Sq + W_ROWS - 1) / W_ROWS, B * H);
  flash_bwd_dq_wgmma_kernel<HD, HDV><<<ga, W_THREADS, smem_a, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq),
      static_cast<float*>(lse), static_cast<float*>(delta), Sq, Sk, H, Hkv,
      causal, window, scale, q_offset, short_tiles);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (Sk + W_ROWS - 1) / W_ROWS, B * Hkv);
  cfg.blockDim = dim3(W_THREADS);
  cfg.dynamicSmemBytes = dkdv_wgmma_smem<HD, HDV>(split > 1);
  cfg.stream = s;
  // programmatic stream serialization: launch B's blocks may start (and
  // load K and V) while launch A's last blocks run; a split's blocks form
  // one cluster
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = split;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = split > 1 ? 2 : 1;
  const cudaError_t err_b = cudaLaunchKernelEx(
      &cfg, flash_bwd_dkdv_wgmma_kernel<HD, HDV>, static_cast<const bf16*>(q),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Sq, Sk, H, Hkv, causal, window, scale,
      q_offset, heads_per);
  if (err_b != cudaSuccess) return static_cast<int>(err_b);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD, int HDV>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, void* dq, void* dk, void* dv, void* lse,
           void* delta, int B, int Sq, int Sk, int H, int Hkv, int causal,
           int window, float scale, int q_offset, int short_tiles,
           int heads_per, cudaStream_t s) {
  if constexpr (sizeof(T) == 2 && HD >= 64) {
    return launch_wgmma<HD, HDV>(q, k, v, out, dout, dq, dk, dv, lse, delta, B,
                                 Sq, Sk, H, Hkv, causal, window, scale,
                                 q_offset, short_tiles, heads_per, s);
  } else if constexpr (sizeof(T) == 2) {
    static_assert(HD == HDV, "mma.sync backward: hd_v = hd");
    return launch_mma<HD>(q, k, v, out, dout, dq, dk, dv, lse, delta, B, Sq,
                          Sk, H, Hkv, causal, window, scale, q_offset,
                          short_tiles, s);
  } else {
    const dim3 ga((Sq + A_ROWS - 1) / A_ROWS, B * H);
    flash_bwd_dq_f32_kernel<T, HD, HDV><<<ga, A_WARPS * 32, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(out),
        static_cast<const T*>(dout), static_cast<T*>(dq),
        static_cast<float*>(lse), static_cast<float*>(delta), Sq, Sk, H, Hkv,
        causal, window, scale, q_offset, short_tiles);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 gb((Sk + B_WARPS - 1) / B_WARPS, B * Hkv);
    flash_bwd_dkdv_f32_kernel<T, HD, HDV><<<gb, B_WARPS * 32, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, Hkv, causal,
        window, scale, q_offset);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int launch_hd(int hd, int hd_v, const void* q, const void* k, const void* v,
              const void* out, const void* dout, void* dq, void* dk,
              void* dv, void* lse, void* delta, int B, int Sq, int Sk, int H,
              int Hkv, int causal, int window, float scale, int q_offset,
              int short_tiles, int heads_per, cudaStream_t s) {
#define REPRO_FLASH_BWD(HD, HDV)                                             \
  if (hd == HD && hd_v == HDV)                                               \
    return launch<T, HD, HDV>(q, k, v, out, dout, dq, dk, dv, lse, delta, B, \
                              Sq, Sk, H, Hkv, causal, window, scale,        \
                              q_offset, short_tiles, heads_per, s);
  REPRO_FLASH_BWD(16, 16)
  REPRO_FLASH_BWD(32, 32)
  REPRO_FLASH_BWD(64, 64)
  REPRO_FLASH_BWD(96, 96)
  REPRO_FLASH_BWD(128, 128)
  REPRO_FLASH_BWD(192, 128)
#undef REPRO_FLASH_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// lse, delta: [B, H, Sq] fp32 scratch (written by launch A, read by
// launch B).  bf16 tensors start on 16-byte boundaries (cp.async).
// heads_per: the query heads of a group one launch-B block walks (bf16 at
// hd >= 64; the plan's, 1 to G, at most 8 blocks a group; G where hd_v !=
// hd).  short_tiles > 0 only plants a fault for the checks: launch A then
// walks that many fewer K tiles.
extern "C" int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    int B, int Sq, int Sk, int H, int Hkv, int hd, int hd_v, int causal,
    int window, float scale, int q_offset, int short_tiles, int heads_per,
    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv < 1 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32)
    return launch_hd<float>(hd, hd_v, q, k, v, out, dout, dq, dk, dv, lse,
                            delta, B, Sq, Sk, H, Hkv, causal, window, scale,
                            q_offset, short_tiles, heads_per, s);
  if (dtype == kBFloat16)
    return launch_hd<bf16>(hd, hd_v, q, k, v, out, dout, dq, dk, dv, lse,
                           delta, B, Sq, Sk, H, Hkv, causal, window, scale,
                           q_offset, short_tiles, heads_per, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
