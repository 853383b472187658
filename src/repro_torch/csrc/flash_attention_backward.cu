// Gradient of GQA prefill attention (csrc/flash_attention.cu): given q, k,
// v, the forward's out and dout = dL/dout, it writes dq, dk and dv.
//
//   q, dq [B, Sq, H, hd]; k, v, dk, dv [B, Sk, Hkv, hd]; out, dout
//   [B, Sq, H, hd]; all contiguous, one dtype (fp32 or bf16).  Query i sits
//   at position pq = i + q_offset, key j at pk = j; causal keeps pq >= pk,
//   a window keeps pq - pk < window; query head h reads KV head
//   h / (H / Hkv).  hd is 16, 32, 64, 96 or 128 (hd_v = hd).
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
// tile of keys), walks the G query heads of its KV head and, for each,
// the query tiles that can see its keys, and sums dk and dv over them in
// a fixed order: no atomics, so a step is deterministic.
// What bounds it on the H100: at the train step's shapes (S = 128) the
// tensor-core work of each block and per-block latency, not bytes; it
// does five products over the visible pairs where the forward does two.
//   * bf16 (the trained path) runs every product on the tensor cores
//     (mma.sync m16n8k16, bf16 in, fp32 accumulate, fragments by ldmatrix
//     as in the forward).  Launch A: a block of 4 warps owns 64 query
//     rows, 16 a warp, whose Q fragments stay in registers; each K (and
//     V) tile of 64 keys is staged in shared memory by cp.async.  Pass 1
//     forms S = Q K^T for the row max and sum; pass 2 forms S and dP = dO
//     V^T again, dS = P (dP - D) in fp32 registers, and dQ += dS K with dS
//     handed from the accumulator to the A operand in registers (rounded
//     to bf16, as FlashAttention-2 does).  Launch B: a block of 2 warps
//     owns 32 keys, 16 a warp; per query head of the group and tile of 32
//     query rows (Q, dO and their statistics staged by cp.async) it forms
//     S^T = K Q^T and dP^T = V dO^T, then dV += P_v^T dO and dK += dS^T Q,
//     both accumulated in fp32 registers.
//   * fp32 (the parity path) keeps CUDA cores, as the forward's fp32 path
//     does (TF32 could not meet the fp32 limit): a warp per query row
//     (launch A) or per key (launch B), each lane holding dims lane + 32 t,
//     dot products summed by warp shuffles.
// wgmma with TMA-fed tiles, and a split of the dK/dV walk over the group's
// heads across blocks, are the steps after this one.
#include "common.cuh"

namespace {

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

template <typename T, int HD>
__global__ void __launch_bounds__(A_WARPS * 32)
    flash_bwd_dq_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ out,
                        const T* __restrict__ dout, T* __restrict__ dq,
                        float* __restrict__ lse, float* __restrict__ delta,
                        int Sq, int Sk, int H, int Hkv, int causal,
                        int window, float scale, int q_offset,
                        int short_tiles) {
  constexpr int DPL = (HD + 31) / 32;
  __shared__ float ks[BK * HD];
  __shared__ float vs[BK * HD];
  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / (H / Hkv);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int i0 = blockIdx.x * A_ROWS;
  const size_t qstride = static_cast<size_t>(H) * HD;
  const size_t kstride = static_cast<size_t>(Hkv) * HD;
  const T* kb = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * HD;
  const T* vb = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * HD;

  float qr[A_RPW][DPL], dor[A_RPW][DPL], dqr[A_RPW][DPL];
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
    for (int t = 0; t < DPL; ++t) qr[r][t] = dor[r][t] = dqr[r][t] = 0.f;
    if (live[r]) {
      const size_t off = (static_cast<size_t>(b) * Sq + i) * qstride + h * HD;
      float outr[DPL];
      load_row<T, HD>(q + off, lane, qr[r]);
      load_row<T, HD>(dout + off, lane, dor[r]);
      load_row<T, HD>(out + off, lane, outr);
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < DPL; ++t) s += dor[r][t] * outr[t];
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
    stage<T, HD>(vs, vb, j0, n, BK, kstride);
    __syncthreads();
#pragma unroll 2
    for (int jj = 0; jj < n; ++jj) {
      const float* kr = ks + jj * HD;
      float s[A_RPW], dp[A_RPW];
#pragma unroll
      for (int r = 0; r < A_RPW; ++r) {
        s[r] = warp_sum(lane_dot<HD>(qr[r], kr, lane)) * scale;
        dp[r] = warp_sum(lane_dot<HD>(dor[r], vs + jj * HD, lane));
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

template <typename T, int HD>
__global__ void __launch_bounds__(B_WARPS * 32)
    flash_bwd_dkdv_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int Sq,
                          int Sk, int H, int Hkv, int causal, int window,
                          float scale, int q_offset) {
  constexpr int DPL = (HD + 31) / 32;
  __shared__ float qs[BQ * HD];
  __shared__ float dos[BQ * HD];
  __shared__ float ls[BQ], dls[BQ];
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv, G = H / Hkv;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int j0 = blockIdx.x * B_WARPS, j = j0 + warp;
  const bool live = j < Sk;
  const size_t qstride = static_cast<size_t>(H) * HD;
  const size_t koff = (static_cast<size_t>(b) * Sk + j) * Hkv * HD + hk * HD;

  float kr[DPL], vr[DPL], dkr[DPL], dvr[DPL];
#pragma unroll
  for (int t = 0; t < DPL; ++t) kr[t] = vr[t] = dkr[t] = dvr[t] = 0.f;
  if (live) {
    load_row<T, HD>(k + koff, lane, kr);
    load_row<T, HD>(v + koff, lane, vr);
  }
  // the query rows that can see some key of the block
  const int j1 = min(Sk, j0 + B_WARPS);
  const int i_lo = causal ? max(0, j0 - q_offset) : 0;
  const int i_hi = window ? min(Sq, j1 - 1 + window - q_offset) : Sq;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const T* qb = q + static_cast<size_t>(b) * Sq * qstride + h * HD;
    const T* dob = dout + static_cast<size_t>(b) * Sq * qstride + h * HD;
    const size_t sb = (static_cast<size_t>(b) * H + h) * Sq;
    for (int i0 = i_lo; i0 < i_hi; i0 += BQ) {
      const int n = min(BQ, i_hi - i0);
      __syncthreads();
      stage<T, HD>(qs, qb, i0, n, BQ, qstride);
      stage<T, HD>(dos, dob, i0, n, BQ, qstride);
      if (threadIdx.x < BQ) {
        ls[threadIdx.x] = threadIdx.x < n ? lse[sb + i0 + threadIdx.x] : 0.f;
        dls[threadIdx.x] = threadIdx.x < n ? delta[sb + i0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int ii = 0; ii < n; ++ii) {
        const float* qrow = qs + ii * HD;
        const float* drow = dos + ii * HD;
        const float s = warp_sum(lane_dot<HD>(kr, qrow, lane)) * scale;
        const float dp = warp_sum(lane_dot<HD>(vr, drow, lane));
        if (live && visible(i0 + ii + q_offset, j, causal, window)) {
          const float p = expf(s - ls[ii]);
          const float pv = to_float(from_float<T>(p));  // P_v, as in the forward
          const float ds = p * (dp - dls[ii]);
#pragma unroll
          for (int t = 0; t < DPL; ++t) {
            const int d = lane + 32 * t;
            if (HD % 32 == 0 || d < HD) {
              dvr[t] += pv * drow[d];
              dkr[t] += ds * qrow[d];
            }
          }
        }
      }
    }
  }
  if (live) {
    store_row<T, HD>(dk + koff, lane, dkr, scale);
    store_row<T, HD>(dv + koff, lane, dvr, 1.f);
  }
}

// ------------------------------------------------ bf16: tensor cores --
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

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, void* dq, void* dk, void* dv, void* lse,
           void* delta, int B, int Sq, int Sk, int H, int Hkv, int causal,
           int window, float scale, int q_offset, int short_tiles,
           cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {
    return launch_mma<HD>(q, k, v, out, dout, dq, dk, dv, lse, delta, B, Sq,
                          Sk, H, Hkv, causal, window, scale, q_offset,
                          short_tiles, s);
  } else {
    const dim3 ga((Sq + A_ROWS - 1) / A_ROWS, B * H);
    flash_bwd_dq_f32_kernel<T, HD><<<ga, A_WARPS * 32, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(out),
        static_cast<const T*>(dout), static_cast<T*>(dq),
        static_cast<float*>(lse), static_cast<float*>(delta), Sq, Sk, H, Hkv,
        causal, window, scale, q_offset, short_tiles);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 gb((Sk + B_WARPS - 1) / B_WARPS, B * Hkv);
    flash_bwd_dkdv_f32_kernel<T, HD><<<gb, B_WARPS * 32, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, Hkv, causal,
        window, scale, q_offset);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const void* out, const void* dout, void* dq, void* dk,
              void* dv, void* lse, void* delta, int B, int Sq, int Sk, int H,
              int Hkv, int causal, int window, float scale, int q_offset,
              int short_tiles, cudaStream_t s) {
#define REPRO_FLASH_BWD(HD)                                                  \
  case HD:                                                                   \
    return launch<T, HD>(q, k, v, out, dout, dq, dk, dv, lse, delta, B, Sq, \
                         Sk, H, Hkv, causal, window, scale, q_offset,        \
                         short_tiles, s);
  switch (hd) {
    REPRO_FLASH_BWD(16)
    REPRO_FLASH_BWD(32)
    REPRO_FLASH_BWD(64)
    REPRO_FLASH_BWD(96)
    REPRO_FLASH_BWD(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_BWD
}

}  // namespace

// lse, delta: [B, H, Sq] fp32 scratch (written by launch A, read by
// launch B).  bf16 tensors start on 16-byte boundaries (cp.async).
// short_tiles > 0 only plants a fault for the checks: launch A then walks
// that many fewer K tiles.
extern "C" int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    int B, int Sq, int Sk, int H, int Hkv, int hd, int causal, int window,
    float scale, int q_offset, int short_tiles, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv < 1 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32)
    return launch_hd<float>(hd, q, k, v, out, dout, dq, dk, dv, lse, delta, B,
                            Sq, Sk, H, Hkv, causal, window, scale, q_offset,
                            short_tiles, s);
  if (dtype == kBFloat16)
    return launch_hd<bf16>(hd, q, k, v, out, dout, dq, dk, dv, lse,
                                    delta, B, Sq, Sk, H, Hkv, causal, window,
                                    scale, q_offset, short_tiles, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
