// Chunkwise mLSTM with the matrix memory carried across chunks.
//
//   q, k, v [B, S, nh, dh]; cumf, li [B, S, nh] fp32 (the forget-gate
//   log cumsum, restarted at every chunk of Q rows, and the bounded input
//   gate; S = nc * Q); y [B, S, nh, dh] fp32; C [B, nh, dh, dh] and
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
// (B, nc) carries C [nh, dh, dh] in VMEM: 1 MiB per head at xlstm-350m's
// dh = 512, far beyond a block's 227 KB of shared memory.  Here a block
// owns one (b, head) and a 64-wide tile of the value columns e, holds
// C[:, e-tile] (128 KB fp32 at dh = 512) and all of n in shared memory,
// and loops over the chunks in order: B * nh * dh / 64 blocks (32 at
// xlstm-350m's width per request).  Each block recomputes its head's
// scores q k^T and n, the same in every e-tile block (a known redundancy,
// dh / 64 = 8 times at xlstm-350m's width).
//
// What bounds it: at the card's bf16 tensor-core rate, bytes (one read of
// q, k, v and one write of y and the state); this kernel, in fp32 on the
// CUDA cores, is bound by its operations (the Q^2 dh score products,
// done once per e-tile).  The products run over 64x64 tiles in shared
// memory; every sum runs in a fixed order with no atomics, so two runs
// give identical bits.  Tensor cores (wgmma) and computing the scores
// once per head are later steps.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;   // rows per query/key tile, width of a d slice
constexpr int kE = 64;      // value columns per block
constexpr int kMaxQ = 256;
constexpr int kMaxDh = 512;

struct Smem {
  float q[kTile][kTile + 1];   // q rows of the query tile, one d slice
  float k[kTile][kTile + 1];   // k rows of the key tile, the same d slice
  float s[kTile][kTile + 1];   // masked, decayed scores of the tile pair
  float v[kTile][kE];          // v rows of the key tile, this e tile
  float cumf[kMaxQ];
  float li[kMaxQ];
  float den[kTile];            // the query tile's normalisers
  float n[kMaxDh];             // the carried n
  // followed by the carried C[d][e] (dh x kE floats)
};

template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int dst_ld,
                                          const T* src, size_t ld, int rows,
                                          int cols) {
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile, c = i % kTile;
    dst[r * dst_ld + c] =
        (r < rows && c < cols) ? to_float(src[r * ld + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mlstm_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ cumf,
                      const float* __restrict__ li, float* __restrict__ y,
                      float* __restrict__ C_out, float* __restrict__ n_out,
                      int nc, int Q, int nh, int dh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  float* Cs = reinterpret_cast<float*>(smem_raw + sizeof(Smem));  // [dh][kE]
  const int t = threadIdx.x;
  const int b = blockIdx.x / nh, hd = blockIdx.x % nh;
  const int e0 = blockIdx.y * kE;
  const int ew = min(kE, dh - e0);           // valid columns of this tile
  const size_t S = static_cast<size_t>(nc) * Q;
  const size_t ld = static_cast<size_t>(nh) * dh;
  // thread tiles: scores and outputs (tr + 16a, tc + 16c); state (cd + 4m, ce)
  const int tr = t / 16, tc = t % 16;
  const int cd = t / 64, ce = t % 64;

  for (int i = t; i < dh * kE; i += kThreads) Cs[i] = 0.f;
  for (int i = t; i < dh; i += kThreads) sm.n[i] = 0.f;

  for (int ch = 0; ch < nc; ++ch) {
    const size_t row0 = b * S + static_cast<size_t>(ch) * Q;
    const size_t off = row0 * ld + static_cast<size_t>(hd) * dh;
    const T* qc = q + off;
    const T* kc = k + off;
    const T* vc = v + off + e0;
    __syncthreads();  // the previous chunk is done with the gates and state
    for (int i = t; i < Q; i += kThreads) {
      sm.cumf[i] = cumf[(row0 + i) * nh + hd];
      sm.li[i] = li[(row0 + i) * nh + hd];
    }

    for (int i0 = 0; i0 < Q; i0 += kTile) {
      const int rows_i = min(kTile, Q - i0);
      // the carried-state terms, from (C, n) as they entered the chunk
      float acc[4][4] = {};
      float den = 0.f;  // thread t < kTile: query row t
      for (int d0 = 0; d0 < dh; d0 += kTile) {
        const int dw = min(kTile, dh - d0);
        load_tile(&sm.q[0][0], kTile + 1, qc + i0 * ld + d0, ld, rows_i, dw);
        __syncthreads();
        for (int d = 0; d < dw; ++d) {
          const float* crow = Cs + (d0 + d) * kE;
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float qv = sm.q[tr + 16 * a][d];
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[a][c] += qv * crow[tc + 16 * c];
          }
        }
        if (t < kTile)
          for (int d = 0; d < dw; ++d) den += sm.q[t][d] * sm.n[d0 + d];
        __syncthreads();
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = tr + 16 * a;
        const float e = r < rows_i ? expf(sm.cumf[i0 + r]) : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] *= e;
      }
      if (t < kTile) den *= t < rows_i ? expf(sm.cumf[i0 + t]) : 0.f;

      // the intra-chunk terms, key tiles up to the diagonal one
      for (int j0 = 0; j0 <= i0; j0 += kTile) {
        const int rows_j = min(kTile, Q - j0);
        float s[4][4] = {};
        for (int d0 = 0; d0 < dh; d0 += kTile) {
          const int dw = min(kTile, dh - d0);
          load_tile(&sm.q[0][0], kTile + 1, qc + i0 * ld + d0, ld, rows_i, dw);
          load_tile(&sm.k[0][0], kTile + 1, kc + j0 * ld + d0, ld, rows_j, dw);
          __syncthreads();
          for (int d = 0; d < dw; ++d) {
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              const float qv = sm.q[tr + 16 * a][d];
#pragma unroll
              for (int c = 0; c < 4; ++c) s[a][c] += qv * sm.k[tc + 16 * c][d];
            }
          }
          __syncthreads();
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + tr + 16 * a;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tc + 16 * c;
            const bool keep = j <= i && i < Q;   // causal; j <= i < Q
            sm.s[tr + 16 * a][tc + 16 * c] =
                keep ? s[a][c] * expf(sm.cumf[i] - sm.cumf[j] + sm.li[j])
                     : 0.f;
          }
        }
        load_tile(&sm.v[0][0], kE, vc + j0 * ld, ld, rows_j, ew);
        __syncthreads();
        for (int j = 0; j < rows_j; ++j) {
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float sv = sm.s[tr + 16 * a][j];
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[a][c] += sv * sm.v[j][tc + 16 * c];
          }
        }
        if (t < kTile)
          for (int j = 0; j < rows_j; ++j) den += sm.s[t][j];
        __syncthreads();  // sm.s and sm.v are refilled next
      }
      if (t < kTile) sm.den[t] = fmaxf(fabsf(den), 1.f);
      __syncthreads();
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = tr + 16 * a;
        if (r >= rows_i) continue;
        const float inv = sm.den[r];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int e = tc + 16 * c;
          if (e < ew) y[(row0 + i0 + r) * ld + hd * dh + e0 + e] =
              acc[a][c] / inv;
        }
      }
      // sm.den is rewritten only after the next tile's syncs
    }

    // the state leaving the chunk (every read of the old state is behind
    // the last __syncthreads of the tile loop)
    const float cl = sm.cumf[Q - 1];
    const float ecl = expf(cl);
    for (int d0 = 0; d0 < dh; d0 += kTile) {
      const int dw = min(kTile, dh - d0);
      float cr[16];
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const int d = cd + 4 * m;
        cr[m] = d < dw ? Cs[(d0 + d) * kE + ce] * ecl : 0.f;
      }
      float nr = t < dw ? sm.n[d0 + t] * ecl : 0.f;
      for (int j0 = 0; j0 < Q; j0 += kTile) {
        const int rows_j = min(kTile, Q - j0);
        // k rows scaled by their weight to the chunk's end
        for (int i = t; i < kTile * kTile; i += kThreads) {
          const int r = i / kTile, c = i % kTile;
          float val = 0.f;
          if (r < rows_j && c < dw)
            val = to_float(kc[(j0 + r) * ld + d0 + c]) *
                  expf(cl - sm.cumf[j0 + r] + sm.li[j0 + r]);
          sm.k[r][c] = val;
        }
        load_tile(&sm.v[0][0], kE, vc + j0 * ld, ld, rows_j, ew);
        __syncthreads();
        for (int j = 0; j < rows_j; ++j) {
          const float vv = sm.v[j][ce];
#pragma unroll
          for (int m = 0; m < 16; ++m) cr[m] += sm.k[j][cd + 4 * m] * vv;
        }
        if (t < kTile)
          for (int j = 0; j < rows_j; ++j) nr += sm.k[j][t];
        __syncthreads();
      }
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const int d = cd + 4 * m;
        if (d < dw) Cs[(d0 + d) * kE + ce] = cr[m];
      }
      if (t < dw) sm.n[d0 + t] = nr;
    }
  }

  __syncthreads();
  for (int i = t; i < dh * ew; i += kThreads) {
    const int d = i / ew, e = i % ew;
    C_out[((static_cast<size_t>(b) * nh + hd) * dh + d) * dh + e0 + e] =
        Cs[d * kE + e];
  }
  if (blockIdx.y == 0)
    for (int d = t; d < dh; d += kThreads)
      n_out[(static_cast<size_t>(b) * nh + hd) * dh + d] = sm.n[d];
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* cumf,
           const void* li, void* y, void* C, void* n, int B, int nc, int Q,
           int nh, int dh, cudaStream_t stream) {
  const int smem_max = static_cast<int>(sizeof(Smem)) + kMaxDh * kE * 4;
  static const cudaError_t attr = cudaFuncSetAttribute(  // once
      mlstm_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_max);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int smem = static_cast<int>(sizeof(Smem)) + dh * kE * 4;
  const dim3 grid(B * nh, (dh + kE - 1) / kE);
  mlstm_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(cumf),
      static_cast<const float*>(li), static_cast<float*>(y),
      static_cast<float*>(C), static_cast<float*>(n), nc, Q, nh, dh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mlstm_chunk_scan_launch(const void* q, const void* k,
                                       const void* v, const void* cumf,
                                       const void* li, void* y, void* C,
                                       void* n, int B, int nc, int Q, int nh,
                                       int dh, int dtype, void* stream) {
  if (Q < 1 || Q > kMaxQ || dh < 1 || dh > kMaxDh || nc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(q, k, v, cumf, li, y, C, n, B, nc, Q, nh, dh, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, cumf, li, y, C, n, B, nc, Q, nh, dh,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}
