// Mamba2 SSD chunk scan with the state carried across chunks.
//
//   xbar [B, S, nh, P] fp32; Bm, Cm [B, S, N]; cum [B, S, nh] fp32 (the
//   log-decay cumsum, restarted at every chunk of Q rows; S = nc * Q);
//   y [B, S, nh, P] fp32; state [B, nh, P, N] fp32, all contiguous.
//   For each chunk, with h the state entering it:
//     y_i = sum_{j<=i} (C_i . B_j) e^{cum_i - cum_j} xbar_j + e^{cum_i} C_i h
//     h  <- h e^{cum_last} + sum_j e^{cum_last - cum_j} xbar_j B_j^T
//
// Replaces repro/kernels/mamba_scan.py:mamba_chunk_scan_chunked (Pallas),
// whose grid (B, nc) folds every head into one program and carries
// h [nh, P, N] in VMEM: 1 MiB per batch row at zamba2's width, and with
// the server's B = 1 prefill the whole scan on one core.  Here a block
// owns one (b, head) and a 32-wide slice of P, so B * nh * P / 32 blocks
// (128 at zamba2's width) each loop over the chunks in order with their
// h [32, N] slice in shared memory; nothing carries between blocks.
//
// What bounds it: operations at zamba2's widths (Q^2 N + Q^2 P + 2 Q P N
// fused multiply-adds per (b, head, chunk) against one read of the inputs
// and one write of y).  C B^T is shared by all heads (one B/C group) but
// recomputed by every block: 64x64 tiles of queries and keys, N-deep
// products on the CUDA cores in fp32, the causal mask and the decay
// applied to each 64x64 score tile in shared memory.  Every sum runs in a
// fixed order with no atomics, so two runs give identical bits.  Tensor
// cores (wgmma) and keeping the scores once per (b, chunk) are later steps.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;   // query rows and key rows per tile
constexpr int kPT = 32;     // columns of P per block
constexpr int kMaxN = 64;
constexpr int kMaxQ = 256;

struct Smem {
  float c[kTile][kMaxN + 1];   // C rows of the query tile (+1: no bank clash)
  float b[kTile][kMaxN + 1];   // B rows of the key tile
  float s[kTile][kTile + 1];   // masked, decayed scores of the tile pair
  float x[kTile][kPT];         // xbar rows of the key tile, this P slice
  float h[kPT][kMaxN + 1];     // the carried state h[p][n]
  float cum[kMaxQ];            // this head's cum over the chunk
};

// rows x cols of src (row stride ld) into dst[kTile][dst_ld], zero-padded
// to kTile x width
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int dst_ld,
                                          const T* src, size_t ld, int rows,
                                          int cols, int width) {
  for (int i = threadIdx.x; i < kTile * width; i += kThreads) {
    const int r = i / width, c = i % width;
    dst[r * dst_ld + c] =
        (r < rows && c < cols) ? to_float(src[r * ld + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mamba_scan_kernel(const float* __restrict__ xbar, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, const float* __restrict__ cum,
                      float* __restrict__ y, float* __restrict__ state,
                      int nc, int Q, int nh, int P, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int t = threadIdx.x;
  const int b = blockIdx.x / nh, hd = blockIdx.x % nh;
  const int p0 = blockIdx.y * kPT;
  const int pw = min(kPT, P - p0);          // valid columns of this slice
  const size_t S = static_cast<size_t>(nc) * Q;
  const size_t xld = static_cast<size_t>(nh) * P;
  // thread tiles: scores (sr + 16a, sc + 16c); outputs and y (yr + 32a,
  // yp + 8c); state (hp + 4k, hn)
  const int sr = t / 16, sc = t % 16;
  const int yr = t / 8, yp = t % 8;
  const int hp = t / 64, hn = t % 64;

  for (int i = t; i < kPT * (kMaxN + 1); i += kThreads) (&sm.h[0][0])[i] = 0.f;

  for (int ch = 0; ch < nc; ++ch) {
    const size_t row0 = b * S + static_cast<size_t>(ch) * Q;
    const float* xb = xbar + row0 * xld + static_cast<size_t>(hd) * P + p0;
    const T* bm = Bm + row0 * N;
    const T* cm = Cm + row0 * N;
    __syncthreads();  // the previous chunk is done with sm.cum and sm.h
    for (int i = t; i < Q; i += kThreads) sm.cum[i] = cum[(row0 + i) * nh + hd];

    for (int i0 = 0; i0 < Q; i0 += kTile) {
      const int rows_i = min(kTile, Q - i0);
      load_tile(&sm.c[0][0], kMaxN + 1, cm + static_cast<size_t>(i0) * N, N,
                rows_i, N, kMaxN);
      __syncthreads();
      // the carried-state term, from h as it entered the chunk
      float acc[2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int r = yr + 32 * a;
        const float e = r < rows_i ? expf(sm.cum[i0 + r]) : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = yp + 8 * c;
          float s = 0.f;
          for (int n = 0; n < N; ++n) s += sm.c[r][n] * sm.h[p][n];
          acc[a][c] = e * s;
        }
      }
      // the intra-chunk term, key tiles up to the diagonal one
      for (int j0 = 0; j0 <= i0; j0 += kTile) {
        const int rows_j = min(kTile, Q - j0);
        load_tile(&sm.b[0][0], kMaxN + 1, bm + static_cast<size_t>(j0) * N,
                  N, rows_j, N, kMaxN);
        load_tile(&sm.x[0][0], kPT, xb + static_cast<size_t>(j0) * xld, xld,
                  rows_j, pw, kPT);
        __syncthreads();
        float s[4][4] = {};
        for (int n = 0; n < N; ++n) {
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float cv = sm.c[sr + 16 * a][n];
#pragma unroll
            for (int c = 0; c < 4; ++c) s[a][c] += cv * sm.b[sc + 16 * c][n];
          }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + sr + 16 * a;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + sc + 16 * c;
            const bool keep = j <= i && i < Q;   // causal; j <= i < Q
            sm.s[sr + 16 * a][sc + 16 * c] =
                keep ? s[a][c] * expf(sm.cum[i] - sm.cum[j]) : 0.f;
          }
        }
        __syncthreads();
        for (int j = 0; j < rows_j; ++j) {
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            const float sv = sm.s[yr + 32 * a][j];
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[a][c] += sv * sm.x[j][yp + 8 * c];
          }
        }
        __syncthreads();  // sm.b, sm.x and sm.s are refilled next
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int r = yr + 32 * a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = yp + 8 * c;
          if (r < rows_i && p < pw)
            y[(row0 + i0 + r) * xld + static_cast<size_t>(hd) * P + p0 + p] =
                acc[a][c];
        }
      }
    }

    // the state leaving the chunk (every read of the old h is behind the
    // last __syncthreads of the tile loop)
    const float cl = sm.cum[Q - 1];
    const float ecl = expf(cl);
    float hr[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) hr[k] = sm.h[hp + 4 * k][hn] * ecl;
    for (int j0 = 0; j0 < Q; j0 += kTile) {
      const int rows_j = min(kTile, Q - j0);
      load_tile(&sm.b[0][0], kMaxN + 1, bm + static_cast<size_t>(j0) * N, N,
                rows_j, N, kMaxN);
      load_tile(&sm.x[0][0], kPT, xb + static_cast<size_t>(j0) * xld, xld,
                rows_j, pw, kPT);
      __syncthreads();
      for (int j = 0; j < rows_j; ++j) {
        const float bw = sm.b[j][hn] * expf(cl - sm.cum[j0 + j]);
#pragma unroll
        for (int k = 0; k < 8; ++k) hr[k] += sm.x[j][hp + 4 * k] * bw;
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) sm.h[hp + 4 * k][hn] = hr[k];
  }

  __syncthreads();
  for (int i = t; i < pw * N; i += kThreads) {
    const int p = i / N, n = i % N;
    state[((static_cast<size_t>(b) * nh + hd) * P + p0 + p) * N + n] =
        sm.h[p][n];
  }
}

template <typename T>
int launch(const void* xbar, const void* Bm, const void* Cm, const void* cum,
           void* y, void* state, int B, int nc, int Q, int nh, int P, int N,
           cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem));
  static const cudaError_t attr = cudaFuncSetAttribute(  // once
      mamba_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(B * nh, (P + kPT - 1) / kPT);
  mamba_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(xbar), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(cum),
      static_cast<float*>(y), static_cast<float*>(state), nc, Q, nh, P, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mamba_chunk_scan_launch(const void* xbar, const void* Bm,
                                       const void* Cm, const void* cum,
                                       void* y, void* state, int B, int nc,
                                       int Q, int nh, int P, int N, int dtype,
                                       void* stream) {
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN || nc < 1 || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(xbar, Bm, Cm, cum, y, state, B, nc, Q, nh, P, N, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(xbar, Bm, Cm, cum, y, state, B, nc, Q, nh, P,
                                 N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
