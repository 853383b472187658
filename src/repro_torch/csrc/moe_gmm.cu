// Grouped expert matmul: out[e] = x[e] @ w[e] for every expert e.
//
//   x [E, R, D]; w [E, D, F]; out [E, R, F], all contiguous, one dtype
//   (fp32 or bf16).  The sum over D is taken in fp32 and written in the
//   input dtype.
//
// Replaces repro/kernels/moe_gmm.py:moe_gmm (Pallas).  On the TPU the D
// blocks were the innermost sequential grid axis, carrying the fp32 tile
// in VMEM scratch; Hopper blocks run in no order, so here the contraction
// over D is a loop inside the block, with the accumulators in registers.
//
// What bounds it: bytes.  The MoE layer's capacity dispatch gives every
// expert its R = n * C rows whether or not a token was routed there, so
// every call streams the whole weight tensor (E * D * F elements) while R
// is a few dozen rows: far below the card's ridge of ~295 flops per byte.
// So one block owns one (64-column tile of F, expert, tile of up to BR
// rows) and holds ALL of the expert's rows when R <= 64 (6 at decode, 32
// to 64 at the server's prefill buckets): each weight element is read
// from device memory once.  Larger R (mixtral's C = 320) adds a grid axis
// over row tiles, each of which reads the weights again.
//
// Per step of the D loop a block stages a [64, 64] tile of w and a
// [BR, 64] tile of x in shared memory as fp32: 16-byte loads, neighbouring
// threads on neighbouring columns of w.  The next step's tiles are loaded
// into registers while the current one is multiplied.  Each thread owns 4
// columns of 8 rows over one of 128 / BR slices of the tile's depth, so a
// w element read from shared memory serves 8 rows even at decode (R = 6,
// one slice of 16); splitting the rows instead would read each w element
// from shared memory once per 16 threads, which bounds the kernel at
// decode.  The slices are summed at the end through warp shuffles and
// shared memory.  In bf16 a block holds only 8 KB of w in flight, too few
// bytes to cover the memory's latency at the 3 blocks an SM holds; a
// multi-stage copy ring (cp.async or TMA) is the next step.  The ragged edge (R, D, F not
// multiples of the tiles, or rows not 16-byte aligned) is masked with
// zeros; nothing needs divisibility.  The summation order is fixed and
// there are no atomics: two runs give identical bits.  The products run on
// the CUDA cores in fp32; tensor cores (mma / wgmma) and TMA are a later
// step.
#include "common.cuh"

namespace {

constexpr int BF = 64;          // output columns per block
constexpr int BD = 64;          // contraction depth per shared-memory step
constexpr int THREADS = 256;    // 16 column groups of 4 x 16 lanes

// n_valid elements of a row segment starting at p (zeros past n_valid);
// one 16-byte load when the segment is whole and aligned.
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load_seg(const T* p, int n_valid,
                                              bool vec) {
  if (vec && n_valid >= V) return load_vec<T, V>(p);
  Vec<T, V> t;
#pragma unroll
  for (int i = 0; i < V; ++i) t.v[i] = i < n_valid ? p[i] : from_float<T>(0.f);
  return t;
}

template <typename T, int BR>
__global__ void __launch_bounds__(THREADS)
    moe_gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ out, int R, int D, int F, int x_vec,
                   int w_vec) {
  constexpr int V = 16 / sizeof(T);              // elements per 16 bytes
  constexpr int KS = 128 / BR;                   // slices of the D tile
  constexpr int W_SEGS = BD * BF / V;            // 16-byte segments of w
  constexpr int X_SEGS = BR * BD / V;            // ... and of x
  constexpr int W_PER = (W_SEGS + THREADS - 1) / THREADS;
  constexpr int X_PER = (X_SEGS + THREADS - 1) / THREADS;
  // Ws also holds the KS / 2 partial sums at the end: KS * BR * BF / 2
  // floats = BD * BF
  __shared__ __align__(16) float Ws[BD][BF];
  __shared__ __align__(16) float Xs[BD][BR + 4];  // transposed, padded

  const int f0 = blockIdx.x * BF, e = blockIdx.y, r0 = blockIdx.z * BR;
  // thread t: columns 4 * cg + [0, 4) of rows 8 * rg + [0, 8), over the
  // depths dd = ks (mod KS) of each tile; the two halves of a warp hold
  // neighbouring slices ks, ks + 1 of the same rows
  const int cg = threadIdx.x % 16, l = threadIdx.x / 16;
  const int ks = l % KS, rg = l / KS;
  const T* xe = x + static_cast<size_t>(e) * R * D;
  const T* we = w + static_cast<size_t>(e) * D * F;

  Vec<T, V> wr[W_PER], xr[X_PER];   // the next step's tiles, as loaded
  auto load = [&](int d0) {
#pragma unroll
    for (int i = 0; i < W_PER; ++i) {
      const int s = threadIdx.x + i * THREADS;
      const int dd = s / (BF / V), c = (s % (BF / V)) * V;
      const int n = (s < W_SEGS && d0 + dd < D) ? min(V, F - f0 - c) : 0;
      wr[i] = load_seg<T, V>(we + static_cast<size_t>(d0 + dd) * F + f0 + c,
                             n, w_vec);
    }
#pragma unroll
    for (int i = 0; i < X_PER; ++i) {
      const int s = threadIdx.x + i * THREADS;
      const int r = s / (BD / V), dd = (s % (BD / V)) * V;
      const int n = (s < X_SEGS && r0 + r < R) ? min(V, D - d0 - dd) : 0;
      xr[i] = load_seg<T, V>(xe + static_cast<size_t>(r0 + r) * D + d0 + dd,
                             n, x_vec);
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < W_PER; ++i) {
      const int s = threadIdx.x + i * THREADS;
      if (s < W_SEGS) {
        const int dd = s / (BF / V), c = (s % (BF / V)) * V;
#pragma unroll
        for (int j = 0; j < V; j += 4)
          *reinterpret_cast<float4*>(&Ws[dd][c + j]) = make_float4(
              to_float(wr[i].v[j]), to_float(wr[i].v[j + 1]),
              to_float(wr[i].v[j + 2]), to_float(wr[i].v[j + 3]));
      }
    }
#pragma unroll
    for (int i = 0; i < X_PER; ++i) {
      const int s = threadIdx.x + i * THREADS;
      if (s < X_SEGS) {
        const int r = s / (BD / V), dd = (s % (BD / V)) * V;
#pragma unroll
        for (int j = 0; j < V; ++j) Xs[dd + j][r] = to_float(xr[i].v[j]);
      }
    }
  };

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load(0);
  for (int d0 = 0; d0 < D; d0 += BD) {
    __syncthreads();  // the previous tiles are consumed
    stage();
    __syncthreads();
    if (d0 + BD < D) load(d0 + BD);  // in flight while this tile is used
#pragma unroll
    for (int dd = ks; dd < BD; dd += KS) {
      const float4 wv = *reinterpret_cast<const float4*>(&Ws[dd][4 * cg]);
      const float4 xa = *reinterpret_cast<const float4*>(&Xs[dd][8 * rg]);
      const float4 xb =
          *reinterpret_cast<const float4*>(&Xs[dd][8 * rg + 4]);
      const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][0] += xv[i] * wv.x;
        acc[i][1] += xv[i] * wv.y;
        acc[i][2] += xv[i] * wv.z;
        acc[i][3] += xv[i] * wv.w;
      }
    }
  }

  // sum the KS slices in a fixed order: the warp's halves first, then the
  // KS / 2 pair sums through shared memory
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 16);
  float* part = &Ws[0][0];  // [KS / 2][BR][BF]
  __syncthreads();          // the last tile is consumed
  if (ks % 2 == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float4*>(
          &part[((ks / 2) * BR + 8 * rg + i) * BF + 4 * cg]) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BR * BF; idx += THREADS) {
    const int r = idx / BF, c = idx % BF;
    if (r0 + r >= R || f0 + c >= F) continue;
    float sum = 0.f;
#pragma unroll
    for (int p = 0; p < KS / 2; ++p) sum += part[(p * BR + r) * BF + c];
    out[(static_cast<size_t>(e) * R + r0 + r) * F + f0 + c] =
        from_float<T>(sum);
  }
}

template <typename T, int BR>
void launch(const void* x, const void* w, void* out, int E, int R, int D,
            int F, int x_vec, int w_vec, cudaStream_t stream) {
  const dim3 grid((F + BF - 1) / BF, E, (R + BR - 1) / BR);
  moe_gmm_kernel<T, BR><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      R, D, F, x_vec, w_vec);
}

// The row tile: the smallest of 8, 16, 32, 64 that holds all R rows, else
// 64 with a grid axis over row tiles.
template <typename T>
int launch_rows(const void* x, const void* w, void* out, int E, int R, int D,
                int F, int x_vec, int w_vec, cudaStream_t stream) {
  if (R <= 8)
    launch<T, 8>(x, w, out, E, R, D, F, x_vec, w_vec, stream);
  else if (R <= 16)
    launch<T, 16>(x, w, out, E, R, D, F, x_vec, w_vec, stream);
  else if (R <= 32)
    launch<T, 32>(x, w, out, E, R, D, F, x_vec, w_vec, stream);
  else
    launch<T, 64>(x, w, out, E, R, D, F, x_vec, w_vec, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_vec / w_vec: 1 when every row of x (w) starts on a 16-byte boundary,
// so whole segments may be read as one 16-byte load.
extern "C" int moe_gmm_launch(const void* x, const void* w, void* out, int E,
                              int R, int D, int F, int x_vec, int w_vec,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_rows<float>(x, w, out, E, R, D, F, x_vec, w_vec, s);
  if (dtype == kBFloat16)
    return launch_rows<__nv_bfloat16>(x, w, out, E, R, D, F, x_vec, w_vec,
                                      s);
  return static_cast<int>(cudaErrorInvalidValue);
}
