// RMSNorm over the rows of x [rows, D]:
//   out = x * rsqrt(mean(x^2) + eps) * scale, in fp32, written in x's dtype.
//
// Replaces repro/kernels/rmsnorm.py:rmsnorm (Pallas).  Bound by bytes: one
// read and one write of x, ~4 flops an element.  Each element is read from
// device memory once and stays in registers between the sum of squares
// and the scaling, so a row pays one memory round trip, not two.  The
// scale (fp32 [D]) is read as 16-byte vectors issued beside x's, before
// the reduction, so its latency hides under x's.  The plan (which path,
// vectors per thread, rows per block, grid) is a Python function of the
// shapes and the SM count: repro_torch/kernels/rmsnorm.py:plan_rmsnorm.
//   * A row of at most 2 KB (bf16 up to D = 1024, fp32 up to 512) is held
//     by one warp: VPL <= 4 16-byte vectors a lane, the sum by warp
//     shuffles, no barrier.  A block holds 1 to 8 rows; a warp walks rows
//     grid-stride.
//   * A wider row (up to 32 KB: fp32 d_model 8192, the configs' widest)
//     is held by one block: 2 vectors a thread, the warps' sums through
//     shared memory behind one __syncthreads, added in warp order by
//     every thread.  Spread over more threads, a 4 KB row is
//     faster than in one warp's registers: each thread's chain of loads,
//     conversions and stores is 4x shorter, which outweighs the barrier.
// The summation order is fixed: two runs give identical bits.
#include "common.cuh"

namespace {

// planted fault, for the checks only: a block-path row summed over its
// first warp's share alone
constexpr int kFirstWarpOnly = 1;

// This thread's N 16-byte vectors of a row, at vector indices first +
// step k, as loaded (bf16 stays packed: 4 registers a vector); vectors at
// or past nvec read nothing and count as zeros.
template <typename T, int N>
struct RowPart {
  static constexpr int V = 16 / sizeof(T);  // elements per vector
  Vec<T, V> v[N];

  __device__ __forceinline__ void load(const T* p, int first, int step,
                                       int nvec) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int i = first + k * step;
      if (i < nvec) {
        v[k] = load_vec<T, V>(p + i * V);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) v[k].v[e] = from_float<T>(0.f);
      }
    }
  }

  __device__ __forceinline__ float sum_squares() const {
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < N; ++k)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float f = to_float(v[k].v[e]);
        ss += f * f;
      }
    return ss;
  }

  // out = x r scale, for the vectors this thread holds
  __device__ __forceinline__ void store(T* p, int first, int step, int nvec,
                                        float r,
                                        const float (&sc)[N][V]) const {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int i = first + k * step;
      if (i < nvec) {
        Vec<T, V> o;
#pragma unroll
        for (int e = 0; e < V; ++e)
          o.v[e] = from_float<T>(to_float(v[k].v[e]) * r * sc[k][e]);
        store_vec<T, V>(p + i * V, o);
      }
    }
  }
};

// The scale's elements of the same vectors, as float4 loads.
template <int N, int V>
__device__ __forceinline__ void load_scale(float (&sc)[N][V], const float* s,
                                           int first, int step, int nvec) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int i = first + k * step;
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 t =
          i < nvec ? *reinterpret_cast<const float4*>(s + i * V + 4 * q)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      sc[k][4 * q] = t.x;
      sc[k][4 * q + 1] = t.y;
      sc[k][4 * q + 2] = t.z;
      sc[k][4 * q + 3] = t.w;
    }
  }
}

// One warp per row; blockDim.x / 32 rows per block, walked grid-stride.
template <typename T, int VPL>
__global__ void __launch_bounds__(256)
    rmsnorm_warp_kernel(const T* __restrict__ x,
                        const float* __restrict__ scale, T* __restrict__ out,
                        int rows, int D, float eps) {
  constexpr int V = 16 / sizeof(T);
  const int nvec = D / V, lane = threadIdx.x % 32;
  const int rpb = blockDim.x / 32;
  for (int row = blockIdx.x * rpb + threadIdx.x / 32; row < rows;
       row += gridDim.x * rpb) {
    RowPart<T, VPL> v;
    float sc[VPL][V];
    v.load(x + static_cast<size_t>(row) * D, lane, 32, nvec);
    load_scale(sc, scale, lane, 32, nvec);
    const float ss = warp_sum(v.sum_squares());
    const float r = rsqrtf(ss / static_cast<float>(D) + eps);
    v.store(out + static_cast<size_t>(row) * D, lane, 32, nvec, r, sc);
  }
}

// One block per row: up to 1,024 threads of VPT = 2 vectors (32 KB rows).
template <typename T, int VPT>
__global__ void __launch_bounds__(1024)
    rmsnorm_block_kernel(const T* __restrict__ x,
                         const float* __restrict__ scale, T* __restrict__ out,
                         int D, float eps, int fault) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float warp_sums[32];
  const int nvec = D / V, step = blockDim.x;
  const T* xr = x + static_cast<size_t>(blockIdx.x) * D;
  RowPart<T, VPT> v;
  float sc[VPT][V];
  v.load(xr, threadIdx.x, step, nvec);
  load_scale(sc, scale, threadIdx.x, step, nvec);
  const float ss = warp_sum(v.sum_squares());
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = ss;
  __syncthreads();
  const int n_warps = fault == kFirstWarpOnly ? 1 : blockDim.x / 32;
  float total = 0.f;
  for (int w = 0; w < n_warps; ++w) total += warp_sums[w];
  const float r = rsqrtf(total / static_cast<float>(D) + eps);
  v.store(out + static_cast<size_t>(blockIdx.x) * D, threadIdx.x, step, nvec,
          r, sc);
}

template <typename T>
int launch(const void* x, const void* scale, void* out, int rows, int D,
           float eps, int per_warp, int vecs, int threads, int grid,
           int fault, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const float* sp = static_cast<const float*>(scale);
  T* op = static_cast<T*>(out);
  if (per_warp) {
    switch (vecs) {
      case 1:
        rmsnorm_warp_kernel<T, 1><<<grid, threads, 0, s>>>(xp, sp, op, rows,
                                                           D, eps);
        break;
      case 2:
        rmsnorm_warp_kernel<T, 2><<<grid, threads, 0, s>>>(xp, sp, op, rows,
                                                           D, eps);
        break;
      case 4:
        rmsnorm_warp_kernel<T, 4><<<grid, threads, 0, s>>>(xp, sp, op, rows,
                                                           D, eps);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    if (vecs != 2) return static_cast<int>(cudaErrorInvalidValue);
    rmsnorm_block_kernel<T, 2><<<grid, threads, 0, s>>>(xp, sp, op, D, eps,
                                                        fault);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: [rows, D] contiguous, D a multiple of 8; scale: [D] fp32; all
// three 16-byte aligned.  The plan of plan_rmsnorm: per_warp (1: a warp
// per row, 0: a block per row), vecs (16-byte vectors per thread),
// threads, grid; fault 0 but for a planted fault.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out,
                              int rows, int D, float eps, int dtype,
                              int per_warp, int vecs, int threads, int grid,
                              int fault, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(x, scale, out, rows, D, eps, per_warp, vecs, threads,
                         grid, fault, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, scale, out, rows, D, eps, per_warp, vecs,
                                 threads, grid, fault, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
