// RMSNorm over the rows of x [rows, D]:
//   out = x * rsqrt(mean(x^2) + eps) * scale, in fp32, written in x's dtype.
//
// Replaces repro/kernels/rmsnorm.py:rmsnorm (Pallas).  Bound by bytes:
// one block per row, 16-byte loads, fp32 sum of squares reduced with warp
// shuffles and one shared-memory step, one write per element.  The second
// pass re-reads the row (at most 8 KB) from L1/L2, so device memory sees
// one read and one write of x.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ out, int D, float eps) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  const T* xr = x + static_cast<size_t>(blockIdx.x) * D;
  T* orow = out + static_cast<size_t>(blockIdx.x) * D;
  const int nvec = D / V;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const Vec<T, V> v = load_vec<T, V>(xr + i * V);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float f = to_float(v.v[e]);
      ss += f * f;
    }
  }

  // block reduction: warp shuffles, then the warp sums through shared memory
  __shared__ float warp_sums[kMaxThreads / 32];
  __shared__ float total;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  ss = warp_sum(ss);
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < (blockDim.x + 31) / 32; ++w) t += warp_sums[w];
    total = t;
  }
  __syncthreads();
  const float r = rsqrtf(total / static_cast<float>(D) + eps);

  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const Vec<T, V> v = load_vec<T, V>(xr + i * V);
    Vec<T, V> o;
#pragma unroll
    for (int e = 0; e < V; ++e)
      o.v[e] = from_float<T>(to_float(v.v[e]) * r * scale[i * V + e]);
    store_vec<T, V>(orow + i * V, o);
  }
}

template <typename T>
void launch(const void* x, const void* scale, void* out, int rows, int D,
            float eps, cudaStream_t stream) {
  const int nvec = D / (16 / static_cast<int>(sizeof(T)));
  int threads = ((nvec + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  rmsnorm_kernel<T><<<rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<T*>(out), D, eps);
}

}  // namespace

// x, out: [rows, D] contiguous, D a multiple of 8; scale: [D] fp32.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out,
                              int rows, int D, float eps, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    launch<float>(x, scale, out, rows, D, eps, s);
  else if (dtype == kBFloat16)
    launch<__nv_bfloat16>(x, scale, out, rows, D, eps, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
