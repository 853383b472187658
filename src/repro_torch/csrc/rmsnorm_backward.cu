// Gradient of RMSNorm (csrc/rmsnorm.cu) over the rows of x [rows, D]:
// with r = rsqrt(mean(x^2) + eps) per row and g = dL/dy,
//   dx     = r (g scale) - x r^3 mean(x g scale)   (written in x's dtype)
//   dscale = sum over rows of g x r                (fp32 [D]).
//
// The port's own: the TPU kernel repro/kernels/rmsnorm.py:rmsnorm has no
// backward, and the reference differentiates repro/models/layers.py:
// apply_norm with jax.grad instead.  Bound by bytes: x and g are read once
// and dx written once, ~12 flops an element.
//
// Launch 1 (rmsnorm_bwd_rows_kernel): a block walks rows grid-stride; its
// thread t holds the 8 contiguous columns [8t, 8t + 8) of every row it
// sees (16-byte loads of bf16, two of fp32), so the sums of x^2 and of
// x g scale reduce through warp shuffles and one exchange of the warps'
// sums in shared memory, added in warp order.  The same thread keeps its
// columns' share of dscale in fp32 registers across the block's rows and
// writes it once, as the block's partial row of partial [grid, D].
// Launch 2 (rmsnorm_bwd_scale_kernel) sums the partials of each column in
// block order.  No atomics: for one grid, two runs give identical bits,
// which a resumed training run relies on to equal an unbroken one.
#include "common.cuh"

namespace {

// planted fault, for the checks only: a row's two sums taken over its
// first warp's share alone
constexpr int kFirstWarpOnly = 1;
constexpr int EPT = 8;  // columns per thread

__device__ __forceinline__ void load8(const float* p, float (&f)[EPT]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&f)[EPT]) {
  const Vec<__nv_bfloat16, EPT> v = load_vec<__nv_bfloat16, EPT>(p);
#pragma unroll
  for (int e = 0; e < EPT; ++e) f[e] = to_float(v.v[e]);
}

__device__ __forceinline__ void store8(float* p, const float (&f)[EPT]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&f)[EPT]) {
  Vec<__nv_bfloat16, EPT> v;
#pragma unroll
  for (int e = 0; e < EPT; ++e) v.v[e] = from_float<__nv_bfloat16>(f[e]);
  store_vec<__nv_bfloat16, EPT>(p, v);
}

template <typename T>
__global__ void __launch_bounds__(1024)
    rmsnorm_bwd_rows_kernel(const T* __restrict__ x,
                            const float* __restrict__ scale,
                            const T* __restrict__ g, T* __restrict__ dx,
                            float* __restrict__ partial, int rows, int D,
                            float eps, int fault) {
  __shared__ float sums[2][32];
  const int c0 = threadIdx.x * EPT, lane = threadIdx.x % 32,
            warp = threadIdx.x / 32;
  const bool active = c0 < D;
  const int n_warps = fault == kFirstWarpOnly ? 1 : blockDim.x / 32;
  float sc[EPT], acc[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) sc[e] = 0.f, acc[e] = 0.f;
  if (active) {
    const float4 a = *reinterpret_cast<const float4*>(scale + c0);
    const float4 b = *reinterpret_cast<const float4*>(scale + c0 + 4);
    sc[0] = a.x, sc[1] = a.y, sc[2] = a.z, sc[3] = a.w;
    sc[4] = b.x, sc[5] = b.y, sc[6] = b.z, sc[7] = b.w;
  }
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t off = static_cast<size_t>(row) * D + c0;
    float xv[EPT], gv[EPT];
    if (active) {
      load8(x + off, xv);
      load8(g + off, gv);
    } else {
#pragma unroll
      for (int e = 0; e < EPT; ++e) xv[e] = 0.f, gv[e] = 0.f;
    }
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      ss += xv[e] * xv[e];
      dot += xv[e] * gv[e] * sc[e];
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    if (lane == 0) sums[0][warp] = ss, sums[1][warp] = dot;
    __syncthreads();
    float tss = 0.f, tdot = 0.f;
    for (int w = 0; w < n_warps; ++w) tss += sums[0][w], tdot += sums[1][w];
    __syncthreads();  // the next row's sums overwrite these
    const float r = rsqrtf(tss / static_cast<float>(D) + eps);
    const float c = r * r * r * (tdot / static_cast<float>(D));
    if (active) {
      float d[EPT];
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        d[e] = r * (gv[e] * sc[e]) - xv[e] * c;
        acc[e] += gv[e] * (xv[e] * r);
      }
      store8(dx + off, d);
    }
  }
  if (active) {
    float* p = partial + static_cast<size_t>(blockIdx.x) * D + c0;
#pragma unroll
    for (int e = 0; e < EPT; ++e) p[e] = acc[e];
  }
}

// dscale[c] = sum over p < parts of partial[p, c], in order of p.
__global__ void __launch_bounds__(256)
    rmsnorm_bwd_scale_kernel(const float* __restrict__ partial,
                             float* __restrict__ dscale, int parts, int D) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= D) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += partial[static_cast<size_t>(p) * D + c];
  dscale[c] = s;
}

template <typename T>
int launch(const void* x, const void* scale, const void* g, void* dx,
           void* partial, void* dscale, int rows, int D, float eps,
           int threads, int grid, int fault, cudaStream_t s) {
  rmsnorm_bwd_rows_kernel<T><<<grid, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const T*>(g), static_cast<T*>(dx),
      static_cast<float*>(partial), rows, D, eps, fault);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_bwd_scale_kernel<<<(D + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dscale), grid,
      D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, g, dx: [rows, D] contiguous, D a multiple of 8 and at most 8 * 1024,
// all 16-byte aligned; scale, dscale: [D] fp32; partial: [grid, D] fp32
// scratch.  threads = 32 ceil(D / 256) (one thread per 8 columns, whole
// warps), grid blocks walk the rows; fault 0 but for a planted fault.
extern "C" int rmsnorm_backward_launch(const void* x, const void* scale,
                                       const void* g, void* dx,
                                       void* partial, void* dscale, int rows,
                                       int D, float eps, int dtype,
                                       int threads, int grid, int fault,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads % 32 != 0 || threads > 1024 || threads * EPT < D || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32)
    return launch<float>(x, scale, g, dx, partial, dscale, rows, D, eps,
                         threads, grid, fault, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, scale, g, dx, partial, dscale, rows, D,
                                 eps, threads, grid, fault, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
