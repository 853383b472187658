// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel has a plain C entry point (extern "C") that takes raw
// pointers and the CUDA stream, launches on that stream, allocates
// nothing, and returns cudaGetLastError() so the Python wrapper can raise
// on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

// dtype codes shared with repro_torch/kernels/_build.py (DTYPE_CODES)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF mask value

// N elements of T moved as one aligned vector access (up to 16 bytes).
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Vec<T, N> load_vec(const T* p) {
  return *reinterpret_cast<const Vec<T, N>*>(p);
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const Vec<T, N>& v) {
  *reinterpret_cast<Vec<T, N>*>(p) = v;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>  // round to nearest even, as jnp.astype and torch.to do
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Butterfly sum: every lane of the warp ends with the same total.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
