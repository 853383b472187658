// Single-token GQA attention against a KV cache.
//
//   q [B, H, hd]; k, v caches [B, W, Hkv, hd]; lengths [B] int32;
//   out [B, H, hd], all contiguous.  Slots >= lengths[b] are masked.
//
// Replaces repro/kernels/decode_attention.py:decode_attention (Pallas).
// Bound by bytes: every valid K/V row is read once and used for ~4 * G
// flops per element.  One block per (b, kv head) serves the G query heads
// of the group, so each K/V row is read from device memory once.  Its
// warps split the valid slots round-robin; each warp reads one 16-byte-
// per-lane K row, forms the G scores with warp-shuffle sums and runs an
// fp32 online softmax per head.  The warps' (m, l, acc) are then merged in
// a fixed order through shared memory (no atomics, so a run's bits do not
// depend on timing).  Only B * Hkv blocks run, which leaves most SMs idle
// at serving batch sizes: splitting W across blocks is the next step.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                            const T* __restrict__ vc,
                            const int* __restrict__ lengths,
                            T* __restrict__ out, int Hkv, int W, float scale) {
  constexpr int EPL = HD >= 32 ? HD / 32 : 1;  // elements per lane
  constexpr int LANES = HD / EPL;              // lanes that hold data
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[G][HD];

  const int b = blockIdx.x, hk = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool holds = lane < LANES;
  const int d0 = lane * EPL;
  const int H = Hkv * G;
  const int len = max(0, min(lengths[b], W));

  float qr[G][EPL], acc[G][EPL], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
    const size_t qoff = (static_cast<size_t>(b) * H + hk * G + g) * HD + d0;
    Vec<T, EPL> t;
    if (holds) t = load_vec<T, EPL>(q + qoff);
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[g][e] = holds ? to_float(t.v[e]) : 0.f;
      acc[g][e] = 0.f;
    }
  }

  for (int t = warp; t < len; t += kWarps) {
    const size_t off =
        ((static_cast<size_t>(b) * W + t) * Hkv + hk) * HD + d0;
    float kr[EPL], vr[EPL];
    Vec<T, EPL> tk, tv;
    if (holds) {
      tk = load_vec<T, EPL>(kc + off);
      tv = load_vec<T, EPL>(vc + off);
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      kr[e] = holds ? to_float(tk.v[e]) : 0.f;
      vr[e] = holds ? to_float(tv.v[e]) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) part += qr[g][e] * kr[e];
      const float s = warp_sum(part) * scale;
      const float m_new = fmaxf(m[g], s);
      const float alpha = expf(m[g] - m_new);
      const float p = expf(s - m_new);
      l[g] = l[g] * alpha + p;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] = acc[g][e] * alpha + p * vr[e];
      m[g] = m_new;
    }
  }

  // merge the warps' partial softmax states in warp order
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
  __syncthreads();
  float M[G], L[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    M[g] = kNegInf;
    for (int w = 0; w < kWarps; ++w) M[g] = fmaxf(M[g], sm_m[w][g]);
    L[g] = 0.f;
    for (int w = 0; w < kWarps; ++w)
      L[g] += sm_l[w][g] * expf(sm_m[w][g] - M[g]);
  }
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w && holds) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float f = expf(m[g] - M[g]);
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const float val = acc[g][e] * f;
          sm_acc[g][d0 + e] = w == 0 ? val : sm_acc[g][d0 + e] + val;
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    const size_t ooff = (static_cast<size_t>(b) * H + hk * G + g) * HD + d;
    out[ooff] = from_float<T>(sm_acc[g][d] / fmaxf(L[g], 1e-30f));
  }
}

template <typename T, int HD, int G>
void launch(const void* q, const void* k, const void* v, const void* lengths,
            void* out, int B, int Hkv, int W, float scale,
            cudaStream_t stream) {
  decode_attention_kernel<T, HD, G><<<dim3(B, Hkv), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(out), Hkv, W, scale);
}

template <typename T, int HD>
bool launch_g(int G, const void* q, const void* k, const void* v,
              const void* lengths, void* out, int B, int Hkv, int W,
              float scale, cudaStream_t stream) {
  switch (G) {
    case 1: launch<T, HD, 1>(q, k, v, lengths, out, B, Hkv, W, scale, stream); return true;
    case 2: launch<T, HD, 2>(q, k, v, lengths, out, B, Hkv, W, scale, stream); return true;
    case 4: launch<T, HD, 4>(q, k, v, lengths, out, B, Hkv, W, scale, stream); return true;
    case 8: launch<T, HD, 8>(q, k, v, lengths, out, B, Hkv, W, scale, stream); return true;
    case 16: launch<T, HD, 16>(q, k, v, lengths, out, B, Hkv, W, scale, stream); return true;
    default: return false;
  }
}

template <typename T>
int launch_hd(int hd, int G, const void* q, const void* k, const void* v,
              const void* lengths, void* out, int B, int Hkv, int W,
              float scale, cudaStream_t stream) {
  bool ok = false;
  switch (hd) {
    case 16: ok = launch_g<T, 16>(G, q, k, v, lengths, out, B, Hkv, W, scale, stream); break;
    case 32: ok = launch_g<T, 32>(G, q, k, v, lengths, out, B, Hkv, W, scale, stream); break;
    case 64: ok = launch_g<T, 64>(G, q, k, v, lengths, out, B, Hkv, W, scale, stream); break;
    case 128: ok = launch_g<T, 128>(G, q, k, v, lengths, out, B, Hkv, W, scale, stream); break;
    default: break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, int B, int H, int Hkv,
                                       int W, int hd, float scale, int dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
  if (dtype == kFloat32)
    return launch_hd<float>(hd, G, q, k, v, lengths, out, B, Hkv, W, scale, s);
  if (dtype == kBFloat16)
    return launch_hd<__nv_bfloat16>(hd, G, q, k, v, lengths, out, B, Hkv, W,
                                    scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
