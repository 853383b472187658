// GQA prefill attention (causal, sliding-window or bidirectional) with an
// online softmax.
//
//   q [B, Sq, H, hd]; k, v [B, Sk, Hkv, hd]; out [B, Sq, H, hd], all
//   contiguous.  Query i sits at position i + q_offset, key j at j.  Query
//   head h reads KV head h / (H / Hkv).
//
// Replaces repro/kernels/flash_attention.py:flash_attention (Pallas).  On
// the TPU the K blocks were a sequential grid axis carrying (m, l, acc) in
// VMEM scratch; Hopper blocks run in no order, so here one block owns a
// tile of BQ queries of one (b, h) and walks the K/V tiles in a loop,
// keeping m, l and acc in fp32 registers.  Only the K range that the tile
// can see (causal upper end, window lower end) is visited; masked pairs
// get probability 0.  The ragged edge is masked: Sq and Sk need not be
// multiples of the tiles.
//
// Four threads share one query row; each holds hd/4 of its dims of q and
// acc (interleaved float4 groups, so the four threads read four adjacent
// 16-byte words of a shared-memory K/V row: no bank conflicts).  K/V tiles
// are staged in shared memory as fp32.  The math runs on the CUDA cores
// in fp32 for both dtypes: simple and right first; wgmma and TMA are a
// later step.
#include "common.cuh"

namespace {

constexpr int BQ = 32;              // query rows per block
constexpr int BK = 32;              // key rows per shared-memory tile
constexpr int TPR = 4;              // threads per query row
constexpr int THREADS = BQ * TPR;   // 128

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int Sq, int Sk, int H, int Hkv, int causal,
                           int window, float scale, int q_offset) {
  constexpr int NG = HD / 16;  // float4 groups per thread
  __shared__ __align__(16) float Ks[BK * HD];
  __shared__ __align__(16) float Vs[BK * HD];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int row = threadIdx.x / TPR, sub = threadIdx.x % TPR;
  const int qi = qt * BQ + row;
  const bool active = qi < Sq;
  const int qpos = qi + q_offset;

  // this thread's dims: 16 * g + 4 * sub + [0, 4)
  float4 qr[NG], acc[NG];
  const size_t q_base = ((static_cast<size_t>(b) * Sq + qi) * H + h) * HD;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
    qr[g] = acc[g];
    if (active) {
      const Vec<T, 4> t = load_vec<T, 4>(q + q_base + 16 * g + 4 * sub);
      qr[g] = make_float4(to_float(t.v[0]), to_float(t.v[1]),
                          to_float(t.v[2]), to_float(t.v[3]));
    }
  }
  float m = kNegInf, l = 0.f;

  // the keys any query of this tile can see
  const int first_pos = qt * BQ + q_offset;
  const int last_pos = min(qt * BQ + BQ, Sq) - 1 + q_offset;
  const int k_hi = causal ? min(Sk, last_pos + 1) : Sk;
  const int k_lo = window > 0 ? max(0, first_pos - window + 1) : 0;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = threadIdx.x; idx < BK * HD / 4; idx += THREADS) {
      const int j = idx / (HD / 4), d = (idx % (HD / 4)) * 4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (k0 + j < k_hi) {
        const size_t off =
            ((static_cast<size_t>(b) * Sk + k0 + j) * Hkv + hk) * HD + d;
        const Vec<T, 4> tk = load_vec<T, 4>(k + off);
        const Vec<T, 4> tv = load_vec<T, 4>(v + off);
        kk = make_float4(to_float(tk.v[0]), to_float(tk.v[1]),
                         to_float(tk.v[2]), to_float(tk.v[3]));
        vv = make_float4(to_float(tv.v[0]), to_float(tv.v[1]),
                         to_float(tv.v[2]), to_float(tv.v[3]));
      }
      *reinterpret_cast<float4*>(Ks + j * HD + d) = kk;
      *reinterpret_cast<float4*>(Vs + j * HD + d) = vv;
    }
    __syncthreads();

    float s[BK];
    unsigned valid = 0u;
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(Ks + j * HD);
      float part = 0.f;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 kk = kr[4 * g + sub];
        part += qr[g].x * kk.x + qr[g].y * kk.y + qr[g].z * kk.z +
                qr[g].w * kk.w;
      }
      // the row's four threads hold disjoint dims: sum them (all four
      // lanes end with the same bits)
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kpos = k0 + j;
      bool ok = kpos < k_hi;
      if (causal) ok = ok && qpos >= kpos;
      if (window > 0) ok = ok && qpos - kpos < window;
      s[j] = part * scale;
      if (ok) {
        valid |= 1u << j;
        tile_max = fmaxf(tile_max, s[j]);
      }
    }

    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      acc[g].x *= alpha;
      acc[g].y *= alpha;
      acc[g].z *= alpha;
      acc[g].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = (valid >> j) & 1u ? expf(s[j] - m_new) : 0.f;
      l += p;
      const float4* vr = reinterpret_cast<const float4*>(Vs + j * HD);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vv = vr[4 * g + sub];
        acc[g].x += p * vv.x;
        acc[g].y += p * vv.y;
        acc[g].z += p * vv.z;
        acc[g].w += p * vv.w;
      }
    }
    m = m_new;
  }

  if (!active) return;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    Vec<T, 4> o;
    o.v[0] = from_float<T>(acc[g].x / denom);
    o.v[1] = from_float<T>(acc[g].y / denom);
    o.v[2] = from_float<T>(acc[g].z / denom);
    o.v[3] = from_float<T>(acc[g].w / denom);
    store_vec<T, 4>(out + q_base + 16 * g + 4 * sub, o);
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, void* out, int B,
            int Sq, int Sk, int H, int Hkv, int causal, int window,
            float scale, int q_offset, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, HD><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, Hkv, causal,
      window, scale, q_offset);
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Sk, int H, int Hkv, int hd, int causal, int window,
              float scale, int q_offset, cudaStream_t stream) {
  switch (hd) {
    case 16:
      launch<T, 16>(q, k, v, out, B, Sq, Sk, H, Hkv, causal, window, scale,
                    q_offset, stream);
      break;
    case 32:
      launch<T, 32>(q, k, v, out, B, Sq, Sk, H, Hkv, causal, window, scale,
                    q_offset, stream);
      break;
    case 64:
      launch<T, 64>(q, k, v, out, B, Sq, Sk, H, Hkv, causal, window, scale,
                    q_offset, stream);
      break;
    case 128:
      launch<T, 128>(q, k, v, out, B, Sq, Sk, H, Hkv, causal, window, scale,
                     q_offset, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Sk, int H, int Hkv, int hd,
                                      int causal, int window, float scale,
                                      int q_offset, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_hd<float>(q, k, v, out, B, Sq, Sk, H, Hkv, hd, causal,
                            window, scale, q_offset, s);
  if (dtype == kBFloat16)
    return launch_hd<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, Hkv, hd,
                                    causal, window, scale, q_offset, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
