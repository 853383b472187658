// Single-token GQA attention against a KV cache, split over the cache
// (flash-decoding): the kernel, shared by decode_attention.cu (caches in
// q's dtype) and decode_attention_int8.cu (int8 caches with scales).
//
//   q [B, H, hd]; k, v caches [B, W, Hkv, hd]; lengths [B] int32;
//   out [B, H, hd], all contiguous.  Slots >= lengths[b] are masked.
//   hd is 16, 32, 64, 96 (phi-3-vision) or 128.
//
// Replaces repro/kernels/decode_attention.py:decode_attention (Pallas).  On
// the TPU one grid row per (b, kv head) walked W in order, carrying (m, l,
// acc) in VMEM.  What bounds it on the H100 is bytes (each valid K/V row is
// read once and used for ~4 G flops per element), reached only with enough
// loads in flight, and at serving sizes latency: one block per (b, kv
// head) would put 8 blocks on 132 SMs at serving batch 4.  So the kernel:
//   * splits W into `splits` chunks of `chunk` slots: grid (splits, Hkv, B),
//     128 blocks at the main shape (16 splits of 64 slots).  The split is
//     chosen on the host from shapes only (repro_torch/kernels/
//     decode_attention.py:plan_splits: about one block per SM, no chunk
//     over 128 slots), never from `lengths`, so it costs no host sync.  A
//     block whose chunk lies wholly past lengths[b] returns before reading
//     anything.
//   * stages its chunk in tiles of 32 rows by cp.async, 16 bytes a lane (a
//     warp moves two 256-byte rows of hd 128 bf16 per instruction), in a
//     ring of two: the next tile loads while this one is computed.
//   * forms the G heads' scores of a whole tile with 256 threads (TPD
//     adjacent threads share a dot product where G * 32 < 256), then makes
//     one fp32 online-softmax update per head and tile (one warp reduction
//     for the max, one for the sum), then the PV sums, each thread owning a
//     slice of (head, dims); q stays in registers.  Products run on the CUDA
//     cores: at ~4 G flops per 2-byte element even G = 16 stays under their
//     rate, and one code path serves fp32 and bf16.
//   * takes any G from 1 to 16 (instantiated: 1, 2, 4, 6, 8, 9, 16).  Where
//     G is not a power of two the work does not divide the block: the score
//     role gives each head RP = 256 / (TPD G) row lanes and walks the tile in
//     passes of RP rows, the threads past RP G lanes idle; the PV role gives
//     each thread DV dims, DV the power of two that makes 256 DV cover G HD,
//     the threads past G HD / DV idle (G = 9, hd 128: DV 8, 144 threads, as
//     many dims a thread as at G = 16).  Every (head, row) score and every
//     (head, dim) output has one owner at every G.
//   * merges the splits' partial (m, l, acc) in split order, so a run's bits
//     do not depend on timing.  Method (b) of the design: one launch; each
//     block writes its partial to scratch (the wrapper's torch.empty),
//     fences, and counts itself in a per-(b, kv head) counter; the last
//     block of the pair to arrive merges, its L2 reads unrolled so several
//     splits' are in flight, and resets the counter to zero.  The counters
//     live in one buffer the wrapper allocates once per device (zeroed
//     once), so nothing is cleared per call and a CUDA graph can capture the
//     launch.  A pair whose valid slots fit one chunk writes its output
//     directly.  The merge rule is merge_partials in the module above, which
//     the CPU tests hold to the plain version and the JAX reference.
//
// The int8-cache form (decode_attention_int8_launch) is the same kernel with
// the caches' element type C = int8_t and two fp32 scale tensors [B, W, Hkv,
// 1] (one scale per slot and kv head, stride Hkv floats between slots), as
// repro/models/layers.py:decode_attention computes with k_scale / v_scale:
// scores (q . k) * hd^-1/2 * k_s[slot], the fp32 softmax over p, and the
// output sum_slot (p * v_s[slot]) * v in fp32 (p is not cast to v's dtype).
// Its rows are staged by cp.async at 16 bytes a lane as well (16 values: a
// row of hd 128 is 128 bytes, 8 lanes), each tile's 32 K and 32 V scales by
// 4-byte cp.async into the same ring, and values turn fp32 in registers.
// The partial l sums p without v_s, so the merge is the bf16 form's.
//
// This header holds the kernel and its launch switches; the two forms are
// instantiated in two sources, decode_attention.cu and
// decode_attention_int8.cu, which nvcc compiles in parallel.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int TR = 32;  // cache rows per shared-memory tile
static_assert(TR == 32, "the softmax step gives one row of a tile per lane");
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxGroup = 16;

// planted faults, for the checks only: the last head of a group written as
// zeros, the dims the old truncating DV (G * HD / 256) never wrote at G = 9;
// the int8 form's V scales ignored (taken as 1)
constexpr int kDropLastHead = 1;
constexpr int kIgnoreVScale = 2;

// the least power of two >= x, and the greatest <= x (1 for x < 2)
constexpr int pow2_at_least(int x) {
  return x <= 1 ? 1 : 2 * pow2_at_least((x + 1) / 2);
}
constexpr int pow2_at_most(int x) { return x < 2 ? 1 : 2 * pow2_at_most(x / 2); }

// T: q's and out's type; C: the caches' (T, or int8_t with scales)
template <typename T, typename C, int HD, int G>
struct DecodeTiles {
  static_assert(G >= 1 && G <= kMaxGroup, "groups of 1 to 16 query heads");
  static constexpr bool kQuant = std::is_same<C, int8_t>::value;
  static constexpr int EPC = 16 / static_cast<int>(sizeof(C));  // per 16 B
  static constexpr int RS = HD + EPC;  // row stride, padded by 16 bytes
  static constexpr int TILE = TR * RS;
  // K and V rings of two tiles, then the scores [G][TR] and per head m, l
  // and the rescale alpha, in fp32, then (int8) the K and V scale rings
  // [2][TR] each
  static constexpr int SMEM_BYTES = 4 * TILE * static_cast<int>(sizeof(C)) +
                                    (G * TR + 3 * G) * 4 +
                                    (kQuant ? 4 * TR * 4 : 0);
  // PV role: dims per thread, a power of two with kThreads * DV >= G * HD
  static constexpr int DV = pow2_at_least((G * HD + kThreads - 1) / kThreads);
  static_assert(HD % DV == 0, "a thread's dims lie in one head");
  // score role: threads that share one (head, row) dot product where G * TR
  // pairs would leave threads idle (a power of two), the dims each of them
  // holds, and the rows of a tile each head takes in one pass
  static constexpr int TPD = pow2_at_most(kThreads / (G * TR));
  static constexpr int DPT = HD / TPD;
  static_assert(DPT * TPD == HD, "a head's dims split evenly (hd 96: 8 x 12)");
  static constexpr int RP = kThreads / (TPD * G);
  static constexpr int PASSES = (TR + RP - 1) / RP;
  // every thread holds a (head, row) lane on every pass (powers of two)
  static constexpr bool kFullPasses = RP * TPD * G == kThreads && TR % RP == 0;
};

// Rows [r0, r0 + TR) of one KV head (row stride `stride`) into dst
// [TR][RS] by cp.async; rows at or past `hi` become zeros.
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           size_t stride, int r0, int hi) {
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));
  constexpr int CPR = HD / EPC;  // 16-byte chunks per row
  constexpr int RS = HD + EPC;
  for (int i = threadIdx.x; i < TR * CPR; i += kThreads) {
    const int r = i / CPR, c = (i % CPR) * EPC;
    const bool ok = r0 + r < hi;
    cp_async16(dst + r * RS + c,
               ok ? src + static_cast<size_t>(r0 + r) * stride + c : src, ok);
  }
}

// A tile's TR scales of one KV head (stride `stride` floats between slots)
// into dst [TR] by 4-byte cp.async; slots at or past `hi` become zeros.
__device__ __forceinline__ void stage_scales(float* dst, const float* src,
                                             int stride, int r0, int hi) {
  for (int i = threadIdx.x; i < TR; i += kThreads) {
    const bool ok = r0 + i < hi;
    cp_async4(dst + i, ok ? src + static_cast<size_t>(r0 + i) * stride : src,
              ok);
  }
}

// N int8 values (N % 4 == 0) from (shared) memory as fp32 without I2F, a
// quarter-rate instruction on sm_90 that every head's thread would run on
// every K and V value: each byte, its sign bit flipped (v + 128), becomes
// the low mantissa byte of 2^23 by one byte permute, and 2^23 + 128 is
// subtracted (exact in fp32)
template <int N>
__device__ __forceinline__ void load_floats_i8(const int8_t* p, float* f) {
  constexpr int BYTES = N % 16 == 0 ? 16 : N % 8 == 0 ? 8 : 4;
  constexpr int WORDS = BYTES / 4;
#pragma unroll
  for (int c = 0; c < N; c += BYTES) {
    const Vec<unsigned, WORDS> w =
        load_vec<unsigned, WORDS>(reinterpret_cast<const unsigned*>(p + c));
#pragma unroll
    for (int j = 0; j < WORDS; ++j) {
      const unsigned x = w.v[j] ^ 0x80808080u;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f[c + 4 * j + e] =
            __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540u | e)) -
            8388736.f;
    }
  }
}

// N elements of T from (shared) memory as fp32, in 16- or 8-byte words
template <typename T, int N>
__device__ __forceinline__ void load_floats(const T* p, float* f) {
  constexpr int BYTES = N * sizeof(T) % 16 == 0 ? 16
                        : N * sizeof(T) % 8 == 0 ? 8 : 0;
  if constexpr (std::is_same<T, int8_t>::value && N % 4 == 0) {
    load_floats_i8<N>(p, f);
  } else if constexpr (BYTES > 0) {
    constexpr int EPW = BYTES / static_cast<int>(sizeof(T));
#pragma unroll
    for (int c = 0; c < N; c += EPW) {
      const Vec<T, EPW> t = load_vec<T, EPW>(p + c);
#pragma unroll
      for (int e = 0; e < EPW; ++e) f[c + e] = to_float(t.v[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) f[e] = to_float(p[e]);
  }
}

template <typename T, typename C, int HD, int G>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const C* __restrict__ kc,
                            const C* __restrict__ vc,
                            const float* __restrict__ ks,
                            const float* __restrict__ vs,
                            const int* __restrict__ lengths,
                            T* __restrict__ out, float* __restrict__ scratch,
                            int* __restrict__ counters, int Hkv, int W,
                            int chunk, float scale, int fault) {
  using L = DecodeTiles<T, C, HD, G>;
  constexpr int DV = L::DV;
  extern __shared__ __align__(16) unsigned char decode_smem[];
  C* sK = reinterpret_cast<C*>(decode_smem);  // [2][TR][RS]
  C* sV = sK + 2 * L::TILE;
  float* sS = reinterpret_cast<float*>(sV + 2 * L::TILE);  // [G][TR]
  float* sM = sS + G * TR;   // running max per head (log2 units)
  float* sL = sM + G;        // running sum per head
  float* sA = sL + G;        // this tile's rescale per head
  float* sKs = sA + G;       // int8: K scales [2][TR], then V scales
  float* sVs = sKs + 2 * TR;

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x, pair = b * Hkv + hk;
  const int H = Hkv * G, tid = threadIdx.x;
  const int len = max(0, min(lengths[b], W));
  // the splits that hold a valid slot (split 0 always takes part); a
  // plan that does not cover W is clamped to its own splits
  const int n_live = min(splits, max(1, (len + chunk - 1) / chunk));
  if (split >= n_live) return;
  const int lo = split * chunk, hi = min(lo + chunk, len);
  const int n_tiles = (hi - lo + TR - 1) / TR;

  const size_t stride = static_cast<size_t>(Hkv) * HD;
  const C* kb = kc + (static_cast<size_t>(b) * W * Hkv + hk) * HD;
  const C* vb = vc + (static_cast<size_t>(b) * W * Hkv + hk) * HD;
  // int8: this (b, kv head)'s scales, Hkv floats between slots
  const float* ksb = L::kQuant ? ks + static_cast<size_t>(b) * W * Hkv + hk
                               : nullptr;
  const float* vsb = L::kQuant ? vs + static_cast<size_t>(b) * W * Hkv + hk
                               : nullptr;
  if (n_tiles > 0) {
    stage_rows<C, HD>(sK, kb, stride, lo, hi);
    stage_rows<C, HD>(sV, vb, stride, lo, hi);
    if constexpr (L::kQuant) {
      stage_scales(sKs, ksb, Hkv, lo, hi);
      stage_scales(sVs, vsb, Hkv, lo, hi);
    }
  }
  cp_async_commit();

  // score role: TPD adjacent threads share lane pidx = tid / TPD, which is
  // head sg over rows pidx / G + k * RP of the tile (lanes past RP * G
  // idle); this thread holds dims [part * DPT, (part + 1) * DPT) of the
  // head's q
  // CH: the elements of one load, the largest of 8, 4, 2, 1 that divides
  // DPT (12 at hd 96 and G = 1: 8-byte loads in bf16)
  constexpr int TPD = L::TPD, DPT = L::DPT;
  constexpr int CH = DPT % 8 == 0 ? 8 : DPT % 4 == 0 ? 4 : DPT % 2 == 0 ? 2 : 1;
  constexpr int RP = L::RP;
  const int pidx = tid / TPD, part = tid % TPD, sg = pidx % G;
  const bool scores = L::kFullPasses || pidx < RP * G;
  float qf[DPT];
  load_floats<T, DPT>(
      q + (static_cast<size_t>(b) * H + hk * G + sg) * HD + part * DPT, qf);
  // PV role: head og, dims [od, od + DV) (threads past G * HD / DV idle)
  const int oidx = tid * DV;
  const bool owns = oidx < G * HD;
  const int og = owns ? oidx / HD : 0, od = owns ? oidx % HD : 0;
  // 0 only where the planted fault drops the group's last head
  const float keep = fault == kDropLastHead && og == G - 1 ? 0.f : 1.f;
  const bool v_scaled = fault != kIgnoreVScale;  // false: planted fault
  float acc[DV];
#pragma unroll
  for (int e = 0; e < DV; ++e) acc[e] = 0.f;
  if (tid < G) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }
  const float sl2 = scale * kLog2e;
  const int warp = tid / 32, lane = tid % 32;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    const int r0 = lo + it * TR;
    if (it + 1 < n_tiles) {
      stage_rows<C, HD>(sK + (stage ^ 1) * L::TILE, kb, stride, r0 + TR, hi);
      stage_rows<C, HD>(sV + (stage ^ 1) * L::TILE, vb, stride, r0 + TR, hi);
      if constexpr (L::kQuant) {
        stage_scales(sKs + (stage ^ 1) * TR, ksb, Hkv, r0 + TR, hi);
        stage_scales(sVs + (stage ^ 1) * TR, vsb, Hkv, r0 + TR, hi);
      }
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const C* tK = sK + stage * L::TILE;
    const C* tV = sV + stage * L::TILE;
    const float* tKs = sKs + stage * TR;  // int8 only
    const float* tVs = sVs + stage * TR;

    // 1. the G heads' scores of the whole tile (log2 units, masked -inf),
    //    in PASSES passes of RP rows; every thread runs every pass, so the
    //    shuffles of a TPD group see all 32 lanes of the warp
#pragma unroll
    for (int pass = 0; pass < L::PASSES; ++pass) {
      const int r = pass * RP + pidx / G;
      const bool mine = scores && (L::kFullPasses || r < TR);
      float dot = 0.f;
      if (mine) {
        const C* krow = tK + r * L::RS + part * DPT;
#pragma unroll
        for (int c = 0; c < DPT; c += CH) {
          float kf[CH];
          load_floats<C, CH>(krow + c, kf);
#pragma unroll
          for (int e = 0; e < CH; ++e) dot += qf[c + e] * kf[e];
        }
      }
#pragma unroll
      for (int o = TPD / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (mine && part == 0) {
        float sc = dot * sl2;
        if constexpr (L::kQuant) sc *= tKs[r];
        sS[sg * TR + r] = r0 + r < hi ? sc : -INFINITY;
      }
    }
    __syncthreads();

    // 2. one online-softmax update per head: warp w takes heads w, w + 8..
    for (int g = warp; g < G; g += kWarps) {
      const float s = sS[g * TR + lane];  // TR == 32: one row per lane
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, warp_max(s));  // the tile has a row
      const float p = exp2f(s - m_new);
      sS[g * TR + lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        sA[g] = alpha;
        sL[g] = sL[g] * alpha + sum;
        sM[g] = m_new;
      }
    }
    __syncthreads();

    // 3. acc = acc * alpha + P V over the tile's rows (p is 0 past hi,
    //    where V is zero-filled); int8: p * v_s[row] weighs the row, the
    //    sum l above stays unscaled
    if (owns) {
      const float alpha = sA[og];
#pragma unroll
      for (int e = 0; e < DV; ++e) acc[e] *= alpha;
#pragma unroll 4
      for (int r = 0; r < TR; ++r) {
        float p = sS[og * TR + r];
        if constexpr (L::kQuant) p *= v_scaled ? tVs[r] : 1.f;
        float vf[DV];
        load_floats<C, DV>(tV + r * L::RS + od, vf);
#pragma unroll
        for (int e = 0; e < DV; ++e) acc[e] += p * vf[e];
      }
    }
    __syncthreads();  // this stage and sS are consumed before reuse
  }
  cp_async_wait<0>();
  __syncthreads();  // sM, sL are set even where no tile ran (len 0)

  const size_t obase = (static_cast<size_t>(b) * H + hk * G) * HD;
  if (n_live == 1) {  // one chunk holds every valid slot: no merge
    if (owns) {
      const float denom = fmaxf(sL[og], 1e-30f);
#pragma unroll
      for (int e = 0; e < DV; ++e)
        out[obase + og * HD + od + e] = from_float<T>(keep * acc[e] / denom);
    }
    return;
  }

  // partial state of this split: scratch [B*Hkv][splits] x {acc [G][HD],
  // m [G], l [G]} in fp32
  const int per = G * HD + 2 * G;
  float* mine = scratch + (static_cast<size_t>(pair) * splits + split) * per;
  if (owns) {
#pragma unroll
    for (int e = 0; e < DV; ++e) mine[og * HD + od + e] = acc[e];
  }
  if (tid < G) {
    mine[G * HD + tid] = sM[tid];
    mine[G * HD + G + tid] = sL[tid];
  }
  __threadfence();  // this block's partial is visible before it is counted
  __syncthreads();
  __shared__ int last;
  if (tid == 0) {
    last = atomicAdd(counters + pair, 1) == n_live - 1;
    if (last) counters[pair] = 0;  // every live split has counted
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block merges the live splits in split order
  if (!owns) return;
  const float* p0 =
      scratch + static_cast<size_t>(pair) * splits * per;
  // (unrolled so that the L2 reads of several splits are in flight)
  float M = -INFINITY;
#pragma unroll 8
  for (int s = 0; s < n_live; ++s)
    M = fmaxf(M, __ldcg(p0 + s * per + G * HD + og));
  float Lsum = 0.f, o[DV];
#pragma unroll
  for (int e = 0; e < DV; ++e) o[e] = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_live; ++s) {
    const float* ps = p0 + s * per;
    const float f = exp2f(__ldcg(ps + G * HD + og) - M);
    Lsum += __ldcg(ps + G * HD + G + og) * f;
#pragma unroll
    for (int e = 0; e < DV; ++e) o[e] += __ldcg(ps + og * HD + od + e) * f;
  }
  const float denom = fmaxf(Lsum, 1e-30f);
#pragma unroll
  for (int e = 0; e < DV; ++e)
    out[obase + og * HD + od + e] = from_float<T>(keep * o[e] / denom);
}

template <typename T, typename C, int HD, int G>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* lengths, void* out, void* scratch,
           void* counters, int B, int Hkv, int W, int splits, int chunk,
           float scale, int fault, cudaStream_t stream) {
  using L = DecodeTiles<T, C, HD, G>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_attention_kernel<T, C, HD, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  decode_attention_kernel<T, C, HD, G>
      <<<dim3(splits, Hkv, B), kThreads, L::SMEM_BYTES, stream>>>(
          static_cast<const T*>(q), static_cast<const C*>(k),
          static_cast<const C*>(v), static_cast<const float*>(ks),
          static_cast<const float*>(vs), static_cast<const int*>(lengths),
          static_cast<T*>(out), static_cast<float*>(scratch),
          static_cast<int*>(counters), Hkv, W, chunk, scale, fault);
  return static_cast<int>(cudaGetLastError());
}

// the arguments every instantiation takes, passed through the switches
struct Args {
  const void *q, *k, *v, *ks, *vs, *lengths;
  void *out, *scratch, *counters;
  int B, Hkv, W, splits, chunk;
  float scale;
  int fault;
  cudaStream_t stream;
};

template <typename T, typename C, int HD, int G>
int launch(const Args& a) {
  return launch<T, C, HD, G>(a.q, a.k, a.v, a.ks, a.vs, a.lengths, a.out,
                             a.scratch, a.counters, a.B, a.Hkv, a.W,
                             a.splits, a.chunk, a.scale, a.fault, a.stream);
}

template <typename T, typename C, int HD>
int launch_g(int G, const Args& a) {
  switch (G) {
#define REPRO_DECODE_G(GG) \
  case GG:                 \
    return launch<T, C, HD, GG>(a);
    REPRO_DECODE_G(1)
    REPRO_DECODE_G(2)
    REPRO_DECODE_G(4)
    REPRO_DECODE_G(6)
    REPRO_DECODE_G(8)
    REPRO_DECODE_G(9)
    REPRO_DECODE_G(16)
#undef REPRO_DECODE_G
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename C>
int launch_hd(int hd, int G, const Args& a) {
  switch (hd) {
#define REPRO_DECODE_HD(HD) \
  case HD:                  \
    return launch_g<T, C, HD>(G, a);
    REPRO_DECODE_HD(16)
    REPRO_DECODE_HD(32)
    REPRO_DECODE_HD(64)
    REPRO_DECODE_HD(96)
    REPRO_DECODE_HD(128)
#undef REPRO_DECODE_HD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q's dtype picks T; the caches are T, or int8_t where kInt8
template <bool kInt8>
int launch_dtype(int dtype, int hd, int H, const Args& a) {
  const int G = H / a.Hkv;
  if (a.splits < 1 || a.chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32)
    return launch_hd<float, std::conditional_t<kInt8, int8_t, float>>(hd, G,
                                                                       a);
  if (dtype == kBFloat16)
    return launch_hd<__nv_bfloat16,
                     std::conditional_t<kInt8, int8_t, __nv_bfloat16>>(hd, G,
                                                                        a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
