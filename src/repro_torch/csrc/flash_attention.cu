// GQA prefill attention (causal, sliding-window or bidirectional) with an
// online softmax.
//
//   q [B, Sq, H, hd]; k [B, Sk, Hkv, hd]; v [B, Sk, Hkv, hd_v];
//   out [B, Sq, H, hd_v], all contiguous.  Query i sits at position
//   i + q_offset, key j at j.  Query head h reads KV head h / (H / Hkv).
//   hd_v = hd except for MLA's prefill (hd 192 = 128 + 64 rope, hd_v 128);
//   hd is 16, 32, 64, 96 (phi-3-vision: 6 k-steps, 192-byte rows in 12
//   cp.async chunks, padded to 208 bytes) or 128.
//
// Replaces repro/kernels/flash_attention.py:flash_attention (Pallas).  On
// the TPU the K blocks were a sequential grid axis carrying (m, l, acc) in
// VMEM scratch; Hopper blocks run in no order, so one block owns a tile of
// query rows of one (b, query head) and walks the K/V tiles in a loop with
// (m, l, acc) in fp32 registers.  Only the K range the tile can see
// (causal upper end, window lower end) is visited; masked pairs get
// probability 0 and a row with no visible key returns 0.  Sq and Sk need
// not be multiples of the tiles.
//
// What bounds it on the H100: at the prompts a server prefills (37 to 512
// tokens), the tensor-core work of the longest query tile on its SM and
// per-block latency, not bytes (K and V of a KV head at S = 512 are 256 KB,
// re-read by its G query heads from the 50 MB L2).  On the CUDA cores in
// fp32 (67 TFLOP/s, a shared-memory read per FMA) the products alone would
// take longer than SDPA's whole call, so the bf16 kernel takes
// FlashAttention-2's shape:
//   * QK^T and PV run on the tensor cores as mma.sync m16n8k16 (bf16 in,
//     fp32 accumulate), fragments loaded by ldmatrix (V's by
//     ldmatrix.trans).  mma.sync and not wgmma: a block walks 1 to 8 K
//     tiles at these lengths, and mma.sync lets each warp own 16 query rows
//     on its own; wgmma with TMA-fed tiles is the step after this one.
//   * Each warp owns 16 query rows: Q's A-fragments and the fp32 output
//     accumulator stay in registers for the whole K loop, and P goes from
//     the QK^T accumulator straight into PV's A-fragments (FA2's register
//     identity between the m16n8 accumulator and the m16k16 operand).
//   * A block owns BQ = 64 query rows (32 where 64 would leave more than an
//     eighth of the SMs without a block: repro_torch/kernels/
//     flash_attention.py:tile_rows) of one head, in two warp groups of BQ /
//     16 warps.  The groups take alternate K tiles, halving the chain of
//     dependent tiles, and merge their (m, l, o) in group order at the end.
//     Blocks are ordered so that the longest causal tiles start first.
//   * K/V tiles of 64 keys stay bf16 in shared memory, staged by cp.async
//     in a ring per group of three stages (two at hd 192, where three do
//     not fit the 227 KB), so later tiles load while one is computed; rows
//     are padded by 16 bytes, so ldmatrix's eight row reads hit eight
//     distinct bank groups.  Dynamic shared memory (221 KB at (128, 128),
//     193 KB at (192, 128)), raised once per instantiation before its first
//     launch; 174 registers at (128, 128), 212 at (192, 128), no spills.
//   * Tiles that no row of a warp can see are skipped; tiles that all of
//     them see whole skip the mask.
// fp32 keeps the first version's CUDA-core kernel: the tensor cores would
// compute in TF32, which cannot meet the fp32 limit of 1e-4.  fp32 is the
// parity check's path and is not served.
#include "common.cuh"

namespace {

// ------------------------------------------------- bf16: tensor cores --
constexpr int BK = 64;   // keys per K/V tile
constexpr int KG = 2;    // warp groups that split a block's K tiles
constexpr int PAD = 8;   // bf16 elements of padding per shared row (16 B)
constexpr float kLog2e = 1.4426950408889634f;
using bf16 = __nv_bfloat16;

// Stages of each group's K/V ring: three where they fit the 227 KB a block
// may use, so two tiles load while one is computed.
constexpr int stages_for(int hd, int hdv) { return hd + hdv <= 256 ? 3 : 2; }

template <int HD, int HDV, int NW>
struct MmaTiles {
  static constexpr int STAGES = stages_for(HD, HDV);
  static constexpr int BQ = 16 * NW;          // query rows per block
  static constexpr int GROUP = 32 * NW;       // threads of one warp group
  static constexpr int THREADS = KG * GROUP;
  static constexpr int QS = HD + PAD, KS = HD + PAD, VS = HDV + PAD;
  static constexpr int Q_ELEMS = BQ * QS;
  static constexpr int K_ELEMS = BK * KS;     // one stage
  static constexpr int V_ELEMS = BK * VS;
  static constexpr int RING = STAGES * (K_ELEMS + V_ELEMS);  // one group's
  static constexpr int SMEM_BYTES =
      (Q_ELEMS + KG * RING) * static_cast<int>(sizeof(bf16));
  // what a later group hands group 0 at the end: m, l and o per thread
  static constexpr int HANDOFF = 4 + HDV / 2;
  static_assert((KG - 1) * GROUP * HANDOFF * 4 <=
                    KG * RING * static_cast<int>(sizeof(bf16)),
                "the hand-off fits the K/V rings");
};

// Rows [r0, r0 + ROWS) of src (row stride `stride` elements, DIM wide) into
// dst [ROWS][DIM + PAD] by cp.async, by the THREADS threads numbered `tid`;
// rows outside [lo, hi) become zeros.
template <int ROWS, int DIM, int THREADS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           size_t stride, int r0, int lo,
                                           int hi, int tid) {
  constexpr int CPR = DIM / 8;  // 16-byte chunks per row
#pragma unroll 4
  for (int i = tid; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int row = r0 + r;
    const bool ok = row >= lo && row < hi;
    cp_async16(dst + r * (DIM + PAD) + c,
               ok ? src + static_cast<size_t>(row) * stride + c : src, ok);
  }
}

// Block: KG groups of NW warps; warp w of each group owns query rows
// q0 + 16 (w % NW) + [0, 16), and group g takes K tiles g, g + KG, ... of
// the block's range, each through its own two-stage ring.  At the end the
// groups' (m, l, o) are merged in group order by group 0, which writes.
template <int HD, int HDV, int NW>
__global__ void __launch_bounds__(KG * 32 * NW)
    flash_attention_mma_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               bf16* __restrict__ out, int Sq, int Sk, int H,
                               int Hkv, int causal, int window, float scale,
                               int q_offset, int short_tiles) {
  using L = MmaTiles<HD, HDV, NW>;
  constexpr int BQ = L::BQ, GROUP = L::GROUP;
  constexpr int KSTEPS = HD / 16;  // k-steps of QK^T
  constexpr int NT = BK / 8;       // 8-key column tiles of S
  constexpr int NO = HDV / 8;      // 8-dim column tiles of O
  extern __shared__ __align__(16) unsigned char flash_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(flash_smem);

  const int h = blockIdx.x, b = blockIdx.y;
  // the z axis runs last: causal tiles with the most keys go first
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / NW, rw = warp % NW, gtid = threadIdx.x % GROUP;
  constexpr int STAGES = L::STAGES;
  bf16* sK = sQ + L::Q_ELEMS + grp * L::RING;  // this group's [STAGES][BK][KS]
  bf16* sV = sK + STAGES * L::K_ELEMS;         // ... and [STAGES][BK][VS]
  const int q0 = qt * BQ;

  // the keys any query of this tile can see, in whole BK tiles
  const int first_pos = q0 + q_offset;
  const int last_pos = min(q0 + BQ, Sq) - 1 + q_offset;
  const int k_hi = causal ? min(Sk, last_pos + 1) : Sk;
  const int k_lo = window > 0 ? max(0, first_pos - window + 1) : 0;
  const int t_lo = k_lo / BK;
  // short_tiles > 0 only for a planted fault: that many tiles left out
  const int n_tiles =
      k_hi > k_lo ? max(0, (k_hi + BK - 1) / BK - t_lo - short_tiles) : 0;

  const bf16* qb = q + (static_cast<size_t>(b) * Sq * H + h) * HD;
  const bf16* kb = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * HD;
  const bf16* vb = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * HDV;
  const size_t k_stride = static_cast<size_t>(Hkv) * HD;
  const size_t v_stride = static_cast<size_t>(Hkv) * HDV;

  // Q's tile (all threads) with each group's first K/V tile, then its
  // next STAGES - 2: one commit group per tile, empty past the range
  stage_rows<BQ, HD, L::THREADS>(sQ, qb, static_cast<size_t>(H) * HD, q0, 0,
                                 Sq, threadIdx.x);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    const int j = st * KG + grp;
    if (j < n_tiles) {
      const int k0 = (t_lo + j) * BK;
      stage_rows<BK, HD, GROUP>(sK + st * L::K_ELEMS, kb, k_stride, k0, k_lo,
                                k_hi, gtid);
      stage_rows<BK, HDV, GROUP>(sV + st * L::V_ELEMS, vb, v_stride, k0,
                                 k_lo, k_hi, gtid);
    }
    cp_async_commit();
  }

  unsigned qa[KSTEPS][4];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // this thread's rows: g and g + 8 of its warp's 16; m is the running
  // max of the raw scores, l this thread's part of the running sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl2 = scale * kLog2e;  // softmax in base 2
  const int row0 = q0 + rw * 16 + lane / 4;
  const int wpos_lo = q0 + rw * 16 + q_offset, wpos_hi = wpos_lo + 15;

  const int n_iter = (n_tiles + KG - 1) / KG;
  for (int it = 0; it < n_iter; ++it) {
    const int stage = it % STAGES;
    const int j = it * KG + grp;  // this group's tile
    // its tile STAGES - 1 ahead loads while this one computes, into the
    // stage the last iteration freed
    const int jn = j + (STAGES - 1) * KG;
    if (jn < n_tiles) {
      const int kn = (t_lo + jn) * BK;
      const int sn = (it + STAGES - 1) % STAGES;
      stage_rows<BK, HD, GROUP>(sK + sn * L::K_ELEMS, kb, k_stride, kn, k_lo,
                                k_hi, gtid);
      stage_rows<BK, HDV, GROUP>(sV + sn * L::V_ELEMS, vb, v_stride, kn,
                                 k_lo, k_hi, gtid);
    }
    cp_async_commit();  // possibly empty: every thread counts alike
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        ldmatrix_x4(qa[ks], sQ + (rw * 16 + (lane & 7) +
                                  ((lane >> 3) & 1) * 8) * L::QS +
                                ks * 16 + (lane >> 4) * 8);
    }
    const int kt0 = (t_lo + j) * BK;
    // a tile none of this warp's 16 rows can see is skipped; one all of
    // them see whole needs no mask
    const bool visible =
        j < n_tiles && !(causal && kt0 > wpos_hi) &&
        !(window > 0 && kt0 + BK - 1 <= wpos_lo - window);
    const bool whole = kt0 + BK <= k_hi &&
                       !(causal && kt0 + BK - 1 > wpos_lo) &&
                       !(window > 0 && wpos_hi - kt0 >= window);
    if (visible) {
      const bf16* tK = sK + stage * L::K_ELEMS;
      const bf16* tV = sV + stage * L::V_ELEMS;
      float s[NT][4];
#pragma unroll
      for (int t = 0; t < NT; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          // keys 16 np + [0, 16), dims 16 ks + [0, 16): B of two n-tiles
          unsigned kf[4];
          ldmatrix_x4(kf, tK + (np * 16 + (lane & 7) + (lane >> 4) * 8) *
                                   L::KS +
                              ks * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16_16816(s[2 * np], qa[ks], kf[0], kf[1]);
          mma_bf16_16816(s[2 * np + 1], qa[ks], kf[2], kf[3]);
        }
      }
      float mx[2] = {m[0], m[1]};
      if (whole) {
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[t][e]);
      } else {  // the diagonal, the window's edge, the ragged end
#pragma unroll
        for (int t = 0; t < NT; ++t) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kt0 + 8 * t + 2 * (lane & 3) + (e & 1);
            const int pos = row0 + 8 * (e >> 1) + q_offset;
            bool ok = key < k_hi;
            if (causal) ok = ok && pos >= key;
            if (window > 0) ok = ok && pos - key < window;
            s[t][e] = ok ? s[t][e] : -INFINITY;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[t][e]);
          }
        }
      }
      // one online-softmax update per row
      float base[2];  // the new max, scaled; 0 while no key is seen
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the four lanes of a quad hold one row's 64 scores
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        base[r] = mx[r] == -INFINITY ? 0.f : mx[r] * sl2;
        const float alpha = exp2_approx(m[r] * sl2 - base[r]);
        m[r] = mx[r];
        l[r] *= alpha;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[n][2 * r] *= alpha;
          o[n][2 * r + 1] *= alpha;
        }
      }
      // P = 2^(s sl2 - base) in fp32 for l, as bf16 A-fragments for PV
      unsigned pa[BK / 16][4];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2_approx(fmaf(s[t][e], sl2, -base[e >> 1]));
          l[e >> 1] += p[e];
        }
        pa[t / 2][(t & 1) * 2] = pack_bf16x2(p[0], p[1]);
        pa[t / 2][(t & 1) * 2 + 1] = pack_bf16x2(p[2], p[3]);
      }
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
#pragma unroll
        for (int dn = 0; dn < NO / 2; ++dn) {
          // keys 16 ks + [0, 16), dims 16 dn + [0, 16), transposed
          unsigned vf[4];
          ldmatrix_x4_trans(vf, tV + (ks * 16 + (lane & 7) +
                                      ((lane >> 3) & 1) * 8) * L::VS +
                                    dn * 16 + (lane >> 4) * 8);
          mma_bf16_16816(o[2 * dn], pa[ks], vf[0], vf[1]);
          mma_bf16_16816(o[2 * dn + 1], pa[ks], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();  // the rings are free: they carry the hand-off

  // groups 1.. hand (m, l, o) to the thread of group 0 with the same rows
  float* hand = reinterpret_cast<float*>(sQ + L::Q_ELEMS);
  if (grp > 0) {
    float* mine = hand + ((grp - 1) * GROUP + gtid) * L::HANDOFF;
    mine[0] = m[0];
    mine[1] = m[1];
    mine[2] = l[0];
    mine[3] = l[1];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[4 + 4 * n + e] = o[n][e];
  }
  __syncthreads();
  if (grp > 0) return;
#pragma unroll 1
  for (int g = 1; g < KG; ++g) {
    const float* theirs = hand + ((g - 1) * GROUP + gtid) * L::HANDOFF;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mt = theirs[r];
      const float mn = fmaxf(m[r], mt);
      const float base = mn == -INFINITY ? 0.f : mn * sl2;
      const float fa = exp2_approx(m[r] * sl2 - base);
      const float fb = exp2_approx(mt * sl2 - base);
      m[r] = mn;
      l[r] = l[r] * fa + theirs[2 + r] * fb;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * r] = o[n][2 * r] * fa + theirs[4 + 4 * n + 2 * r] * fb;
        o[n][2 * r + 1] =
            o[n][2 * r + 1] * fa + theirs[4 + 4 * n + 2 * r + 1] * fb;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    bf16* orow = out + ((static_cast<size_t>(b) * Sq + row) * H + h) * HDV +
                 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<unsigned*>(orow + 8 * n) =
          pack_bf16x2(o[n][2 * r] / denom, o[n][2 * r + 1] / denom);
  }
}

template <int HD, int HDV, int NW>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Sk, int H, int Hkv, int causal, int window,
               float scale, int q_offset, int short_tiles,
               cudaStream_t stream) {
  using L = MmaTiles<HD, HDV, NW>;
  // above 48 KB only by request, made once before the first launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_mma_kernel<HD, HDV, NW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(H, B, (Sq + L::BQ - 1) / L::BQ);
  flash_attention_mma_kernel<HD, HDV, NW>
      <<<grid, L::THREADS, L::SMEM_BYTES, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Sk, H,
          Hkv, causal, window, scale, q_offset, short_tiles);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ fp32: CUDA cores --
// Four threads share one query row; each holds hd/4 of its dims of q and
// hd_v/4 of acc (interleaved float4 groups, so the four threads read four
// adjacent 16-byte words of a shared K/V row: no bank conflicts).  K/V
// tiles are staged in shared memory as fp32; the products are FMAs.
constexpr int F_BQ = 32;                // query rows per block
constexpr int F_BK = 32;                // key rows per shared-memory tile
constexpr int TPR = 4;                  // threads per query row
constexpr int F_THREADS = F_BQ * TPR;   // 128

// Rows [k0, k0 + F_BK) of one KV head of src [B, Sk, Hkv, DIM] into the
// shared tile dst [F_BK, DIM]; rows at or past k_hi are zeros.
template <int DIM>
__device__ __forceinline__ void stage_tile_f32(const float* __restrict__ src,
                                               float* dst, int b, int k0,
                                               int k_hi, int Sk, int Hkv,
                                               int hk) {
  for (int idx = threadIdx.x; idx < F_BK * DIM / 4; idx += F_THREADS) {
    const int j = idx / (DIM / 4), d = (idx % (DIM / 4)) * 4;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k0 + j < k_hi)
      t = *reinterpret_cast<const float4*>(
          src + ((static_cast<size_t>(b) * Sk + k0 + j) * Hkv + hk) * DIM + d);
    *reinterpret_cast<float4*>(dst + j * DIM + d) = t;
  }
}

template <int HD, int HDV>
__global__ void __launch_bounds__(F_THREADS)
    flash_attention_f32_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ out, int Sq, int Sk, int H,
                               int Hkv, int causal, int window, float scale,
                               int q_offset, int short_tiles) {
  constexpr int NG = HD / 16;    // float4 groups of q per thread
  constexpr int NGV = HDV / 16;  // ... and of acc
  // at (192, 128): 24.6 + 16.4 KB, under the 48 KB of static shared memory
  __shared__ __align__(16) float Ks[F_BK * HD];
  __shared__ __align__(16) float Vs[F_BK * HDV];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int row = threadIdx.x / TPR, sub = threadIdx.x % TPR;
  const int qi = qt * F_BQ + row;
  const bool active = qi < Sq;
  const int qpos = qi + q_offset;

  // this thread's dims: 16 * g + 4 * sub + [0, 4)
  float4 qr[NG], acc[NGV];
  const size_t qrow = (static_cast<size_t>(b) * Sq + qi) * H + h;
#pragma unroll
  for (int g = 0; g < NGV; ++g) acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int g = 0; g < NG; ++g)
    qr[g] = active ? *reinterpret_cast<const float4*>(q + qrow * HD + 16 * g +
                                                      4 * sub)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  float m = kNegInf, l = 0.f;

  // the keys any query of this tile can see
  const int first_pos = qt * F_BQ + q_offset;
  const int last_pos = min(qt * F_BQ + F_BQ, Sq) - 1 + q_offset;
  int k_hi = causal ? min(Sk, last_pos + 1) : Sk;
  const int k_lo = window > 0 ? max(0, first_pos - window + 1) : 0;
  k_hi -= short_tiles * F_BK;  // a planted fault only

  for (int k0 = k_lo; k0 < k_hi; k0 += F_BK) {
    __syncthreads();  // the previous tile is consumed
    stage_tile_f32<HD>(k, Ks, b, k0, k_hi, Sk, Hkv, hk);
    stage_tile_f32<HDV>(v, Vs, b, k0, k_hi, Sk, Hkv, hk);
    __syncthreads();

    float s[F_BK];
    unsigned valid = 0u;
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < F_BK; ++j) {
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
    for (int g = 0; g < NGV; ++g) {
      acc[g].x *= alpha;
      acc[g].y *= alpha;
      acc[g].z *= alpha;
      acc[g].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < F_BK; ++j) {
      const float p = (valid >> j) & 1u ? expf(s[j] - m_new) : 0.f;
      l += p;
      const float4* vr = reinterpret_cast<const float4*>(Vs + j * HDV);
#pragma unroll
      for (int g = 0; g < NGV; ++g) {
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
  for (int g = 0; g < NGV; ++g)
    *reinterpret_cast<float4*>(out + qrow * HDV + 16 * g + 4 * sub) =
        make_float4(acc[g].x / denom, acc[g].y / denom, acc[g].z / denom,
                    acc[g].w / denom);
}

template <int HD, int HDV>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Sk, int H, int Hkv, int causal, int window,
               float scale, int q_offset, int short_tiles,
               cudaStream_t stream) {
  const dim3 grid((Sq + F_BQ - 1) / F_BQ, H, B);
  flash_attention_f32_kernel<HD, HDV><<<grid, F_THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, H, Hkv,
      causal, window, scale, q_offset, short_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows: the bf16 kernel's query tile, 64 or 32 (tile_rows in
// repro_torch/kernels/flash_attention.py); the fp32 kernel's is 32.
// short_tiles: 0, or the number of K tiles a planted fault leaves out.
// The (hd, hd_v) pairs are HEAD_DIM_PAIRS of that module.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Sk, int H, int Hkv, int hd,
                                      int hd_v, int causal, int window,
                                      float scale, int q_offset, int rows,
                                      int short_tiles, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_CASE(HD, HDV)                                            \
  if (hd == HD && hd_v == HDV) {                                             \
    if (dtype == kFloat32)                                                   \
      return launch_f32<HD, HDV>(q, k, v, out, B, Sq, Sk, H, Hkv, causal,    \
                                 window, scale, q_offset, short_tiles, s);   \
    if (dtype == kBFloat16 && rows == 64)                                    \
      return launch_mma<HD, HDV, 4>(q, k, v, out, B, Sq, Sk, H, Hkv, causal, \
                                    window, scale, q_offset, short_tiles,    \
                                    s);                                      \
    if (dtype == kBFloat16 && rows == 32)                                    \
      return launch_mma<HD, HDV, 2>(q, k, v, out, B, Sq, Sk, H, Hkv, causal, \
                                    window, scale, q_offset, short_tiles,    \
                                    s);                                      \
    return static_cast<int>(cudaErrorInvalidValue);                          \
  }
  REPRO_FLASH_CASE(16, 16)
  REPRO_FLASH_CASE(32, 32)
  REPRO_FLASH_CASE(64, 64)
  REPRO_FLASH_CASE(96, 96)
  REPRO_FLASH_CASE(128, 128)
  REPRO_FLASH_CASE(192, 128)
#undef REPRO_FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
