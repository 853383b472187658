// Helpers shared by the two chunk scans (mlstm_scan.cu, mamba_scan.cu).
//
// Both scans regroup the caller's chunks (Q rows, the log-decay cumsum
// restarted at each) into kernel chunks of kL rows, and run in stages
// over (b, kernel chunk, head, tile): the state entering each kernel
// chunk, the scores of each chunk, the outputs.  The plan (kernel chunks,
// grid) comes from shapes alone (kernels/mamba_scan.py:plan_scan).
#pragma once

#include "common.cuh"

namespace scan {

constexpr int kL = 64;          // rows of a kernel chunk
constexpr int kThreads = 128;   // four warps a block

// planted faults (kernels/mamba_scan.py FAULT_*), for the checks only
constexpr int kFaultWrongState = 1;  // chunk c reads the state entering c-1
constexpr int kFaultSplitLow = 2;    // each split's parts but the first dropped
constexpr int kFaultNoRebase = 4;    // cum not rebased across caller chunks

// The gates of one kernel chunk (rows s0 .. s0 + rows - 1 of one (b,
// head)), held two rows a lane by one warp between their load and their
// use, so a block can load the next chunk's while it works on this one.
struct Gates {
  float c[2];   // the caller's log-decay cumsum of the lane's two rows
  float li[2];  // the input gate of those rows (0 where there is none)
  float base;   // the cumsum just before s0 inside its caller chunk, or 0
};

// Issue the loads of a chunk's gates (cum_t at cum[t * stride], li_t at
// li[t * stride]; li may be null).
__device__ __forceinline__ void gates_load(const float* __restrict__ cum,
                                           const float* __restrict__ li,
                                           size_t stride, int s0, int rows,
                                           int Q, Gates& v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = 2 * lane + x;
    const size_t at = static_cast<size_t>(s0 + r) * stride;
    v.c[x] = r < rows ? cum[at] : 0.f;
    v.li[x] = r < rows && li ? li[at] : 0.f;
  }
  v.base = s0 % Q ? cum[static_cast<size_t>(s0 - 1) * stride] : 0.f;
}

// The log-decay cumsum rebased to the kernel chunk, into g[0 .. kL) (0
// past `rows`): the caller's cumsum restarts every Q rows, so
//   g_t = cum_t - cum_{s0 - 1} (if s0 is inside a caller chunk)
//         + the last cum of every caller chunk that ends in [s0, t);
// and, where w is given, the weight of each row to the chunk's end,
// w_t = e^{g_last - g_t + li_t} (0 past `rows`).  Returns g_last.  Run by
// one whole warp: one shuffle scan in a fixed order.
__device__ __forceinline__ float gates_rebase(const Gates& v, int s0, int rows,
                                              int Q, bool no_rebase, float* g,
                                              float* w) {
  const int lane = threadIdx.x & 31;
  float e[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = 2 * lane + x;
    e[x] = (r < rows && (s0 + r) % Q == Q - 1 && !no_rebase) ? v.c[x] : 0.f;
  }
  const float s = e[0] + e[1];
  float incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  const float g0 = (v.c[0] - v.base) + excl;
  const float g1 = (v.c[1] - v.base) + (excl + e[0]);
  const float gl = __shfl_sync(0xffffffffu, (rows - 1) & 1 ? g1 : g0,
                               (rows - 1) >> 1);
  const bool ok0 = 2 * lane < rows, ok1 = 2 * lane + 1 < rows;
  g[2 * lane] = ok0 ? g0 : 0.f;
  g[2 * lane + 1] = ok1 ? g1 : 0.f;
  if (w) {
    w[2 * lane] = ok0 ? expf(gl - g0 + v.li[0]) : 0.f;
    w[2 * lane + 1] = ok1 ? expf(gl - g1 + v.li[1]) : 0.f;
  }
  return gl;
}

// Both at once, for a block that needs one chunk's g (whole warp).
__device__ __forceinline__ void rebase_chunk(const float* __restrict__ cum,
                                             size_t stride, int s0, int rows,
                                             int Q, bool no_rebase,
                                             float* g) {
  Gates v;
  gates_load(cum, nullptr, stride, s0, rows, Q, v);
  gates_rebase(v, s0, rows, Q, no_rebase, g, nullptr);
}

// src[r][c] (row stride ld) for r < rows, c < cols, else 0, into the
// R x CN tile dst[r][c] (or dst[c][r] with kTrans), row stride ldd: the
// thread's loads issued in batches of 16 before their stores.
template <int R, int CN, bool kTrans, typename T>
__device__ __forceinline__ void stage(float* dst, int ldd, const T* src,
                                      size_t ld, int rows, int cols) {
  constexpr int kIters = (R * CN + kThreads - 1) / kThreads, kBatch = 16;
#pragma unroll 1
  for (int it0 = 0; it0 < kIters; it0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = threadIdx.x + (it0 + u) * kThreads, r = i / CN,
                c = i % CN;
      v[u] = (i < R * CN && r < rows && c < cols) ? to_float(src[r * ld + c])
                                                  : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = threadIdx.x + (it0 + u) * kThreads, r = i / CN,
                c = i % CN;
      if (i < R * CN) {
        if (kTrans)
          dst[c * ldd + r] = v[u];
        else
          dst[r * ldd + c] = v[u];
      }
    }
  }
}

// The rows r < rows of a [R][4 CN4] fp32 tile (row stride ld floats,
// 16-byte aligned) into dst (row stride ldd), 16 bytes a copy, zeros
// past rows or cols (cols a multiple of 4).
template <int R, int CN4>
__device__ __forceinline__ void cp_tile_f32(float* dst, int ldd,
                                            const float* src, size_t ld,
                                            int rows, int cols) {
  for (int i = threadIdx.x; i < R * CN4; i += kThreads) {
    const int r = i / CN4, c = i % CN4 * 4;
    const bool ok = r < rows && c < cols;
    cp_async16(dst + r * ldd + c, ok ? src + r * ld + c : src, ok);
  }
}

// acc[a][c] += sum_{k < K} A(r0 + 16 a, k) B(k, c0 + 8 c) on the CUDA
// cores, for the thread's 4 x NC share of a 64 x 8 NC tile (r0 = t / 8,
// c0 = t % 8), A and B in shared memory: A(m, k) at A[k * lda + m], or at
// A[m * lda + k] with kAm; B(k, n) at B[k * ldb + n], or at B[n * ldb + k]
// with kBn.
template <int NC, bool kAm = false, bool kBn = false>
__device__ __forceinline__ void fma_tile(float (&acc)[4][NC], const float* A,
                                         int lda, const float* B, int ldb,
                                         int K) {
  const int r0 = threadIdx.x / 8, c0 = threadIdx.x % 8;
  for (int k = 0; k < K; ++k) {
    float a[4], b[NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = kAm ? A[(r0 + 16 * i) * lda + k] : A[k * lda + r0 + 16 * i];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      b[c] = kBn ? B[(c0 + 8 * c) * ldb + k] : B[k * ldb + c0 + 8 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] += a[i] * b[c];
  }
}

// An fp32 operand of a bf16 product as three bf16 parts, x = p0 + p1 + p2
// to about 2^-26 relative (each part the bf16 rounding of what the ones
// before leave; every residual is exact in fp32).  Two parts leave
// 2^-18, which measured on the card put the mLSTM scan over the fp32
// limit.
constexpr int kParts = 3;

// Two fp32 values as kParts registers of two bf16 each (x0 in the low
// halves).
__device__ __forceinline__ void split_bf16x2(float x0, float x1,
                                             unsigned (&p)[kParts]) {
#pragma unroll
  for (int s = 0; s < kParts; ++s) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    p[s] = *reinterpret_cast<const unsigned*>(&h);
    x0 -= hf.x;
    x1 -= hf.y;
  }
}

// The raw shared memory of a block whose roles use different layouts.
template <typename S>
__device__ __forceinline__ S& smem_as(unsigned char* raw) {
  return *reinterpret_cast<S*>(raw);
}

__host__ __device__ constexpr size_t cmax(size_t a, size_t b) {
  return a > b ? a : b;
}

// ---- the backward kernels' products on the tensor cores
// (mamba_scan_backward.cu, mlstm_scan_backward.cu) ----
namespace bwd {

// bf16 parts of a split fp32 operand (kernels/mamba_scan.py
// BACKWARD_PARTS): one part fails the bf16 limit the backwards are held
// to, two meet it at every product.
constexpr int kParts = 2;
constexpr int kPLd = kL + 8;   // bf16 tile row stride (144-byte rows: the
                               // eight rows of an ldmatrix hit 32 banks)
constexpr int kFLd = kL + 4;   // fp32 tile row stride (272-byte rows)

// The row stride of a 64-row tile of T (a staged input, or an exact
// operand's first part).
template <typename T>
constexpr int kLdOf = sizeof(T) == 2 ? kPLd : kFLd;

// One 64 x 64 operand of a product: with bf16 inputs kParts bf16 tiles
// (an fp32 operand split, an exact bf16 one in the first alone), with
// fp32 inputs one fp32 tile (split into TF32 parts as it is read).
template <typename T>
struct Opnd;
template <>
struct Opnd<__nv_bfloat16> {
  __nv_bfloat16 p[kParts][kL][kPLd];
};
template <>
struct Opnd<float> {
  float f[kL][kFLd];
};

__device__ __forceinline__ __nv_bfloat16* first(Opnd<__nv_bfloat16>& o) {
  return &o.p[0][0][0];
}
__device__ __forceinline__ float* first(Opnd<float>& o) { return &o.f[0][0]; }

__device__ __forceinline__ float get(const Opnd<__nv_bfloat16>& o, int r,
                                     int c) {
  return __bfloat162float(o.p[0][r][c]);
}
__device__ __forceinline__ float get(const Opnd<float>& o, int r, int c) {
  return o.f[r][c];
}

// The value an operand holds at (r, c): its parts summed (bf16), or as
// it is (fp32).
__device__ __forceinline__ float get_all(const Opnd<__nv_bfloat16>& o, int r,
                                         int c) {
  float v = 0.f;
#pragma unroll
  for (int s = 0; s < kParts; ++s) v += __bfloat162float(o.p[s][r][c]);
  return v;
}
__device__ __forceinline__ float get_all(const Opnd<float>& o, int r, int c) {
  return o.f[r][c];
}

// o(r, c) = x0, o(r, c + 1) = x1 (c even): split into kParts bf16 parts,
// each the rounding of what the ones before leave (as split_bf16x2), or
// stored as they are.
__device__ __forceinline__ void put2(Opnd<__nv_bfloat16>& o, int r, int c,
                                     float x0, float x1) {
#pragma unroll
  for (int s = 0; s < kParts; ++s) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    *reinterpret_cast<__nv_bfloat162*>(&o.p[s][r][c]) = h;
    x0 -= hf.x;
    x1 -= hf.y;
  }
}
__device__ __forceinline__ void put2(Opnd<float>& o, int r, int c, float x0,
                                     float x1) {
  *reinterpret_cast<float2*>(&o.f[r][c]) = make_float2(x0, x1);
}

// The rows r < rows, columns c < cols of src (row stride ld elements)
// into the 64 x 64 tile dst (row stride LD), zeros elsewhere: by cp.async,
// 16 bytes a copy, where `vec` (cols a multiple of 16 bytes, src rows
// 16-byte aligned), else by plain loads.  The caller commits and waits.
template <typename T, int LD, int NTHR>
__device__ __forceinline__ void load_tile(T* dst, const T* src, size_t ld,
                                          int rows, int cols, bool vec) {
  constexpr int E = 16 / sizeof(T), PER = kL / E;
  if (vec) {
    for (int i = threadIdx.x; i < kL * PER; i += NTHR) {
      const int r = i / PER, c = i % PER * E;
      const bool ok = r < rows && c < cols;
      cp_async16(dst + r * LD + c, ok ? src + r * ld + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kL * kL; i += NTHR) {
      const int r = i / kL, c = i % kL;
      dst[r * LD + c] = (r < rows && c < cols) ? src[r * ld + c]
                                               : from_float<T>(0.f);
    }
  }
}

// o(r, c) = rs[r] st[r][c] over the tile (rs null: 1), st a staged tile
// of S at row stride kLdOf<S>.
template <int NTHR, typename T, typename S>
__device__ __forceinline__ void put_tile(Opnd<T>& o, const S* st,
                                         const float* rs) {
  constexpr int LD = kLdOf<S>;
  for (int i = threadIdx.x; i < kL * kL / 2; i += NTHR) {
    const int r = i / (kL / 2), c = i % (kL / 2) * 2;
    const float sc = rs ? rs[r] : 1.f;
    put2(o, r, c, sc * to_float(st[r * LD + c]),
         sc * to_float(st[r * LD + c + 1]));
  }
}

// ldmatrix row addresses (lane l) of a 16 x 16 A block at (m0, k0) stored
// [m][k] (frag_a) or [k][m] (frag_akm, read transposed), and of the two
// 16 x 8 B blocks at (k0, n0 .. n0 + 15) stored [n][k] (frag_bnk) or
// [k][n] (frag_bkn, read transposed), in mma.m16n8k16's fragment order.
__device__ __forceinline__ const __nv_bfloat16* frag_a(
    const __nv_bfloat16* t, int m0, int k0, int l) {
  return t + (m0 + (l & 7) + ((l >> 3) & 1) * 8) * kPLd + k0 + (l >> 4) * 8;
}
__device__ __forceinline__ const __nv_bfloat16* frag_akm(
    const __nv_bfloat16* t, int m0, int k0, int l) {
  return t + (k0 + (l & 7) + (l >> 4) * 8) * kPLd + m0 + ((l >> 3) & 1) * 8;
}
__device__ __forceinline__ const __nv_bfloat16* frag_bnk(
    const __nv_bfloat16* t, int k0, int n0, int l) {
  return t + (n0 + (l & 7) + (l >> 4) * 8) * kPLd + k0 + ((l >> 3) & 1) * 8;
}
__device__ __forceinline__ const __nv_bfloat16* frag_bkn(
    const __nv_bfloat16* t, int k0, int n0, int l) {
  return t + (k0 + (l & 7) + ((l >> 3) & 1) * 8) * kPLd + n0 + (l >> 4) * 8;
}

// acc += A B over k < 64 for the warp's 16 x 8 NT tile at (m0, n0), in
// mma.m16n8k16's accumulator layout (acc[nt][0..1]: row m0 + lane / 4,
// columns n0 + 8 nt + 2 (lane % 4) + {0, 1}; acc[nt][2..3]: 8 rows
// down).  A(m, k) at A[m][k] (at A[k][m] with kAkm), B(k, n) at B[n][k]
// (at B[k][n] with kBkn).  bf16: part i of A against part j of B for i <
// na, j < nb, i + j < max(na, nb) (an exact operand has na or nb 1; two
// split ones keep hi hi + hi lo + lo hi), on the tensor cores; fp32: see
// below.
template <int NT, bool kAkm, bool kBkn>
__device__ __forceinline__ void mma_tile(float (&acc)[NT][4],
                                         const Opnd<__nv_bfloat16>& A,
                                         int na,
                                         const Opnd<__nv_bfloat16>& B,
                                         int nb, int m0, int n0) {
  const int lane = threadIdx.x & 31;
  const int n = na > nb ? na : nb;
#pragma unroll
  for (int ks = 0; ks < kL / 16; ++ks) {
#pragma unroll
    for (int i = 0; i < kParts; ++i) {
      if (i >= na) break;
      unsigned af[4];
      if (kAkm)
        ldmatrix_x4_trans(af, frag_akm(&A.p[i][0][0], m0, 16 * ks, lane));
      else
        ldmatrix_x4(af, frag_a(&A.p[i][0][0], m0, 16 * ks, lane));
#pragma unroll
      for (int j = 0; j < kParts; ++j) {
        if (j >= nb || i + j >= n) break;
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned bf[4];
          if (kBkn)
            ldmatrix_x4_trans(bf, frag_bkn(&B.p[j][0][0], 16 * ks,
                                           n0 + 16 * np, lane));
          else
            ldmatrix_x4(bf, frag_bnk(&B.p[j][0][0], 16 * ks, n0 + 16 * np,
                                     lane));
          mma_bf16_16816(acc[2 * np], af, bf[0], bf[1]);
          mma_bf16_16816(acc[2 * np + 1], af, bf[2], bf[3]);
        }
      }
    }
  }
}
// fp32 operands: three TF32 products (hi hi + hi lo + lo hi, each
// operand as a TF32 value and the TF32 rounding of what it leaves, about
// 2^-21 relative) by mma.m16n8k8 on the tensor cores.
__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4], const unsigned (&a)[4],
                                              unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// o.f[r][c], or o.f[c][r] with kT
template <bool kT>
__device__ __forceinline__ float elem(const Opnd<float>& o, int r, int c) {
  return kT ? o.f[c][r] : o.f[r][c];
}
template <int NT, bool kAkm, bool kBkn>
__device__ __forceinline__ void mma_tile(float (&acc)[NT][4],
                                         const Opnd<float>& A, int,
                                         const Opnd<float>& B, int, int m0,
                                         int n0) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < kL; k0 += 8) {
    // A fragment: rows gq, gq + 8; columns tq, tq + 4
    const float av[4] = {elem<kAkm>(A, m0 + gq, k0 + tq), elem<kAkm>(A, m0 + gq + 8, k0 + tq),
                         elem<kAkm>(A, m0 + gq, k0 + tq + 4),
                         elem<kAkm>(A, m0 + gq + 8, k0 + tq + 4)};
    unsigned ah[4], al[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      ah[x] = to_tf32(av[x]);
      al[x] = to_tf32(av[x] - __uint_as_float(ah[x]));
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      // B fragment: rows (k) tq, tq + 4; column gq
      const int n = n0 + 8 * nt + gq;
      const float b0 = elem<!kBkn>(B, k0 + tq, n), b1 = elem<!kBkn>(B, k0 + tq + 4, n);
      const unsigned bh0 = to_tf32(b0), bh1 = to_tf32(b1);
      const unsigned bl0 = to_tf32(b0 - __uint_as_float(bh0));
      const unsigned bl1 = to_tf32(b1 - __uint_as_float(bh1));
      mma_tf32_1688(acc[nt], al, bh0, bh1);
      mma_tf32_1688(acc[nt], ah, bl0, bl1);
      mma_tf32_1688(acc[nt], ah, bh0, bh1);
    }
  }
}

// The sum over the four lanes of a quad (one row of a fragment), in a
// fixed order.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The backward's rebase (kernels/mamba_scan.py:rebase): the caller's
// log-decay cumsum cum [B, S, nh], restarted every Q rows, as g [B, chunks
// * kL, nh], restarted every kernel chunk, 0 past S.  One thread a (b,
// kernel row, head): g_t = cum_t - cum_{s0 - 1} (if the chunk starts
// inside a caller chunk) + the last cum of every caller chunk that ends in
// [s0, t), summed in row order.
static __global__ void __launch_bounds__(256) rebase_kernel(const float* __restrict__ cum,
                                                     float* __restrict__ g, int B,
                                                     int S, int Q, int nh, int chunks) {
  const size_t total = static_cast<size_t>(B) * chunks * kL * nh;
  const size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= total) return;
  const int hd = i % nh;
  const size_t bt = i / nh;
  const int t = bt % (static_cast<size_t>(chunks) * kL), b = bt / (static_cast<size_t>(chunks) * kL);
  const int s0 = t / kL * kL;
  const float* c = cum + static_cast<size_t>(b) * S * nh + hd;
  float v = 0.f;
  if (t < S) {
    v = c[static_cast<size_t>(t) * nh] - (s0 % Q ? c[static_cast<size_t>(s0 - 1) * nh] : 0.f);
    for (int u = s0; u < t; ++u)
      if (u % Q == Q - 1) v += c[static_cast<size_t>(u) * nh];
  }
  g[i] = v;
}

// Its adjoint (kernels/mamba_scan.py:rebase_adjoint): dg [B, chunks * kL,
// nh] (rows past S ignored) -> dcum [B, S, nh].  Row u takes its own dg,
// the dg of every later row of its kernel chunk where u ends a caller
// chunk, less the whole dg of the kernel chunk that starts at u + 1 inside
// a caller chunk; each sum in row order.
static __global__ void __launch_bounds__(256) rebase_adjoint_kernel(const float* __restrict__ dg,
                                                             float* __restrict__ dcum, int B,
                                                             int S, int Q, int nh, int chunks) {
  const size_t total = static_cast<size_t>(B) * S * nh;
  const size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= total) return;
  const int hd = i % nh;
  const size_t bu = i / nh;
  const int u = bu % S, b = bu / S;
  const float* d = dg + static_cast<size_t>(b) * chunks * kL * nh + hd;
  const int s0 = u / kL * kL, end = min(s0 + kL, S);
  float v = d[static_cast<size_t>(u) * nh];
  if (u % Q == Q - 1)
    for (int t = u + 1; t < end; ++t) v += d[static_cast<size_t>(t) * nh];
  if (u + 1 == s0 + kL && u + 1 < S && (u + 1) % Q) {
    float base = 0.f;
    for (int t = u + 1; t < min(u + 1 + kL, S); ++t) base += d[static_cast<size_t>(t) * nh];
    v -= base;
  }
  dcum[i] = v;
}

}  // namespace bwd

}  // namespace scan
