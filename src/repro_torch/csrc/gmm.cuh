// Helpers shared by the grouped expert matmul (moe_gmm.cu) and its
// gradient (moe_gmm_backward.cu): 16-byte staging of ragged row segments
// into shared memory, the read-once copy, the 128-byte swizzle of a wgmma
// tile, and the cursor of a persistent block's walk over work items.
#pragma once

#include "common.cuh"

namespace gmm {

using bf16 = __nv_bfloat16;

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

// cp_async16 for data read once (w, where no row tile reads it again):
// the line is fetched 256 bytes at a time and is first to leave L2.
__device__ __forceinline__ void cp_async16_once(void* smem, const void* gmem,
                                                bool pred) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  unsigned long long pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(pol));
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint.L2::256B [%0], [%1], 16, %2, "
      "%3;\n" ::"r"(sa), "l"(gmem), "r"(pred ? 16 : 0), "l"(pol));
}

// One 16-byte chunk of n_valid elements at src into dst: cp.async (the
// read-once form with ONCE) when `vec`, else through registers (zeros
// past n_valid); `safe` is any readable address.  With `vec` a row's
// length is a multiple of 8, so a chunk is whole or empty.  ONCE is a
// template argument: as a runtime flag, its branch in the per-step loader
// measured slower at decode.
template <bool ONCE>
__device__ __forceinline__ void stage_chunk(bf16* dst, const bf16* src,
                                            const bf16* safe, int n_valid,
                                            bool vec) {
  const bool ok = n_valid > 0;
  if (vec && ONCE)
    cp_async16_once(dst, ok ? src : safe, ok);
  else if (vec)
    cp_async16(dst, ok ? src : safe, ok);
  else
    store_vec<bf16, 8>(dst, load_seg<bf16, 8>(src, n_valid, false));
}

// byte offset of 16-byte chunk c of 128-byte row r, 128-byte swizzled
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// Where a block stands in its walk: its j-th item (expert e, first
// column f0, first row r0) at depth step ks; moved on one item at a time,
// with the only divisions at an item's start.  Row tiles are the fastest
// index of an item, then column tiles, then experts.
struct Cursor {
  int j, ks, e, f0, r0;

  __device__ __forceinline__ void seek(int item, int f_tiles, int r_tiles,
                                       int BF, int BR) {
    const int rest = item / r_tiles;
    r0 = (item % r_tiles) * BR;
    f0 = (rest % f_tiles) * BF;
    e = rest / f_tiles;
  }
  // past step ks of the block's items b, b + grid, ...: true when that
  // step ended an item (the cursor is then at the next one's start)
  __device__ __forceinline__ bool step(int k_steps, int grid, int f_tiles,
                                       int r_tiles, int BF, int BR) {
    if (++ks < k_steps) return false;
    ks = 0;
    ++j;
    seek(blockIdx.x + j * grid, f_tiles, r_tiles, BF, BR);
    return true;
  }
};

// the block's items and ring steps in the strided walk
__device__ __forceinline__ int block_steps(int n_items, int k_steps) {
  const int b = blockIdx.x;
  return b < n_items ? ((n_items - 1 - b) / static_cast<int>(gridDim.x) + 1) *
                           k_steps
                     : 0;
}

}  // namespace gmm
