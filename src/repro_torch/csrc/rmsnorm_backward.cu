// Gradient of RMSNorm (csrc/rmsnorm.cu) over the rows of x [rows, D]:
// with r = rsqrt(mean(x^2) + eps) per row and g = dL/dy,
//   dx     = r (g scale) - x r^3 mean(x g scale)   (written in x's dtype)
//   dscale = sum over rows of g x r                (fp32 [D]).
//
// The port's own: the TPU kernel repro/kernels/rmsnorm.py:rmsnorm has no
// backward, and the reference differentiates repro/models/layers.py:
// apply_norm with jax.grad instead.  Bound by bytes: x and g are read once
// and dx written once, ~12 flops an element.  The plan of both launches is
// a function of the shapes and the SM count only
// (repro_torch/kernels/rmsnorm.py:plan_rmsnorm_backward).
//
// Launch 1 (rmsnorm_bwd_rows_kernel): block b owns the contiguous rows
// [b chunk, (b + 1) chunk), about one block per SM, so the card holds
// few partial rows of dscale (128 at [1024, 2048] on 132 SMs).  Thread t
// holds the 8 contiguous columns [8t, 8t + 8) of every row.  The block
// takes its rows R at a time (R = 4 at [1024, 2048] bf16): a group's rows
// go to shared memory by cp.async (16 bytes a copy, no registers held),
// the next group's into the other stage of a ring of two while this one
// is reduced (at [1024, 2048] every block's 8 rows are requested at once;
// on an H100, 4 groups of 2 through four stages, or one group of 8,
// measured slower).  Launch 2 is launched with programmatic stream
// serialization and waits for launch 1 in griddepcontrol.wait.
// The 2R sums of a group (x^2 and x g scale per row) reduce through warp
// shuffles and one exchange of the warps' sums in shared memory, added in
// warp order; dx is formed from the staged rows.  The thread keeps its
// columns' share of dscale in fp32 registers across the block's rows and
// writes it once, as the block's partial row of partial [grid, D].
// Launch 2 (rmsnorm_bwd_scale_kernel): a block per tile of CT columns
// (CT = 32, 16 or 8, the widest that still gives a block per SM), its
// 256 / CT parts each summing a contiguous run of partial rows in order,
// then the parts summed in part order through shared memory.
// No atomics: for one plan, two runs give identical bits, which a resumed
// training run relies on to equal an unbroken one.
#include "common.cuh"

namespace {

// planted fault, for the checks only: a row's two sums taken over its
// first warp's share alone
constexpr int kFirstWarpOnly = 1;
constexpr int EPT = 8;          // columns per thread
constexpr int SCALE_THREADS = 256;
// launch 1's ring of a block's groups of x and g rows, both stages
constexpr int MAX_RING_BYTES = 128 * 1024;
constexpr int STAGES = 2;

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

// rows [r, r + R) of x and g, this thread's 8 columns, into a stage (R
// rows of x, then R of g, each row D wide) by cp.async; rows past `end`
// are skipped (never read)
template <typename T, int R>
__device__ __forceinline__ void stage_group(T* st, const T* x, const T* g,
                                            int r, int end, int D, int c0) {
  constexpr int CH = 16 / sizeof(T);  // elements a 16-byte copy
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (r + i >= end) break;
    const size_t off = static_cast<size_t>(r + i) * D + c0;
#pragma unroll
    for (int h = 0; h < EPT / CH; ++h) {
      cp_async16(st + i * D + c0 + h * CH, x + off + h * CH, true);
      cp_async16(st + (R + i) * D + c0 + h * CH, g + off + h * CH, true);
    }
  }
}

// elements of a stage: a group's R rows of x, then its R rows of g
__host__ __device__ constexpr int stage_elems(int R, int D) {
  return 2 * R * D;
}

// R rows a group (1, 2, 4 or 8).  Dynamic shared memory: two stages of
// [2 R][D] T (one where the block has one group).
template <typename T, int R>
__global__ void __launch_bounds__(R >= 4 ? 512 : 1024)
    rmsnorm_bwd_rows_kernel(const T* __restrict__ x,
                            const float* __restrict__ scale,
                            const T* __restrict__ g, T* __restrict__ dx,
                            float* __restrict__ partial, int rows, int D,
                            int chunk, float eps, int fault) {
  extern __shared__ __align__(16) unsigned char rms_smem[];
  T* ring = reinterpret_cast<T*>(rms_smem);
  __shared__ float sums[2 * R][32];
  trigger_dependents();  // launch 2 may take its place on the SMs now
  const int c0 = threadIdx.x * EPT, lane = threadIdx.x % 32,
            warp = threadIdx.x / 32;
  const bool active = c0 < D;
  const int n_warps = fault == kFirstWarpOnly ? 1 : blockDim.x / 32;
  const int first = blockIdx.x * chunk, end = min(rows, first + chunk);
  const int groups = end > first ? (end - first + R - 1) / R : 0;
  const int stage = stage_elems(R, D);
  auto load = [&](int j) {  // group j into stage j % STAGES
    if (active)
      stage_group<T, R>(ring + (j % STAGES) * stage, x, g, first + j * R, end,
                        D, c0);
  };
  float sc[EPT], acc[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) sc[e] = 0.f, acc[e] = 0.f;
  if (active) load8(scale + c0, sc);
  const float inv_d = 1.f / static_cast<float>(D);
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < groups) load(j);
    cp_async_commit();  // possibly empty: every thread counts alike
  }
  for (int j = 0; j < groups; ++j) {
    cp_async_wait<STAGES - 2>();
    // group j has landed, and every thread is past group j - 1, so its
    // stage takes group j + STAGES - 1's loads, in flight from here on
    __syncthreads();
    if (j + STAGES - 1 < groups) load(j + STAGES - 1);
    cp_async_commit();
    const int r = first + j * R;
    const T* xs = ring + (j % STAGES) * stage;
    const T* gs = xs + R * D;
    float part[2 * R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float ss = 0.f, dot = 0.f;
      if (active && r + i < end) {
        float xv[EPT], gv[EPT];
        load8(xs + i * D + c0, xv);
        load8(gs + i * D + c0, gv);
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
          ss += xv[e] * xv[e];
          dot += xv[e] * gv[e] * sc[e];
        }
      }
      part[2 * i] = ss, part[2 * i + 1] = dot;
    }
#pragma unroll
    for (int k = 0; k < 2 * R; ++k) part[k] = warp_sum(part[k]);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 2 * R; ++k) sums[k][warp] = part[k];
    }
    __syncthreads();  // (the next write of sums is past the next barrier)
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (!(active && r + i < end)) continue;
      float tss = 0.f, tdot = 0.f;
      for (int w = 0; w < n_warps; ++w)
        tss += sums[2 * i][w], tdot += sums[2 * i + 1][w];
      const float rr = rsqrtf(tss * inv_d + eps);
      const float c = rr * rr * rr * (tdot * inv_d);
      float xv[EPT], gv[EPT], d[EPT];
      load8(xs + i * D + c0, xv);
      load8(gs + i * D + c0, gv);
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        d[e] = rr * (gv[e] * sc[e]) - xv[e] * c;
        acc[e] += gv[e] * (xv[e] * rr);
      }
      store8(dx + static_cast<size_t>(r + i) * D + c0, d);
    }
  }
  cp_async_wait<0>();
  if (active)
    store8(partial + static_cast<size_t>(blockIdx.x) * D + c0, acc);
}

// dscale[c] = sum over p < parts of partial[p, c], in order of p: thread
// t of a block sums column c0 + t % CT over the partial rows of its part
// t / CT (a contiguous run), then the parts are added in part order.
template <int CT>
__global__ void __launch_bounds__(SCALE_THREADS)
    rmsnorm_bwd_scale_kernel(const float* __restrict__ partial,
                             float* __restrict__ dscale, int parts, int D) {
  constexpr int NP = SCALE_THREADS / CT;  // parts a block
  __shared__ float s[NP][CT];
  grid_dependency_wait();  // launch 1's partial rows are written
  const int col = threadIdx.x % CT, p = threadIdx.x / CT;
  const int c = blockIdx.x * CT + col;
  const int per = (parts + NP - 1) / NP;
  const int lo = p * per, hi = min(parts, lo + per);
  float acc = 0.f;
  if (c < D) {
#pragma unroll 4
    for (int i = lo; i < hi; ++i)
      acc += partial[static_cast<size_t>(i) * D + c];
  }
  s[p][col] = acc;
  __syncthreads();
  if (p == 0 && c < D) {
    float t = s[0][col];
#pragma unroll
    for (int j = 1; j < NP; ++j) t += s[j][col];
    dscale[c] = t;
  }
}

template <typename T, int R>
cudaError_t launch_rows(const void* x, const void* scale, const void* g,
                        void* dx, void* partial, int rows, int D, int chunk,
                        float eps, int threads, int grid, int fault,
                        cudaStream_t s) {
  // above 48 KB only by request, made once for the most any plan asks
  static const cudaError_t attr = cudaFuncSetAttribute(
      rmsnorm_bwd_rows_kernel<T, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_RING_BYTES);
  if (attr != cudaSuccess) return attr;
  const int groups = (chunk + R - 1) / R;
  const size_t smem = static_cast<size_t>(min(groups, STAGES)) *
                      stage_elems(R, D) * sizeof(T);
  if (smem > MAX_RING_BYTES || threads > (R >= 4 ? 512 : 1024))
    return cudaErrorInvalidValue;
  rmsnorm_bwd_rows_kernel<T, R><<<grid, threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const T*>(g), static_cast<T*>(dx),
      static_cast<float*>(partial), rows, D, chunk, eps, fault);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows_r(int group, const void* x, const void* scale,
                          const void* g, void* dx, void* partial, int rows,
                          int D, int chunk, float eps, int threads, int grid,
                          int fault, cudaStream_t s) {
  switch (group) {
    case 8:
      return launch_rows<T, 8>(x, scale, g, dx, partial, rows, D, chunk, eps,
                               threads, grid, fault, s);
    case 4:
      return launch_rows<T, 4>(x, scale, g, dx, partial, rows, D, chunk, eps,
                               threads, grid, fault, s);
    case 2:
      return launch_rows<T, 2>(x, scale, g, dx, partial, rows, D, chunk, eps,
                               threads, grid, fault, s);
    case 1:
      return launch_rows<T, 1>(x, scale, g, dx, partial, rows, D, chunk, eps,
                               threads, grid, fault, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Launch 2, with programmatic stream serialization: its blocks may start
// while launch 1 runs and wait in grid_dependency_wait for its end.
template <int CT>
cudaError_t launch_scale_ct(const float* partial, float* dscale, int parts,
                            int D, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((D + CT - 1) / CT);
  cfg.blockDim = dim3(SCALE_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, rmsnorm_bwd_scale_kernel<CT>, partial, dscale, parts, D);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t launch_scale(int cols, const void* partial, void* dscale,
                         int parts, int D, cudaStream_t s) {
  const float* p = static_cast<const float*>(partial);
  float* out = static_cast<float*>(dscale);
  switch (cols) {
    case 32:
      return launch_scale_ct<32>(p, out, parts, D, s);
    case 16:
      return launch_scale_ct<16>(p, out, parts, D, s);
    case 8:
      return launch_scale_ct<8>(p, out, parts, D, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, g, dx: [rows, D] contiguous, D a multiple of 8 and at most 8 * 1024,
// all 16-byte aligned; scale, dscale: [D] fp32; partial: [grid, D] fp32
// scratch.  The plan (plan_rmsnorm_backward): threads = 32 ceil(D / 256)
// (one thread per 8 columns, whole warps), `grid` blocks of `chunk`
// contiguous rows taken `group` (1, 2, 4 or 8) at a time through a ring of
// two stages of at most 128 KB in all; the second launch's column tile
// `cols` (8, 16 or 32); fault 0 but for a planted fault.
extern "C" int rmsnorm_backward_launch(const void* x, const void* scale,
                                       const void* g, void* dx,
                                       void* partial, void* dscale, int rows,
                                       int D, float eps, int dtype,
                                       int threads, int grid, int chunk,
                                       int group, int cols, int fault,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads % 32 != 0 || threads > 1024 || threads * EPT < D || grid < 1 ||
      chunk < 1 || static_cast<long long>(grid) * chunk < rows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == kFloat32)
    err = launch_rows_r<float>(group, x, scale, g, dx, partial, rows, D,
                               chunk, eps, threads, grid, fault, s);
  else if (dtype == kBFloat16)
    err = launch_rows_r<__nv_bfloat16>(group, x, scale, g, dx, partial, rows,
                                       D, chunk, eps, threads, grid, fault, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_scale(cols, partial, dscale, grid, D, s));
}
