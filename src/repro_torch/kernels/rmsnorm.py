"""RMSNorm: a hand-written CUDA kernel and its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/rmsnorm.py:rmsnorm`` (Pallas) and
computes what the rmsnorm branch of ``repro/models/layers.py:apply_norm``
computes: ``x * rsqrt(mean(x^2, -1) + eps) * scale`` in fp32, written in
x's dtype, with the fp32 scale applied before the cast.

What bounds it on the H100: bytes.  It does ~4 flops per element against
4 (bf16) or 8 (fp32) bytes moved.  The kernel (``csrc/rmsnorm.cu``) reads
each element once into registers, 16 bytes per thread per access, reduces
in fp32 and scales from the same registers, with the scale read as 16-byte
vectors before the reduction; a row of at most 2 KB belongs to one warp
(no barrier), a wider one to one block.  ``plan_rmsnorm`` chooses the path
and the grid from the shapes and the SM count only.

The gradient (``rmsnorm_backward``, ``csrc/rmsnorm_backward.cu``) is
registered as the op's autograd: with r = rsqrt(mean(x^2) + eps) and g the
output's gradient, ``dx = r (g scale) - x r^3 mean(x g scale)`` in x's
dtype and ``dscale = sum over rows of g x r`` in fp32.  The TPU kernel has
no backward (the reference differentiates ``apply_norm``); this one is the
port's own, bound by bytes like the forward.  ``plan_rmsnorm_backward``
plans both launches from the shapes and the SM count: launch 1 gives each
block (about one per SM) a contiguous run of rows, staged group by group
in shared memory by ``cp.async`` through a ring of two stages, so the
next group's loads are in flight during a group's reductions; a thread
holds 8 columns and keeps its share of dscale in registers, written once
as the block's partial row; launch 2, which may start while launch 1
runs (programmatic dependent launch) and waits for it, sums the partial
rows in column tiles, each tile's parts in a fixed order (no atomics, so
two runs give the same bits).  ``rmsnorm_backward_staged``
is that decomposition in plain PyTorch, for the CPU tests.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._sharding import placement_types as _sharding_types
from repro_torch.kernels._sharding import replicated
from repro_torch.kernels._build import plain_float

SOURCE = "src/repro_torch/csrc/rmsnorm.cu"
REPLACES = "src/repro/kernels/rmsnorm.py:24"
# the gradient of that kernel; the reference takes jax.grad of
# repro/models/layers.py:apply_norm (:69) instead
BACKWARD_SOURCE = "src/repro_torch/csrc/rmsnorm_backward.cu"

WARP_ROW_BYTES = 2048   # the widest row one warp holds (4 vectors a lane)
MAX_ROW_BYTES = 2 * 16 * 1024   # a block of 1,024 threads x 2 vectors
FAULT_FIRST_WARP_ONLY = 1       # csrc: kFirstWarpOnly, for the checks only
BACKWARD_MAX_D = 8 * 1024       # a thread per 8 columns, 1,024 threads


class NormPlan(NamedTuple):
    """A launch: one warp per row (``per_warp``, ``threads // 32`` rows a
    block, walked grid-stride) or one block per row; ``vecs`` 16-byte
    vectors per thread."""
    per_warp: bool
    vecs: int
    threads: int
    grid: int


@functools.lru_cache(maxsize=512, typed=True)  # a launch pays no planning
def plan_rmsnorm(rows: int, D: int, itemsize: int,
                 sm_count: int) -> NormPlan:
    """The launch for ``rows`` rows of D elements of ``itemsize`` bytes,
    from shapes only.  A row of at most 2 KB: one warp, 1, 2 or 4 vectors
    a lane, and as many rows a block (up to 8) as leave at least one block
    per SM, at most a full SM's threads of blocks per SM ([300, 1024] bf16
    on 132 SMs: 2 rows a block, 150 blocks; [4, 512]: 4 blocks of one
    warp).  A wider row, up to 32 KB: one block of 2 vectors a thread
    (bf16 [2048, 2048]: 2,048 blocks of 128 threads)."""
    for name, v in (("rows", rows), ("D", D), ("itemsize", itemsize),
                    ("sm_count", sm_count)):
        if not isinstance(v, int) or isinstance(v, bool):
            raise TypeError(f"plan_rmsnorm: {name} must be an int, "
                            f"not {type(v).__name__}")
    nvec = max(1, D * itemsize // 16)
    if D * itemsize <= WARP_ROW_BYTES:
        vecs = next(v for v in (1, 2, 4) if 32 * v >= nvec)
        rpb = next((r for r in (8, 4, 2) if -(-rows // r) >= sm_count), 1)
        threads = 32 * rpb
        per_sm = min(32, 2048 // threads)
        return NormPlan(True, vecs, threads,
                        max(1, min(-(-rows // rpb), sm_count * per_sm)))
    return NormPlan(False, 2, -(-nvec // 64) * 32, max(1, rows))


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """The same function in plain PyTorch (the CPU path and the oracle),
    in fp32 (fp64 for fp64 x, which gradcheck takes)."""
    xf = plain_float(x)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def rmsnorm_backward_plain(x: torch.Tensor, scale: torch.Tensor,
                           g: torch.Tensor, eps: float = 1e-5):
    """The gradient in plain PyTorch (the CPU path and the oracle):
    (dx in x's dtype, dscale fp32 [D]) for the output's gradient g."""
    D = x.shape[-1]
    xf, gf = plain_float(x), plain_float(g)
    gs = gf * scale
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    dx = r * gs - xf * (r * r * r) * (xf * gs).mean(-1, keepdim=True)
    dscale = (gf * (xf * r)).reshape(-1, D).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=())
def _rmsnorm_op(x: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    raise NotImplementedError(f"rmsnorm: no implementation on {x.device}")


@_rmsnorm_op.register_kernel("cpu")
def _rmsnorm_cpu(x, scale, eps):
    return rmsnorm_plain(x, scale, eps)


@_rmsnorm_op.register_fake
def _rmsnorm_fake(x, scale, eps):
    return torch.empty_like(x)


_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float]
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float,
            plan: Optional[NormPlan] = None, fault: int = 0) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors, by ``plan``
    (``plan_rmsnorm`` unless given); ``fault`` plants a fault for the
    checks only."""
    D = x.shape[-1]
    _build.require(x.dtype in _build.DTYPE_CODES,
                   f"rmsnorm: dtype {x.dtype} not supported")
    _build.require(x.is_contiguous(), "rmsnorm: x must be contiguous")
    _build.require(D % 8 == 0, f"rmsnorm: D={D} is not a multiple of 8")
    _build.require(D * x.element_size() <= MAX_ROW_BYTES,
                   f"rmsnorm: a row of {D} is wider than "
                   f"{MAX_ROW_BYTES // 1024} KB")
    _build.require(scale.dtype == torch.float32 and scale.shape == (D,)
                   and scale.is_contiguous() and scale.device == x.device,
                   "rmsnorm: scale must be a contiguous fp32 [D] on x's device")
    _build.require(x.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0,
                   "rmsnorm: x and scale must start on 16-byte boundaries")
    out = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return out
    if plan is None:
        plan = plan_rmsnorm(rows, D, x.element_size(),
                            _build.sm_count(x.device))
    fn = _build.entry("rmsnorm_launch", _ARGTYPES)
    _build.check(fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D,
                    eps, _build.DTYPE_CODES[x.dtype], int(plan.per_warp),
                    plan.vecs, plan.threads, plan.grid, fault,
                    _build.stream_handle(x)),
                 "rmsnorm")
    return out


@_rmsnorm_op.register_kernel("cuda")
def _rmsnorm_cuda(x, scale, eps):
    out = _launch(x, scale, eps)
    if out.numel():
        rmsnorm.launches += 1
    return out


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x [..., D]; scale [D] fp32.  CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    return _rmsnorm_op(x, scale, float(eps))


rmsnorm.launches = 0    # kernel launches (CUDA path only)


# ------------------------------------------------------------- backward --
@torch.library.custom_op("repro_torch::rmsnorm_backward", mutates_args=())
def _rmsnorm_bwd_op(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                    eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    raise NotImplementedError(
        f"rmsnorm_backward: no implementation on {x.device}")


@_rmsnorm_bwd_op.register_kernel("cpu")
def _rmsnorm_bwd_cpu(x, scale, g, eps):
    return rmsnorm_backward_plain(x, scale, g, eps)


@_rmsnorm_bwd_op.register_fake
def _rmsnorm_bwd_fake(x, scale, g, eps):
    return torch.empty_like(x), torch.empty_like(scale)


BACKWARD_RING_BYTES = 128 * 1024   # launch 1's ring of x and g rows


class NormBackwardPlan(NamedTuple):
    """Both launches of the backward: ``threads`` (one per 8 columns, whole
    warps); ``grid`` blocks of ``chunk`` contiguous rows each, taken
    ``group`` rows at a time through a ring of two stages in shared memory
    (the next group loading while one reduces); each block writes one
    partial row of dscale, which the second launch sums in tiles of
    ``cols`` columns."""
    threads: int
    grid: int
    chunk: int
    group: int
    cols: int


@functools.lru_cache(maxsize=512, typed=True)  # a launch pays no planning
def plan_rmsnorm_backward(rows: int, D: int, itemsize: int,
                          sm_count: int) -> NormBackwardPlan:
    """The backward's plan from shapes only.  At most one block per SM
    (``chunk`` = ceil(rows / sm_count)), so the card holds at most
    ``sm_count`` partial rows; ``group`` the most rows, of 8, 4, 2 or 1,
    whose x and g fit a stage of the 128 KB ring of two and leave the
    block two groups; ``cols`` the widest column tile of 32, 16 or 8 that
    still gives the second launch a block per SM ([1024, 2048] bf16 on
    132 SMs: 256 threads, 128 blocks of 8 rows in 2 groups of 4, tiles of
    8 columns)."""
    for name, v in (("rows", rows), ("D", D), ("itemsize", itemsize),
                    ("sm_count", sm_count)):
        if not isinstance(v, int) or isinstance(v, bool):
            raise TypeError(f"plan_rmsnorm_backward: {name} must be an int, "
                            f"not {type(v).__name__}")
    threads = 32 * -(-D // 256)
    chunk = max(1, -(-rows // sm_count))
    grid = max(1, -(-rows // chunk))
    row_bytes = 2 * D * itemsize                  # a row of x and one of g
    group = next((r for r in (8, 4, 2) if 2 * r <= chunk and
                  2 * r * row_bytes <= BACKWARD_RING_BYTES), 1)
    cols = next((c for c in (32, 16) if -(-D // c) >= sm_count), 8)
    return NormBackwardPlan(threads, grid, chunk, group, cols)


def rmsnorm_backward_staged(x: torch.Tensor, scale: torch.Tensor,
                            g: torch.Tensor, eps: float = 1e-5,
                            plan: Optional[NormBackwardPlan] = None):
    """The kernel's decomposition in plain PyTorch, in fp32 (fp64 for fp64
    x): dx per row as ``rmsnorm_backward_plain``; dscale as the kernel sums
    it, each block's ``chunk`` rows into one partial row (row by row, in
    order), then the partial rows in contiguous parts of the second
    launch's tiles, the parts added in order.  ``plan`` defaults to
    ``plan_rmsnorm_backward`` at 132 SMs."""
    D = x.shape[-1]
    xf, gf = plain_float(x).reshape(-1, D), plain_float(g).reshape(-1, D)
    rows = xf.shape[0]
    if plan is None:
        plan = plan_rmsnorm_backward(rows, D, x.element_size(), 132)
    gs = gf * scale
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    dx = r * gs - xf * (r * r * r) * (xf * gs).mean(-1, keepdim=True)
    term = gf * (xf * r)
    partial = torch.zeros(plan.grid, D, dtype=xf.dtype)
    for b in range(plan.grid):
        for i in range(b * plan.chunk, min(rows, (b + 1) * plan.chunk)):
            partial[b] += term[i]
    n_parts = 256 // plan.cols
    per = -(-plan.grid // n_parts)
    dscale = torch.zeros(D, dtype=xf.dtype)
    for p in range(n_parts):
        s = torch.zeros(D, dtype=xf.dtype)
        for i in range(p * per, min(plan.grid, (p + 1) * per)):
            s += partial[i]
        dscale += s
    return dx.reshape(x.shape).to(x.dtype), dscale.to(scale.dtype)


_BWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                 + [ctypes.c_float] + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def _launch_backward(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                     eps: float, fault: int = 0,
                     plan: Optional[NormBackwardPlan] = None):
    """One run of the backward (two launches) on CUDA tensors, by ``plan``
    (``plan_rmsnorm_backward`` unless given); ``fault`` plants a fault for
    the checks only."""
    D = x.shape[-1]
    _build.require(x.dtype in _build.DTYPE_CODES and g.dtype == x.dtype,
                   f"rmsnorm_backward: dtypes {x.dtype}/{g.dtype}")
    _build.require(g.shape == x.shape and x.is_contiguous()
                   and g.is_contiguous() and g.device == x.device,
                   "rmsnorm_backward: x and g must be contiguous, of one "
                   "shape, on one device")
    _build.require(0 < D <= BACKWARD_MAX_D and D % 8 == 0,
                   f"rmsnorm_backward: D={D} is not a multiple of 8 in "
                   f"(0, {BACKWARD_MAX_D}]")
    _build.require(scale.dtype == torch.float32 and scale.shape == (D,)
                   and scale.is_contiguous() and scale.device == x.device,
                   "rmsnorm_backward: scale must be a contiguous fp32 [D] on "
                   "x's device")
    _build.require(all(t.data_ptr() % 16 == 0 for t in (x, scale, g)),
                   "rmsnorm_backward: x, scale and g must start on 16-byte "
                   "boundaries")
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    rows = x.numel() // D
    if rows == 0:
        return dx, dscale.zero_()
    if plan is None:
        plan = plan_rmsnorm_backward(rows, D, x.element_size(),
                                     _build.sm_count(x.device))
    partial = torch.empty(plan.grid, D, dtype=torch.float32, device=x.device)
    fn = _build.entry("rmsnorm_backward_launch", _BWD_ARGTYPES)
    _build.check(fn(x.data_ptr(), scale.data_ptr(), g.data_ptr(),
                    dx.data_ptr(), partial.data_ptr(), dscale.data_ptr(),
                    rows, D, eps, _build.DTYPE_CODES[x.dtype], plan.threads,
                    plan.grid, plan.chunk, plan.group, plan.cols, fault,
                    _build.stream_handle(x)),
                 "rmsnorm_backward")
    return dx, dscale


@_rmsnorm_bwd_op.register_kernel("cuda")
def _rmsnorm_bwd_cuda(x, scale, g, eps):
    if g.data_ptr() % 16:   # a view autograd handed over: an aligned copy
        g = g.clone()
    out = _launch_backward(x, scale, g, eps)
    if x.numel():
        rmsnorm_backward.launches += 1
    return out


def rmsnorm_backward(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                     eps: float = 1e-5):
    """(dx, dscale) of ``rmsnorm(x, scale, eps)`` for the output's gradient
    g.  CUDA tensors launch the kernel, CPU tensors take the plain
    version."""
    return _rmsnorm_bwd_op(x, scale, g.contiguous(), float(eps))


rmsnorm_backward.launches = 0   # kernel runs (CUDA path only)


def _setup_context(ctx, inputs, output):
    x, scale, eps = inputs
    ctx.save_for_backward(x, scale)
    ctx.eps = eps


def _backward(ctx, g):
    x, scale = ctx.saved_tensors
    dx, dscale = rmsnorm_backward(x, scale, g, ctx.eps)
    return dx, dscale, None


torch.library.register_autograd("repro_torch::rmsnorm", _backward,
                                setup_context=_setup_context)


# ------------------------------------------------------------- sharding --
def _sharding(x, scale, eps):
    """Rows (any leading dim of x) split, scale whole: every rank
    normalises its own rows.  D is never split."""
    S, R, _ = _sharding_types()
    return [([S(d)], [S(d), R, None]) for d in range(x.ndim - 1)] \
        + [replicated(1, (x, scale, eps))]


def _backward_sharding(x, scale, g, eps):
    """Rows split as in the forward: dx keeps them, and each rank's
    dscale sums its own rows, a partial sum over the split."""
    S, R, P = _sharding_types()
    return [([S(d), P], [S(d), R, S(d), None]) for d in range(x.ndim - 1)] \
        + [replicated(2, (x, scale, g, eps))]


SHARDING = (("rmsnorm", _sharding), ("rmsnorm_backward", _backward_sharding))
