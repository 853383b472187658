"""Grouped expert matmul: a hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``repro/kernels/moe_gmm.py:moe_gmm`` (Pallas) and
computes what ``repro/kernels/ref.py:moe_gmm`` computes: ``x [E,C,D] @
w [E,D,F] -> [E,C,F]``, one product per expert, summed over D in fp32 and
written in x's dtype.

What bounds it on the H100: bytes.  The MoE layer's capacity dispatch
gives every expert its C rows (6 at a deepseek decode step, 12 to 64 at
its prefill buckets) whether or not a token went there, so each call
streams the whole weight tensor for a few dozen rows.  In bf16 the kernels
(``csrc/moe_gmm.cu``) are a persistent grid of one block per SM walking
(expert, F tile, row tile) work items that hold all of an expert's rows
up to 128, so each weight element is read from device memory once: w's
tiles reach shared memory in bf16 by ``cp.async`` through a ring of
stages, and the products run on the tensor cores: ``mma.sync`` out^T with
the rows on N = 8 up to 8 rows (decode), ``wgmma`` with 64 rows a
warpgroup above.  ``plan_gmm`` chooses the tile and the grid from the
shapes and the SM count only; ``plan_items`` lists the walk the kernel
makes.  fp32 keeps a CUDA-core
kernel with the same ownership (a block per 64 columns of one expert).
No divisibility is required of C, D or F.

The gradient (``moe_gmm_backward``, ``csrc/moe_gmm_backward.cu``) is
registered as the op's autograd.  The TPU kernel has no backward (the
reference differentiates the einsums of ``repro/models/moe.py:93-96``);
this one is the port's own: ``dx = dy wᵀ`` and ``dw = xᵀ dy``, two
launches in bf16 with each operand read as it is stored
(``plan_gmm_backward``): where every row is 16-byte aligned, warp-
specialised kernels fed by TMA (dw keeping dy's tile resident where R <=
128, its outputs leaving by TMA stores), else the forward's cp.async
wgmma kernel; CUDA-core kernels in fp32.
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

SOURCE = "src/repro_torch/csrc/moe_gmm.cu"
REPLACES = "src/repro/kernels/moe_gmm.py:34"
# the gradient of that kernel; the reference takes jax.grad of the
# einsums of repro/models/moe.py:93-96 instead
BACKWARD_SOURCE = "src/repro_torch/csrc/moe_gmm_backward.cu"

SMEM_LIMIT = 232_448    # bytes of shared memory a block may use (227 KB)
SMEM_PER_SM = 233_472   # bytes an SM holds (228 KB), 1 KB of it per block
# planted faults (csrc: kStaleTile, kDropRowGroup, kStaleResident), for
# the checks only; in the backward, the first plants in launch dx (each w
# stage holds the step before's F tile), the second in launch dw (R's last
# 8-row group left out of the sum), the third in launch dw where dy's tile
# is resident (a block's later units keep its first unit's dy tile)
FAULT_STALE_TILE = 1
FAULT_DROP_ROW_GROUP = 2
FAULT_STALE_RESIDENT = 3


class GmmTile(NamedTuple):
    """One of the bf16 kernels (csrc: ``M_*`` and ``G_*`` constants):
    ``rows`` x ``cols`` of out per work item, ``warps`` of 32 threads, a
    ring of ``stages`` stages ``depth`` deep, one block per SM; ``wgmma``
    for the warpgroup kernel, else the mma.sync one."""
    rows: int
    cols: int
    warps: int
    depth: int
    stages: int
    wgmma: bool

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory.  mma.sync: per stage a [depth][cols + 8]
        tile of w and a [rows][depth + 8] tile of x (rows padded by 16
        bytes).  wgmma: per stage [rows][depth] of x and [depth][cols] of
        w, unpadded (swizzled), and 1 KB to align the ring to 1024 B."""
        if self.wgmma:
            return self.stages * 2 * (self.rows + self.cols) * self.depth \
                + 1024
        return self.stages * 2 * (self.depth * (self.cols + 8)
                                  + self.rows * (self.depth + 8))


# by the kernel's tile index: R <= 8 (decode: out^T, the rows on the mma's
# N = 8), and R > 8 (wgmma, 64 rows a warpgroup)
GMM_TILES = (GmmTile(8, 64, 4, 128, 5, False),
             GmmTile(128, 256, 8, 64, 4, True))


class GmmPlan(NamedTuple):
    """A bf16 call: tile ``GMM_TILES[tile]``; ``items`` = E x f_tiles x
    r_tiles work items, walked by ``grid`` persistent blocks in chunks of
    ``chunk`` consecutive items: block b takes chunks b, b + grid, b + 2
    grid, ... (the forward: chunks of one item).  With ``cluster`` > 1 the
    blocks form thread block clusters of that many, and cluster k takes
    chunks k, k + grid / cluster, ..., its block r the chunk's r-th item
    (the chunk is ``cluster`` row tiles that share an operand)."""
    tile: int
    f_tiles: int
    r_tiles: int
    items: int
    grid: int
    chunk: int = 1
    cluster: int = 1

    @property
    def spec(self) -> GmmTile:
        return GMM_TILES[self.tile]


@functools.lru_cache(maxsize=512, typed=True)  # a launch pays no planning
def plan_gmm(E: int, R: int, D: int, F: int, sm_count: int) -> GmmPlan:
    """The bf16 kernel's plan, from shapes only: up to 8 rows the
    mma.sync tile (64 columns), else the wgmma tile (128 rows x 256
    columns; row tiles above 128 rows); a persistent grid of one block per
    SM, never more than the items.  Takes plain ints, never a tensor
    (deepseek's decode, E 64, R 6, D 2048, F 1408, on 132 SMs: 64 x 22
    items over 132 blocks, each item 16 ring steps 128 deep)."""
    for name, v in (("E", E), ("R", R), ("D", D), ("F", F),
                    ("sm_count", sm_count)):
        if not isinstance(v, int) or isinstance(v, bool):
            raise TypeError(f"plan_gmm: {name} must be an int, "
                            f"not {type(v).__name__}")
    tile = 0 if R <= GMM_TILES[0].rows else 1
    spec = GMM_TILES[tile]
    f_tiles = max(1, -(-F // spec.cols))
    r_tiles = max(1, -(-R // spec.rows))
    items = E * f_tiles * r_tiles
    return GmmPlan(tile, f_tiles, r_tiles, items,
                   max(1, min(items, sm_count)))


def plan_items(plan: GmmPlan, block: int) -> list:
    """The (expert, F tile, row tile) items block ``block`` walks, in its
    order (the kernels' walk): row tiles fastest, then F tiles, so the
    blocks running side by side read neighbouring tiles of the same rows
    of w; ``plan.chunk`` consecutive items at a time (in a cluster: the
    block's one item of each chunk)."""
    out = []
    cl = plan.cluster
    for c in range(block // cl, -(-plan.items // plan.chunk), plan.grid // cl):
        items = range(c * plan.chunk, min((c + 1) * plan.chunk, plan.items))
        for item in items[block % cl::cl] if cl > 1 else items:
            rest, rt = divmod(item, plan.r_tiles)
            e, ft = divmod(rest, plan.f_tiles)
            out.append((e, ft, rt))
    return out


class GmmBackwardPlan(NamedTuple):
    """The bf16 backward's two launches, each a ``GmmPlan`` of the wgmma
    tile whose "rows" are the product's M and "columns" its N: launch dx
    (M = R, N = D, the sum over F) and launch dw (M = D, N = F, the sum
    over R); ``plan_items`` gives a block's walk of either.  ``tma``: the
    warp-specialised TMA kernels (``GMM_BWD_TMA``), else the cp.async
    kernel (``GMM_TILES[1]``); ``resident``: dw keeps dy's [R x 256] tile
    in shared memory while it walks a unit of items, all the D tiles of
    one (expert, F tile): ``dw.chunk`` is then the D tiles.  A launch's
    ``cluster`` > 1 (dx on the TMA path with 2 to 4 row tiles, e.g.
    mixtral's R = 320): the row tiles of one (expert, D tile) run side by
    side in a thread block cluster and share w's tile by multicast."""
    dx: GmmPlan
    dw: GmmPlan
    tma: bool
    resident: bool


class GmmBwdTile(NamedTuple):
    """A launch of the TMA backward (csrc: ``T_*``, ``*_STAGES`` and
    ``TmaLayout``): a ring of ``stages`` stages of ``stage_bytes``, an
    output buffer and a resident tile, all 128-byte swizzled from a
    1024-byte boundary, and a full and an empty mbarrier per stage plus
    the resident tile's two; 12 warps (two consumer warpgroups of 64 rows,
    one producer), 128 x 256 outputs an item, the ring 64 deep."""
    stages: int
    stage_bytes: int
    out_bytes: int
    resident_bytes: int

    @property
    def smem_bytes(self) -> int:
        return (self.stages * self.stage_bytes + self.out_bytes
                + self.resident_bytes + 8 * (2 * self.stages + 2) + 1024)


# dx: dy [128][64] + w [256][64] a stage; dw streamed: x [64][128] + dy
# [64][256] a stage and a [128][256] output buffer; dw with dy resident:
# x a stage, the buffer and dy's [128][256]
GMM_BWD_TMA = {"dx": GmmBwdTile(4, 49152, 0, 0),
               "dw": GmmBwdTile(3, 49152, 65536, 0),
               "dw_resident": GmmBwdTile(6, 16384, 65536, 65536)}
RESIDENT_ROWS = 128     # R up to this keeps dy's tile resident (64 KB)


MAX_CLUSTER = 4     # w's tile in quarters: at most four blocks share it


def _plan_backward(E: int, R: int, D: int, F: int, sm_count: int,
                   tma: bool) -> GmmBackwardPlan:
    spec = GMM_TILES[1]

    def walk(M, N, chunk, cluster):
        n_tiles, m_tiles = max(1, -(-N // spec.cols)), max(1, -(-M // spec.rows))
        items = E * n_tiles * m_tiles
        chunk, cluster = chunk(m_tiles), cluster(m_tiles)
        return GmmPlan(1, n_tiles, m_tiles, items,
                       cluster * max(1, min(items // chunk,
                                             sm_count // cluster)),
                       chunk, cluster)
    resident = tma and R <= RESIDENT_ROWS
    # dx: R's 2 to 4 row tiles in a cluster (measured 10% faster at
    # mixtral's shape; clusters of dw's D tiles, or of dx's D tiles
    # sharing dy, measured no faster or slower)
    cl = lambda m: m if tma and 2 <= m <= min(MAX_CLUSTER, sm_count) else 1
    dx = walk(R, D, cl, cl)
    dw = walk(D, F, lambda m: m if resident else 1, lambda m: 1)
    return GmmBackwardPlan(dx, dw, tma, resident)


@functools.lru_cache(maxsize=512, typed=True)  # a launch pays no planning
def plan_gmm_backward(E: int, R: int, D: int, F: int,
                      sm_count: int) -> GmmBackwardPlan:
    """The bf16 backward's plan, from shapes only: each launch walks 128 x
    256 output tiles with a persistent grid of one block per SM, never
    more than the items (dw with dy resident: than the units).  The TMA
    kernels wherever every row of x, w and dy is 16-byte aligned (D and F
    multiples of 8: TMA's row strides), the cp.async kernel elsewhere;
    dy resident in dw where R <= 128.  Takes plain ints, never a tensor
    (deepseek's train row, E 64, R 128, D 2048, F 1408, on 132 SMs: dx 64
    x 8 items of 22 ring steps; dw 64 x 6 units of 16 items of 2;
    mixtral-8x22b's, E 8, R 320, D 6144, F 16384: dx in clusters of R's 3
    row tiles, dw 24,576 items of 5)."""
    for name, v in (("E", E), ("R", R), ("D", D), ("F", F),
                    ("sm_count", sm_count)):
        if not isinstance(v, int) or isinstance(v, bool):
            raise TypeError(f"plan_gmm_backward: {name} must be an int, "
                            f"not {type(v).__name__}")
    return _plan_backward(E, R, D, F, sm_count, D % 8 == 0 and F % 8 == 0)


def moe_gmm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch (the CPU path and the oracle),
    summed in fp32 (fp64 for fp64 inputs, which gradcheck takes)."""
    return torch.einsum("ecd,edf->ecf", plain_float(x),
                        plain_float(w)).to(x.dtype)


def moe_gmm_backward_plain(x: torch.Tensor, w: torch.Tensor,
                           dy: torch.Tensor):
    """The gradient in plain PyTorch (the CPU path and the oracle): (dx =
    dy wᵀ, dw = xᵀ dy) for ``moe_gmm(x, w)``'s gradient ``dy``, summed in
    fp32 (fp64 for fp64 inputs) and written in x's and w's dtypes."""
    dyf = plain_float(dy)
    dx = torch.einsum("ecf,edf->ecd", dyf, plain_float(w))
    dw = torch.einsum("ecd,ecf->edf", plain_float(x), dyf)
    return dx.to(x.dtype), dw.to(w.dtype)


@torch.library.custom_op("repro_torch::moe_gmm", mutates_args=())
def _moe_gmm_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    raise NotImplementedError(f"moe_gmm: no implementation on {x.device}")


@_moe_gmm_op.register_kernel("cpu")
def _moe_gmm_cpu(x, w):
    return moe_gmm_plain(x, w)


@_moe_gmm_op.register_fake
def _moe_gmm_fake(x, w):
    return x.new_empty(x.shape[0], x.shape[1], w.shape[2])


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13 + [ctypes.c_void_p]


def _rows_aligned(t: torch.Tensor) -> bool:
    """Every row of the contiguous ``t`` starts on a 16-byte boundary."""
    return t.data_ptr() % 16 == 0 and t.shape[-1] * t.element_size() % 16 == 0


def _launch(x: torch.Tensor, w: torch.Tensor, plan: Optional[GmmPlan] = None,
            fault: int = 0) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors, by ``plan`` (bf16:
    ``plan_gmm`` unless given).  A plan that leaves items out, or a
    ``fault``, only plants a fault for the checks: the output then starts
    as NaN, so whatever the kernel does not write fails them."""
    _build.require(x.dim() == 3 and w.dim() == 3 and x.shape[0] == w.shape[0]
                   and x.shape[2] == w.shape[1],
                   f"moe_gmm: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    _build.require(x.dtype in _build.DTYPE_CODES and w.dtype == x.dtype,
                   f"moe_gmm: dtypes {x.dtype}/{w.dtype}")
    _build.require(x.is_contiguous() and w.is_contiguous()
                   and w.device == x.device,
                   "moe_gmm: x and w must be contiguous on one device")
    E, R, D = x.shape
    F = w.shape[2]
    out = x.new_empty(E, R, F)
    if out.numel() == 0:
        return out
    if plan is not None or fault:
        out.fill_(float("nan"))
    if plan is None:
        plan = plan_gmm(E, R, D, F, _build.sm_count(x.device))
    fn = _build.entry("moe_gmm_launch", _ARGTYPES)
    _build.check(fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), E, R, D, F,
                    int(_rows_aligned(x)), int(_rows_aligned(w)),
                    _build.DTYPE_CODES[x.dtype], plan.tile, plan.items,
                    plan.f_tiles, plan.r_tiles, plan.grid, fault,
                    _build.stream_handle(x)),
                 "moe_gmm")
    return out


@_moe_gmm_op.register_kernel("cuda")
def _moe_gmm_cuda(x, w):
    out = _launch(x, w)
    if out.numel():
        moe_gmm.launches += 1
    return out


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [E,C,D] @ w [E,D,F] -> [E,C,F].  CUDA tensors launch the kernel,
    CPU tensors take the plain version."""
    return _moe_gmm_op(x, w)


moe_gmm.launches = 0    # kernel launches (CUDA path only)


# ------------------------------------------------------------- backward --
@torch.library.custom_op("repro_torch::moe_gmm_backward", mutates_args=())
def _moe_gmm_bwd_op(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    raise NotImplementedError(
        f"moe_gmm_backward: no implementation on {x.device}")


@_moe_gmm_bwd_op.register_kernel("cpu")
def _moe_gmm_bwd_cpu(x, w, dy):
    return moe_gmm_backward_plain(x, w, dy)


@_moe_gmm_bwd_op.register_fake
def _moe_gmm_bwd_fake(x, w, dy):
    return torch.empty_like(x), torch.empty_like(w)


_BWD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 23
                 + [ctypes.c_void_p])


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its base is not on a 16-byte boundary
    (a view at an odd offset): TMA reads from aligned bases only."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_backward(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                     plan: Optional[GmmBackwardPlan] = None,
                     fault: int = 0):
    """One run of the backward (launches dx and dw) on CUDA tensors, by
    ``plan`` (bf16: ``plan_gmm_backward`` unless given; ``_plan_backward``
    with ``tma=False`` takes the cp.async kernel at any shape).  A
    ``fault`` only plants a fault for the checks."""
    _build.require(x.dim() == 3 and w.dim() == 3 and dy.dim() == 3
                   and x.shape[0] == w.shape[0] == dy.shape[0]
                   and x.shape[2] == w.shape[1] and dy.shape[1] == x.shape[1]
                   and dy.shape[2] == w.shape[2],
                   f"moe_gmm_backward: shapes x {tuple(x.shape)}, w "
                   f"{tuple(w.shape)}, dy {tuple(dy.shape)}")
    _build.require(x.dtype in _build.DTYPE_CODES and w.dtype == x.dtype
                   and dy.dtype == x.dtype,
                   f"moe_gmm_backward: dtypes {x.dtype}/{w.dtype}/{dy.dtype}")
    _build.require(all(t.is_contiguous() and t.device == x.device
                       for t in (x, w, dy)),
                   "moe_gmm_backward: x, w and dy must be contiguous on one "
                   "device")
    E, R, D = x.shape
    F = w.shape[2]
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    if x.numel() == 0 or w.numel() == 0:
        return dx.zero_(), dw.zero_()
    if plan is None:
        plan = plan_gmm_backward(E, R, D, F, _build.sm_count(x.device))
    if plan.tma and x.dtype == torch.bfloat16:
        x, w, dy = _aligned(x), _aligned(w), _aligned(dy)
    fn = _build.entry("moe_gmm_backward_launch", _BWD_ARGTYPES)
    _build.check(fn(x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                    dw.data_ptr(), E, R, D, F, int(_rows_aligned(x)),
                    int(_rows_aligned(w)), int(_rows_aligned(dy)),
                    _build.DTYPE_CODES[x.dtype], int(plan.tma),
                    int(plan.resident), plan.dx.items, plan.dx.f_tiles,
                    plan.dx.r_tiles, plan.dx.grid, plan.dx.chunk,
                    plan.dx.cluster, plan.dw.items, plan.dw.f_tiles,
                    plan.dw.r_tiles, plan.dw.grid, plan.dw.chunk,
                    plan.dw.cluster, fault, _build.stream_handle(x)),
                 "moe_gmm_backward")
    return dx, dw


@_moe_gmm_bwd_op.register_kernel("cuda")
def _moe_gmm_bwd_cuda(x, w, dy):
    grads = _launch_backward(x, w, dy)
    if x.numel() and w.numel():
        moe_gmm_backward.launches += 1
    return grads


def moe_gmm_backward(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor):
    """(dx, dw) of ``moe_gmm(x, w)`` for its gradient ``dy``.  CUDA
    tensors launch the kernels, CPU tensors take the plain version."""
    return _moe_gmm_bwd_op(x, w, dy.contiguous())


moe_gmm_backward.launches = 0   # kernel runs (CUDA path only)


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, dy):
    x, w = ctx.saved_tensors
    return moe_gmm_backward(x, w, dy)


torch.library.register_autograd("repro_torch::moe_gmm", _backward,
                                setup_context=_setup_context)


# ------------------------------------------------------------- sharding --
def _sharding(x, w):
    """x [E,R,D] @ w [E,D,F]: experts split (each rank its own experts),
    rows split on x and the output, F split on w and the output, or D
    split on x and w, whose local products are partial sums of the
    output."""
    S, R, P = _sharding_types()
    return [([S(0)], [S(0), S(0)]), ([S(1)], [S(1), R]),
            ([S(2)], [R, S(2)]), ([P], [S(2), S(1)]), replicated(1, (x, w))]


def _backward_sharding(x, w, dy):
    """The forward's rows for (dx, dw): experts split; rows split (dx
    split on rows, dw = xᵀ dy a partial sum); F split (dx = dy wᵀ a
    partial sum, dw split on F); D split (dx split on D, dw on D)."""
    S, R, P = _sharding_types()
    return [([S(0), S(0)], [S(0), S(0), S(0)]),
            ([S(1), P], [S(1), R, S(1)]),
            ([P, S(2)], [R, S(2), S(2)]),
            ([S(2), S(1)], [S(2), S(1), R]), replicated(2, (x, w, dy))]


SHARDING = (("moe_gmm", _sharding), ("moe_gmm_backward", _backward_sharding))
