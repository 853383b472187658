"""Mamba2 SSD chunk scan: a hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``repro/kernels/mamba_scan.py:
mamba_chunk_scan_chunked`` (Pallas) and computes what
``repro/models/ssm.py:mamba2_forward`` computes between its projections
and its gate: over chunked views, the intra-chunk term
``(C Bᵀ ⊙ decay mask) x̄``, the carried-state term ``C e^{cum} h`` and the
state ``h <- h e^{cum[-1]} + Σ_j B_j e^{cum[-1] - cum_j} x̄_j`` carried
from chunk to chunk; it returns y and the final state, which the model
keeps as its decode cache.

What bounds it on the H100: operations at zamba2's widths: the
intra-chunk product in fp32 and, with bf16 B and C, the carried term and
the state update at three bf16 products each (the split).  The Pallas
grid (B, nc) walks the chunks in order with every head's state in
one program.  The kernel (``csrc/mamba_scan.cu``) regroups the caller's
chunks into kernel chunks of ``SCAN_CHUNK`` rows (``plan_scan``, shared
with the mLSTM scan; the caller's cum is rebased per kernel chunk,
``rebase``) and runs in stages over (b, kernel chunk, head, tile): the
state entering each kernel chunk (one ordered pass over the kernel
chunks per (b, head, 16 rows of P)), ``C Bᵀ`` once per (b, kernel chunk)
for every head, then the outputs.  ``mamba_chunk_scan_staged`` is the
same plan and stages in plain PyTorch, for the CPU tests.

The gradient (``mamba_chunk_scan_backward``, ``csrc/
mamba_scan_backward.cu``) is registered as the op's autograd.  The TPU
kernel has no backward (the reference differentiates its pure-JAX
``ssm.py`` scan); this one is the port's own.  The forward keeps its
schema and saves nothing, so the backward recomputes the state entering
each kernel chunk but the first by the forward's ordered pass and runs
the same pass backwards for the cotangent of the state leaving each but
the last, then per (b, kernel chunk, group of heads,
``plan_scan_backward``) forms dx̄, dg and the group's share of dB and
dC, and sums the shares in order.  bf16 B and C run every product on
the tensor cores, each fp32 operand split into ``BACKWARD_PARTS`` bf16
parts; fp32 ones as three TF32 products (3xTF32).  The rebase and its adjoint are
launches of the kernel too (``rebase``, ``rebase_adjoint`` are their
plain versions).  ``mamba_chunk_scan_backward_staged`` is its plan and
rounding in plain PyTorch, for the CPU tests.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._sharding import placement_types as _sharding_types
from repro_torch.kernels._sharding import replicated
from repro_torch.kernels._build import plain_float

SOURCE = "src/repro_torch/csrc/mamba_scan.cu"
REPLACES = "src/repro/kernels/mamba_scan.py:73"
MAX_Q, MAX_N = 256, 64
SCAN_CHUNK = 64     # rows of a kernel chunk (csrc/scan.cuh kL)
SPLIT_PARTS = 3     # bf16 parts of an fp32 operand (csrc/scan.cuh kParts)
# planted faults (csrc/scan.cuh kFault*), for the checks only
FAULT_WRONG_STATE = 1   # chunk c reads the state entering chunk c - 1
FAULT_SPLIT_LOW = 2     # each split's parts but the first dropped
FAULT_NO_REBASE = 4     # cum not rebased across caller chunks


class ScanPlan(NamedTuple):
    """A scan's S = nc·Q rows cut into ``chunks`` kernel chunks of
    ``chunk`` rows (the last may be shorter), whatever the caller's Q."""
    chunk: int
    chunks: int


@functools.lru_cache(maxsize=512, typed=True)  # a launch pays no planning
def plan_scan(nc: int, Q: int) -> ScanPlan:
    """The kernel chunks of a scan over nc caller chunks of Q rows, from
    shapes only.  Takes plain ints, never a tensor, so no host read can
    enter it (300 tokens as two chunks of 150, or 257 as 257 chunks of
    1: five kernel chunks of 64, the last of 44 or 1 rows)."""
    for name, v in (("nc", nc), ("Q", Q)):
        if not isinstance(v, int) or isinstance(v, bool):
            raise TypeError(f"plan_scan: {name} must be an int, "
                            f"not {type(v).__name__}")
    if nc < 1 or Q < 1:
        raise ValueError(f"plan_scan: nc={nc}, Q={Q}")
    return ScanPlan(SCAN_CHUNK, -(-nc * Q // SCAN_CHUNK))


def rebase(cum: torch.Tensor, plan: ScanPlan, *,
           fault: int = 0) -> torch.Tensor:
    """The caller's log-decay cumsum cum [B,nc,Q,nh], restarted every Q
    rows, as the kernel's (``scan::rebase_chunk``): g [B,chunks,chunk,nh],
    restarted every kernel chunk, 0 past the last row.  Row t of the
    kernel chunk that starts at s0 takes cum_t, less cum_{s0-1} where s0
    is inside a caller chunk, plus the last cum of every caller chunk
    that ends in [s0, t)."""
    B, nc, Q, nh = cum.shape
    S, L, n = nc * Q, plan.chunk, plan.chunks
    flat = cum.reshape(B, S, nh)
    t = torch.arange(S, device=cum.device)
    last = (t % Q == Q - 1)[None, :, None]
    if fault & FAULT_NO_REBASE:
        last = torch.zeros_like(last)
    ends = torch.where(last, flat, 0.0)
    pad = (0, 0, 0, n * L - S)
    c = torch.nn.functional.pad(flat, pad).reshape(B, n, L, nh)
    e = torch.nn.functional.pad(ends, pad).reshape(B, n, L, nh)
    carry = torch.cumsum(e, 2) - e                    # the ends before t
    s0 = torch.arange(n, device=cum.device) * L
    base = torch.where((s0 % Q != 0)[None, :, None],
                       flat[:, (s0 - 1).clamp_min(0)], 0.0)
    valid = (s0[:, None] + torch.arange(L, device=cum.device) < S)
    return torch.where(valid[None, :, :, None],
                       (c - base[:, :, None]) + carry, 0.0)


def rebase_adjoint(dg: torch.Tensor, plan: ScanPlan, nc: int,
                   Q: int) -> torch.Tensor:
    """The gradient of ``rebase``: dg [B,chunks,chunk,nh] (the rows past
    the last ignored) -> dcum [B,nc,Q,nh].  Row u takes its own dg, the
    dg of every later row of its kernel chunk where u ends a caller chunk
    (the carry), less the whole dg of the kernel chunk that starts at
    u + 1 inside a caller chunk (the base).  Written out, not taken as
    ``rebase``'s vjp: that traces ``rebase`` again on every call, 34 more
    launches a backward and 0.04-0.07 ms a call on an H100."""
    B, n, L, nh = dg.shape
    S = nc * Q
    t = torch.arange(n * L, device=dg.device).reshape(n, L)
    dg = torch.where((t < S)[None, :, :, None], dg, 0.0)
    later = torch.flip(torch.cumsum(torch.flip(dg, (2,)), 2), (2,)) - dg
    out = dg + torch.where((t % Q == Q - 1)[None, :, :, None], later, 0.0)
    s0 = torch.arange(1, n, device=dg.device) * L
    base = torch.where((s0 % Q != 0)[None, :, None], dg[:, 1:].sum(2), 0.0)
    out = torch.cat([out[:, :, :L - 1],
                     torch.cat([out[:, :-1, L - 1] - base,
                                out[:, -1:, L - 1]], 1)[:, :, None]], 2)
    return out.reshape(B, n * L, nh)[:, :S].reshape(B, nc, Q, nh)


def chunked(t: torch.Tensor, plan: ScanPlan) -> torch.Tensor:
    """[B,nc,Q,...] -> [B,chunks,chunk,...], rows past S zero."""
    B, nc, Q = t.shape[:3]
    rest = t.shape[3:]
    S, L, n = nc * Q, plan.chunk, plan.chunks
    flat = t.reshape(B, S, -1)
    flat = torch.nn.functional.pad(flat, (0, 0, 0, n * L - S))
    return flat.reshape(B, n, L, *rest)


def unchunked(t: torch.Tensor, nc: int, Q: int) -> torch.Tensor:
    """[B,chunks,chunk,...] -> [B,nc,Q,...] (rows past S dropped)."""
    B, n, L = t.shape[:3]
    return t.reshape(B, n * L, *t.shape[3:])[:, :nc * Q].reshape(
        B, nc, Q, *t.shape[3:])


def split_bf16(x: torch.Tensor, *, fault: int = 0,
               parts: int = SPLIT_PARTS) -> torch.Tensor:
    """x as the kernels' bf16 products see an fp32 operand: ``parts`` bf16
    parts (the forwards' three: x to ~2^-26), each the rounding of what
    the ones before leave, summed in fp32; only the first with
    FAULT_SPLIT_LOW."""
    return sum(bf16_parts(x, 1 if fault & FAULT_SPLIT_LOW else parts))


def bf16_parts(x: torch.Tensor, parts: int) -> list:
    """x as ``parts`` bf16 values (held in x's dtype), each the rounding of
    what the ones before leave (``scan::split_bf16x2``)."""
    out, rest = [], x
    for _ in range(parts):
        part = rest.to(torch.bfloat16).to(x.dtype)
        out.append(part)
        rest = rest - part
    return out


def split_product(eq: str, a: torch.Tensor, b: torch.Tensor,
                  parts) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` as the bf16 backward kernels form it
    (``scan::mma_parts``): each operand as ``parts`` bf16 parts, part i of
    a against part j of b where i + j < parts, in fp32.  An operand that
    is a bf16 input has one part that is not zero, so a product with one
    fp32 operand takes all of that operand's parts, and one of two fp32
    operands keeps the cross terms down to the same order (for two
    parts: hi·hi + hi·lo + lo·hi).  ``parts`` None: the plain fp32
    product."""
    if parts is None:
        return torch.einsum(eq, a, b)
    A, Bp = bf16_parts(a, parts), bf16_parts(b, parts)
    return sum(torch.einsum(eq, x, y) for i, x in enumerate(A)
               for j, y in enumerate(Bp) if i + j < parts)


def last_rows(g: torch.Tensor, S: int) -> torch.Tensor:
    """g [B,chunks,chunk,nh] at the last row of each kernel chunk."""
    L, n = g.shape[2], g.shape[1]
    idx = torch.clamp_max(S - torch.arange(n, device=g.device) * L, L) - 1
    return g[:, torch.arange(n, device=g.device), idx]


def _valid_rows(plan: ScanPlan, S: int, device) -> torch.Tensor:
    """[chunks, chunk]: the kernel rows that hold one of the S rows."""
    t = torch.arange(plan.chunks * plan.chunk, device=device)
    return (t < S).reshape(plan.chunks, plan.chunk)


def _causal(Q: int, diagonal: int, device) -> torch.Tensor:
    return torch.ones(Q, Q, dtype=torch.bool, device=device).tril(diagonal)


def mamba_chunk_plain(xbar, B_c, C_c, cum, h_prev, *, diagonal: int = 0):
    """One chunk, as ``repro/kernels/ref.py:mamba_chunk``: xbar [B,Q,nh,P];
    B_c, C_c [B,Q,N]; cum [B,Q,nh]; h_prev [B,nh,P,N] -> (y, new state).
    The causal mask keeps ``j <= i + diagonal`` (the model's is 0)."""
    Q = xbar.shape[1]
    Bf, Cf = plain_float(B_c), plain_float(C_c)
    scores = torch.einsum("bin,bjn->bij", Cf, Bf)
    decay = torch.exp(cum[:, :, None] - cum[:, None, :])        # [B,Q,Q,nh]
    lmat = torch.where(_causal(Q, diagonal, xbar.device)[None, :, :, None],
                       decay, 0.0)
    y_diag = torch.einsum("bijh,bjhp->bihp", scores[..., None] * lmat, xbar)
    y_off = torch.einsum("bin,bhpn->bihp", Cf, h_prev) * \
        torch.exp(cum)[..., None]
    rem = torch.exp(cum[:, -1:, :] - cum)                       # [B,Q,nh]
    state = h_prev * torch.exp(cum[:, -1])[:, :, None, None] + \
        torch.einsum("bjn,bjhp->bhpn", Bf, rem[..., None] * xbar)
    return y_diag + y_off, state


def mamba_chunk_scan_plain(xbar, B_c, C_c, cum, *, diagonal: int = 0):
    """The same function as the kernel in plain PyTorch (the CPU path and
    the oracle): ``mamba_chunk_plain`` chained over the chunks.

    xbar [B,nc,Q,nh,P] fp32; B_c, C_c [B,nc,Q,N]; cum [B,nc,Q,nh] fp32
    -> (y [B,nc,Q,nh,P] fp32, final state [B,nh,P,N] fp32)."""
    B, nc, Q, nh, P = xbar.shape
    h = xbar.new_zeros(B, nh, P, B_c.shape[-1])
    ys = []
    for c in range(nc):
        y, h = mamba_chunk_plain(xbar[:, c], B_c[:, c], C_c[:, c], cum[:, c],
                                 h, diagonal=diagonal)
        ys.append(y)
    return torch.stack(ys, 1), h


def mamba_chunk_scan_staged(xbar, B_c, C_c, cum, *, split: bool = False,
                            fault: int = 0):
    """The kernel's plan and stages in plain PyTorch, in fp32: the state
    entering each kernel chunk by one ordered pass, C Bᵀ once per (b,
    kernel chunk), then the outputs.  With ``split`` the state update and
    the carried term see their fp32 operand (w ⊙ x̄, the entering state)
    as the bf16 kernel does (``split_bf16``); C Bᵀ is exact from bf16
    either way, and the intra-chunk product stays fp32.
    Same arguments and results as ``mamba_chunk_scan_plain``; ``fault``
    plants the kernel's faults."""
    B, nc, Q, nh, P = xbar.shape
    plan = plan_scan(nc, Q)
    S, L, n = nc * Q, plan.chunk, plan.chunks
    g = rebase(cum, plan, fault=fault)                   # [B,n,L,nh]
    gl = last_rows(g, S)                                 # [B,n,nh]
    x = chunked(xbar.float(), plan)                      # [B,n,L,nh,P]
    Bm, Cm = chunked(B_c.float(), plan), chunked(C_c.float(), plan)
    valid = _valid_rows(plan, S, g.device)               # [n,L]
    w = torch.exp(gl[:, :, None] - g) * valid[None, :, :, None]
    h = xbar.new_zeros(B, nh, P, Bm.shape[-1])
    hin = []
    for c in range(n):                                   # the ordered pass
        hin.append(h)
        xw = w[:, c, ..., None] * x[:, c]
        if split:
            xw = split_bf16(xw, fault=fault)
        h = h * torch.exp(gl[:, c])[..., None, None] + torch.einsum(
            "bjhp,bjn->bhpn", xw, Bm[:, c])
    G = torch.einsum("bcin,bcjn->bcij", Cm, Bm)           # once per chunk
    decay = torch.exp(g[:, :, :, None] - g[:, :, None, :])
    keep = _causal(L, 0, g.device)[None] & valid[:, :, None]
    M = torch.where(keep[None, ..., None], G[..., None] * decay, 0.0)
    y = torch.einsum("bcijh,bcjhp->bcihp", M, x)
    carried = []
    for c in range(n):
        src = c - 1 if fault & FAULT_WRONG_STATE else c
        h_src = hin[max(src, 0)]
        if split:
            h_src = split_bf16(h_src, fault=fault)
        carried.append(torch.zeros_like(y[:, c]) if src <= 0 else
                       torch.einsum("bin,bhpn->bihp", Cm[:, c], h_src)
                       * torch.exp(g[:, c])[..., None])
    y = y + torch.stack(carried, 1)
    return unchunked(y, nc, Q), h


@torch.library.custom_op("repro_torch::mamba_chunk_scan", mutates_args=())
def _scan_op(xbar: torch.Tensor, B_c: torch.Tensor, C_c: torch.Tensor,
             cum: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    raise NotImplementedError(
        f"mamba_chunk_scan: no implementation on {xbar.device}")


@_scan_op.register_kernel("cpu")
def _scan_cpu(xbar, B_c, C_c, cum):
    return mamba_chunk_scan_plain(xbar, B_c, C_c, cum)


@_scan_op.register_fake
def _scan_fake(xbar, B_c, C_c, cum):
    B, _, _, nh, P = xbar.shape
    return torch.empty_like(xbar), xbar.new_empty(B, nh, P, B_c.shape[-1])


_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def _launch(xbar, B_c, C_c, cum, fault: int = 0):
    """One call of the kernel on CUDA tensors (its two launches); a
    ``fault`` only plants a fault for the checks."""
    B, nc, Q, nh, P = xbar.shape
    N = B_c.shape[-1]
    _build.require(xbar.dtype == torch.float32 and cum.dtype == torch.float32
                   and B_c.dtype in _build.DTYPE_CODES
                   and C_c.dtype == B_c.dtype,
                   f"mamba_chunk_scan: dtypes {xbar.dtype}/{B_c.dtype}/"
                   f"{C_c.dtype}/{cum.dtype}")
    _build.require(B_c.shape == (B, nc, Q, N) and C_c.shape == B_c.shape
                   and cum.shape == (B, nc, Q, nh),
                   f"mamba_chunk_scan: shapes {xbar.shape} {B_c.shape} "
                   f"{C_c.shape} {cum.shape}")
    _build.require(all(t.is_contiguous() and t.device == xbar.device
                       for t in (xbar, B_c, C_c, cum)),
                   "mamba_chunk_scan: inputs must be contiguous on one device")
    _build.require(1 <= Q <= MAX_Q and 1 <= N <= MAX_N,
                   f"mamba_chunk_scan: Q={Q}, N={N} not supported")
    _build.require(B_c.dtype == torch.float32 or (
        N % 8 == 0 and B_c.data_ptr() % 16 == 0 and C_c.data_ptr() % 16 == 0),
                   f"mamba_chunk_scan: bf16 B, C need N % 8 == 0 (N={N}) "
                   f"and 16-byte rows")
    plan = plan_scan(nc, Q)
    y = torch.empty_like(xbar)
    state = xbar.new_empty(B, nh, P, N)
    if y.numel() == 0:
        return y, state
    # scratch: the state entering each kernel chunk but the first, and
    # C Bᵀ of each kernel chunk.  hin grows with the prompt: nh·P·N·4
    # bytes a kernel chunk and batch row (1 MiB at zamba2-1.2b)
    hin = xbar.new_empty(plan.chunks - 1, B, nh, P, N)
    G = xbar.new_empty(B, plan.chunks, plan.chunk, plan.chunk)
    fn = _build.entry("mamba_chunk_scan_launch", _ARGTYPES)
    _build.check(fn(xbar.data_ptr(), B_c.data_ptr(), C_c.data_ptr(),
                    cum.data_ptr(), y.data_ptr(), state.data_ptr(),
                    hin.data_ptr(), G.data_ptr(), B, nc, Q, nh, P, N,
                    plan.chunk, plan.chunks, _build.DTYPE_CODES[B_c.dtype],
                    fault, _build.stream_handle(xbar)),
                 "mamba_chunk_scan")
    return y, state


@_scan_op.register_kernel("cuda")
def _scan_cuda(xbar, B_c, C_c, cum):
    out = _launch(xbar, B_c, C_c, cum)
    if out[0].numel():
        mamba_chunk_scan.launches += 1
    return out


def mamba_chunk_scan(xbar, B_c, C_c, cum):
    """xbar [B,nc,Q,nh,P] fp32; B_c, C_c [B,nc,Q,N]; cum [B,nc,Q,nh] fp32
    -> (y [B,nc,Q,nh,P] fp32, final state [B,nh,P,N] fp32).  CUDA tensors
    launch the kernel, CPU tensors take the plain version."""
    return _scan_op(xbar, B_c, C_c, cum)


mamba_chunk_scan.launches = 0    # kernel launches (CUDA path only)


# ------------------------------------------------------------- backward --
BACKWARD_SOURCE = "src/repro_torch/csrc/mamba_scan_backward.cu"
BACKWARD_MAX_P = 64     # csrc/mamba_scan_backward.cu: one block holds all P
# bf16 parts of a split operand in both scans' backward kernels (csrc/
# scan.cuh kBwdParts): one part fails the bf16 limit, two meet it
BACKWARD_PARTS = 2
# planted faults of the backward (csrc kFault*), for the checks only
FAULT_WRONG_COTANGENT = 1   # chunk c reads the cotangent leaving c + 1
FAULT_DROP_GROUP = 2        # dB's sum of the head groups drops the last
FAULT_ONE_PART = 4          # every split operand cut to its first part


class BackwardPlan(NamedTuple):
    """The SSD backward's chunk blocks: each walks ``group`` heads of one
    (b, kernel chunk), B and C loaded once for them, and writes one share
    of dB and dC; launch 3 sums the ``groups`` shares in order."""
    group: int
    groups: int


@functools.lru_cache(maxsize=512, typed=True)
def plan_scan_backward(B: int, chunks: int, nh: int,
                       sms: int) -> BackwardPlan:
    """From shapes and the SM count only: the most heads a block (8, 4, 2
    or 1) that still give every SM a block (a train step's 8 rows of two
    kernel chunks on 132 SMs: groups of 4, 256 blocks; a 300-token
    prompt's five kernel chunks: groups of 2, 160 blocks)."""
    g = 8
    while g > 1 and B * chunks * -(-nh // g) < sms:
        g //= 2
    return BackwardPlan(g, -(-nh // g))


def _last_put(dg: torch.Tensor, S: int, add: torch.Tensor) -> torch.Tensor:
    """dg [B,chunks,chunk,nh] with ``add`` [B,chunks,nh] added at each
    kernel chunk's last valid row."""
    n, L = dg.shape[1], dg.shape[2]
    idx = torch.clamp_max(S - torch.arange(n, device=dg.device) * L, L) - 1
    at = torch.arange(L, device=dg.device)[None, :] == idx[:, None]
    return dg + torch.where(at[None, :, :, None], add[:, :, None], 0.0)


def mamba_chunk_scan_backward_plain(xbar, B_c, C_c, cum, dy, dstate=None):
    """The gradient of ``mamba_chunk_scan`` in plain PyTorch (the CPU
    path and the oracle), as an explicit reverse pass over the kernel's
    plan: the state entering each kernel chunk recomputed by the forward's
    ordered pass, the cotangent of the state leaving each chunk by the
    same pass run backwards from ``dstate`` (zeros for None), then per
    chunk, with g the rebased cum, gl its last row, h_in / dh_out the
    state entering / the cotangent leaving:

        dx̄_j = Σ_{i≥j} (C_i·B_j) e^{g_i−g_j} dy_i + e^{gl−g_j} dh_out B_j
        dB_j = Σ_{i≥j} e^{g_i−g_j} (dy_i·x̄_j) C_i + e^{gl−g_j} x̄_jᵀ dh_out
        dC_i = Σ_{j≤i} e^{g_i−g_j} (dy_i·x̄_j) B_j + e^{g_i} dy_iᵀ h_in

    (dB, dC summed over the heads) and dg from the intra-chunk terms, the
    carried term and the state term; dcum is dg through ``rebase``'s
    adjoint.  -> (dx̄, dB, dC, dcum), each in its input's dtype."""
    B, nc, Q, nh, P = xbar.shape
    plan = plan_scan(nc, Q)
    S, L, n = nc * Q, plan.chunk, plan.chunks
    ft = torch.promote_types(xbar.dtype, torch.float32)
    g = rebase(cum.to(ft), plan)                         # [B,n,L,nh]
    gl = last_rows(g, S)                                 # [B,n,nh]
    x, dyc = chunked(xbar.to(ft), plan), chunked(dy.to(ft), plan)
    Bm, Cm = chunked(B_c.to(ft), plan), chunked(C_c.to(ft), plan)
    rows = _valid_rows(plan, S, g.device)                # [n,L]
    valid = rows[None, :, :, None]
    ws = torch.exp(gl[:, :, None] - g) * valid           # e^{gl - g_j}
    eg = torch.exp(g) * valid                            # e^{g_i}
    decay = torch.exp(gl)                                # [B,n,nh]
    h = x.new_zeros(B, nh, P, Bm.shape[-1])
    hin = []
    for c in range(n):                                   # forward pass
        hin.append(h)
        h = h * decay[:, c, :, None, None] + torch.einsum(
            "bjh,bjhp,bjn->bhpn", ws[:, c], x[:, c], Bm[:, c])
    dh = torch.zeros_like(h) if dstate is None else dstate.to(ft)
    dhout = [None] * n
    for c in reversed(range(n)):                         # reverse pass
        dhout[c] = dh
        dh = dh * decay[:, c, :, None, None] + torch.einsum(
            "bih,bihp,bin->bhpn", eg[:, c], dyc[:, c], Cm[:, c])
    H, Dh = torch.stack(hin, 1), torch.stack(dhout, 1)   # [B,n,nh,P,N]
    keep = (_causal(L, 0, g.device)[None] & rows[:, :, None])[
        None, ..., None]                                 # [1,n,L,L,1]
    e = torch.where(keep, torch.exp(g[:, :, :, None] - g[:, :, None, :]),
                    0.0)                                 # [B,n,i,j,nh]
    M = torch.einsum("bcin,bcjn->bcij", Cm, Bm)[..., None] * e
    Dd = torch.einsum("bcihp,bcjhp->bcijh", dyc, x)      # dy_i · x̄_j
    Ap, A = e * Dd, M * Dd
    dxs = ws[..., None] * torch.einsum("bchpn,bcjn->bcjhp", Dh, Bm)
    dx = torch.einsum("bcijh,bcihp->bcjhp", M, dyc) + dxs
    dB = torch.einsum("bcijh,bcin->bcjn", Ap, Cm) + torch.einsum(
        "bcjh,bcjhp,bchpn->bcjn", ws, x, Dh)
    car = eg[..., None] * torch.einsum("bcihp,bchpn->bcihn", dyc, H)
    dC = torch.einsum("bcijh,bcjn->bcin", Ap, Bm) + car.sum(3)
    xd = (x * dxs).sum(-1)                               # [B,n,L,nh]
    dg = A.sum(3) - A.sum(2) + torch.einsum("bcihn,bcin->bcih", car, Cm) \
        - xd
    dg = _last_put(dg, S, decay * (Dh * H).sum((-1, -2)) + xd.sum(2))
    return (unchunked(dx, nc, Q).to(xbar.dtype),
            unchunked(dB, nc, Q).to(B_c.dtype),
            unchunked(dC, nc, Q).to(C_c.dtype),
            rebase_adjoint(dg, plan, nc, Q).to(cum.dtype))


def mamba_chunk_scan_backward_staged(xbar, B_c, C_c, cum, dy, dstate=None, *,
                                     parts=None, group: int = 4,
                                     fault: int = 0):
    """The backward kernel's plan and stages in plain PyTorch, in fp32.
    Launch 1's passes store only what is read: the state entering chunks
    1..n−1 (chunk 0's is zero) and the cotangent leaving chunks 0..n−2
    (the last chunk's is ``dstate``), so neither forms the product of the
    chunk it ends on.  Launch 2 walks ``group`` heads per (b, kernel
    chunk), C Bᵀ formed once for them, and sums their dB and dC into the
    group's share; launch 3 sums the shares in group order.  With
    ``parts`` every product with an fp32 operand sees it as the bf16
    kernel does (``split_product``); C Bᵀ is exact either way.  Same
    arguments and results as ``mamba_chunk_scan_backward_plain``;
    ``fault`` plants the kernel's faults."""
    B, nc, Q, nh, P = xbar.shape
    plan = plan_scan(nc, Q)
    S, L, n = nc * Q, plan.chunk, plan.chunks
    if parts and fault & FAULT_ONE_PART:
        parts = 1
    sp = lambda eq, a, b: split_product(eq, a, b, parts)
    g = rebase(cum.float(), plan)                        # [B,n,L,nh]
    gl = last_rows(g, S)                                 # [B,n,nh]
    x, dyc = chunked(xbar.float(), plan), chunked(dy.float(), plan)
    Bm, Cm = chunked(B_c.float(), plan), chunked(C_c.float(), plan)
    rows = _valid_rows(plan, S, g.device)                # [n,L]
    valid = rows[None, :, :, None]
    ws = torch.exp(gl[:, :, None] - g) * valid           # e^{gl - g_j}
    eg = torch.exp(g) * valid                            # e^{g_i}
    decay = torch.exp(gl)                                # [B,n,nh]
    zero = x.new_zeros(B, nh, P, Bm.shape[-1])
    hin, dho = [zero] * n, [None] * n
    for c in range(n - 1):                               # forward blocks
        hin[c + 1] = hin[c] * decay[:, c, :, None, None] + sp(
            "bjhp,bjn->bhpn", ws[:, c, ..., None] * x[:, c], Bm[:, c])
    dho[n - 1] = zero if dstate is None else dstate.float()
    for c in range(n - 1, 0, -1):                        # reverse blocks
        dho[c - 1] = dho[c] * decay[:, c, :, None, None] + sp(
            "bihp,bin->bhpn", eg[:, c, ..., None] * dyc[:, c], Cm[:, c])
    src = [min(c + 1, n - 1) if fault & FAULT_WRONG_COTANGENT else c
           for c in range(n)]
    H = torch.stack(hin, 1)                              # [B,n,nh,P,N]
    Dh = torch.stack([dho[c] for c in src], 1)
    keep = (_causal(L, 0, g.device)[None] & rows[:, :, None])[
        None, ..., None]
    e = torch.where(keep, torch.exp(g[:, :, :, None] - g[:, :, None, :]),
                    0.0)                                 # [B,n,i,j,nh]
    M = torch.einsum("bcin,bcjn->bcij", Cm, Bm)[..., None] * e
    Dd = sp("bcihp,bcjhp->bcijh", dyc, x)                # dy_i · x̄_j
    Ap, A = e * Dd, M * Dd
    dxs = ws[..., None] * sp("bchpn,bcjn->bcjhp", Dh, Bm)
    dx = sp("bcijh,bcihp->bcjhp", M, dyc) + dxs
    dBh = sp("bcijh,bcin->bcjhn", Ap, Cm) + ws[..., None] * sp(
        "bcjhp,bchpn->bcjhn", x, Dh)
    car = eg[..., None] * sp("bcihp,bchpn->bcihn", dyc, H)
    dCh = sp("bcijh,bcjn->bcihn", Ap, Bm) + car
    shares = lambda t: [t[:, :, :, h0:h0 + group].sum(3)
                        for h0 in range(0, nh, group)]
    bs, cs = shares(dBh), shares(dCh)
    dB = sum(bs[:-1] if fault & FAULT_DROP_GROUP else bs,
             torch.zeros_like(bs[0]))
    dC = sum(cs)
    xd = (x * dxs).sum(-1)                               # [B,n,L,nh]
    dg = A.sum(3) - A.sum(2) + torch.einsum("bcihn,bcin->bcih", car, Cm) \
        - xd
    dg = _last_put(dg, S, decay * (Dh * H).sum((-1, -2)) + xd.sum(2))
    return (unchunked(dx, nc, Q).to(xbar.dtype),
            unchunked(dB, nc, Q).to(B_c.dtype),
            unchunked(dC, nc, Q).to(C_c.dtype),
            rebase_adjoint(dg, plan, nc, Q).to(cum.dtype))


@torch.library.custom_op("repro_torch::mamba_chunk_scan_backward",
                         mutates_args=())
def _scan_bwd_op(xbar: torch.Tensor, B_c: torch.Tensor, C_c: torch.Tensor,
                 cum: torch.Tensor, dy: torch.Tensor, dstate: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    raise NotImplementedError(
        f"mamba_chunk_scan_backward: no implementation on {xbar.device}")


@_scan_bwd_op.register_kernel("cpu")
def _scan_bwd_cpu(xbar, B_c, C_c, cum, dy, dstate):
    return _build.contiguous(
        mamba_chunk_scan_backward_plain(xbar, B_c, C_c, cum, dy, dstate))


@_scan_bwd_op.register_fake
def _scan_bwd_fake(xbar, B_c, C_c, cum, dy, dstate):
    return (torch.empty_like(xbar), torch.empty_like(B_c),
            torch.empty_like(C_c), torch.empty_like(cum))


_BWD_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 11 \
    + [ctypes.c_void_p]


def _launch_backward(xbar, B_c, C_c, cum, dy, dstate, fault: int = 0):
    """One run of the backward kernel on CUDA tensors: six launches (four
    with one kernel chunk), the rebase of cum first and its adjoint last
    (``rebase``, ``rebase_adjoint``); ``fault`` plants a fault for the
    checks only.  Scratch: the rebased cum and its gradient, the state
    entering each kernel chunk but the first and the cotangent leaving
    each but the last (the last chunk's is ``dstate``, read in place),
    nh·P·N·4 bytes each a kernel chunk and batch row (1 MiB at
    zamba2-1.2b: 16 MiB for a train step's batch 8 of two kernel chunks),
    and each head group's share of dB and dC (``plan_scan_backward``)."""
    B, nc, Q, nh, P = xbar.shape
    N = B_c.shape[-1]
    f32 = torch.float32
    _build.require(xbar.dtype == f32 and cum.dtype == f32 and dy.dtype == f32
                   and dstate.dtype == f32 and B_c.dtype in _build.DTYPE_CODES
                   and C_c.dtype == B_c.dtype,
                   f"mamba_chunk_scan_backward: dtypes {xbar.dtype}/"
                   f"{B_c.dtype}/{C_c.dtype}/{cum.dtype}/{dy.dtype}/"
                   f"{dstate.dtype}")
    _build.require(B_c.shape == (B, nc, Q, N) and C_c.shape == B_c.shape
                   and cum.shape == (B, nc, Q, nh) and dy.shape == xbar.shape
                   and dstate.shape == (B, nh, P, N),
                   f"mamba_chunk_scan_backward: shapes {xbar.shape} "
                   f"{B_c.shape} {C_c.shape} {cum.shape} {dy.shape} "
                   f"{dstate.shape}")
    _build.require(all(t.is_contiguous() and t.device == xbar.device
                       for t in (xbar, B_c, C_c, cum, dy, dstate)),
                   "mamba_chunk_scan_backward: inputs must be contiguous on "
                   "one device")
    _build.require(1 <= Q <= MAX_Q and 1 <= N <= MAX_N
                   and 1 <= P <= BACKWARD_MAX_P,
                   f"mamba_chunk_scan_backward: Q={Q}, P={P}, N={N} not "
                   f"supported")
    plan = plan_scan(nc, Q)
    L, n = plan.chunk, plan.chunks
    dx, dB, dC = (torch.empty_like(t) for t in (xbar, B_c, C_c))
    if xbar.numel() == 0:
        return dx, dB.zero_(), dC.zero_(), torch.zeros_like(cum)
    bp = plan_scan_backward(B, n, nh, _build.sm_count(xbar.device))
    g, dg = xbar.new_empty(B, n, L, nh), xbar.new_empty(B, n, L, nh)
    hin = xbar.new_empty(n - 1, B, nh, P, N)
    dho = xbar.new_empty(n - 1, B, nh, P, N)
    dBg = xbar.new_empty(B, n, bp.groups, L, N)
    dCg = xbar.new_empty(B, n, bp.groups, L, N)
    dcum = torch.empty_like(cum)
    # 16-byte rows: cp.async; else the kernel's plain loads
    vec = int(P % 4 == 0 and N * B_c.element_size() % 16 == 0 and N % 4 == 0
              and all(t.data_ptr() % 16 == 0
                      for t in (xbar, dy, B_c, C_c, dstate, hin, dho)))
    fn = _build.entry("mamba_chunk_scan_backward_launch", _BWD_ARGTYPES)
    ptrs = (xbar, B_c, C_c, cum, dy, dstate, g, hin, dho, dx, dB, dC, dBg,
            dCg, dg, dcum)
    _build.check(fn(*(t.data_ptr() for t in ptrs), B, nc * Q, Q, nh, P, N,
                    n, bp.group, _build.DTYPE_CODES[B_c.dtype], vec, fault,
                    _build.stream_handle(xbar)),
                 "mamba_chunk_scan_backward")
    return dx, dB, dC, dcum


@_scan_bwd_op.register_kernel("cuda")
def _scan_bwd_cuda(xbar, B_c, C_c, cum, dy, dstate):
    out = _launch_backward(xbar, B_c, C_c, cum, dy, dstate)
    if xbar.numel():
        mamba_chunk_scan_backward.launches += 1
    return out


def mamba_chunk_scan_backward(xbar, B_c, C_c, cum, dy, dstate=None):
    """(dx̄, dB, dC, dcum) of ``mamba_chunk_scan(xbar, B_c, C_c, cum)`` for
    the gradients dy of y and ``dstate`` of the final state (zeros for
    None).  CUDA tensors launch the kernel, CPU tensors take the plain
    version."""
    if dstate is None:
        B, _, _, nh, P = xbar.shape
        dstate = xbar.new_zeros(B, nh, P, B_c.shape[-1])
    return _scan_bwd_op(xbar, B_c, C_c, cum, dy.contiguous(),
                        dstate.contiguous())


mamba_chunk_scan_backward.launches = 0   # kernel runs (CUDA path only)


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, dy, dstate):
    return mamba_chunk_scan_backward(*ctx.saved_tensors, dy, dstate)


torch.library.register_autograd("repro_torch::mamba_chunk_scan", _backward,
                                setup_context=_setup_context)


# ------------------------------------------------------------- sharding --
def _sharding(xbar, B_c, C_c, cum):
    """Batch split, or heads split (B and C, shared by every head, whole).
    The chunk and row dims are never split: the state is carried across
    them."""
    S, R, _ = _sharding_types()
    return [([S(0), S(0)], [S(0)] * 4),
            ([S(3), S(1)], [S(3), R, R, S(3)]),
            replicated(2, (xbar, B_c, C_c, cum))]


def _backward_sharding(xbar, B_c, C_c, cum, dy, dstate):
    """The forward's rows; under a head split each rank's dB and dC sum
    its own heads, partial sums over the split."""
    S, R, P = _sharding_types()
    return [([S(0)] * 4, [S(0)] * 6),
            ([S(3), P, P, S(3)], [S(3), R, R, S(3), S(3), S(1)]),
            replicated(4, (xbar, B_c, C_c, cum, dy, dstate))]


SHARDING = (("mamba_chunk_scan", _sharding),
            ("mamba_chunk_scan_backward", _backward_sharding))
