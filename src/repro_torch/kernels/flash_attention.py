"""GQA prefill attention: a hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py:flash_attention``
(Pallas) and computes what ``repro/models/layers.py:chunked_attention``
computes: causal, sliding-window or bidirectional attention of
``q [B,Sq,H,hd]`` against ``k [B,Sk,Hkv,hd]`` and ``v [B,Sk,Hkv,hd_v]``
(hd_v = hd except for MLA's prefill: hd 192 = 128 + 64 rope, hd_v 128;
the scale stays ``hd ** -0.5``), query i at position
``i + q_offset`` (end-aligned by default: ``q_offset = Sk - Sq``), query
head h reading KV head ``h // (H // Hkv)``, fp32 softmax.

What bounds it on the H100: at the prompts a server prefills (37 to 512
tokens) the tensor-core work of the longest query tile on its SM and
per-block latency, not bytes; K and V of a KV head (256 KB at S = 512)
are re-read by its G query heads from L2.  The kernel
(``csrc/flash_attention.cu``) keeps the online-softmax state in fp32
registers across K/V tiles, so the [Sq, Sk] scores never reach device
memory, skips the tiles a query tile cannot see (causal, window) and masks
the ragged edge.  In bf16 both products run on the tensor cores
(``mma.sync`` m16n8k16, fragments by ``ldmatrix``), each warp keeping 16
query rows' Q fragments and output in registers and passing P from the
QK^T accumulator to the PV operand in registers; K/V tiles of 64 keys stay
bf16 in shared memory, loaded by ``cp.async`` ahead of use.  A block owns
one query head and ``tile_rows`` query rows (64 or 32, so that about one
block runs per SM), in two warp groups that take alternate K tiles and
merge at the end; the longest causal tiles start first.  fp32 keeps a
CUDA-core kernel: the tensor cores would compute in TF32, which cannot
meet the fp32 limit; fp32 is the parity path and is not served.

The gradient (``flash_attention_backward``, ``csrc/
flash_attention_backward.cu``) is registered as the op's autograd.  The
TPU kernel has no backward (the reference differentiates
``chunked_attention``); this one is the port's own.  The forward keeps its
schema and saves no softmax statistics, so the backward recomputes them:
launch A, per (b, head, 16 query rows), finds each row's log-sum-exp and
``rowsum(dout * out)`` over the K tiles it can see and computes dq; launch
B, per (b, KV head, tile of keys), walks the group's query heads and the
query tiles that see its keys and sums dk and dv in registers (no
atomics).  In bf16 at hd 64, 96 and 128 all products run by ``wgmma`` on
64-row tiles, one warpgroup a block, the next tile loading under this
one's products (dS rounded to bf16 before dQ and dK, as FlashAttention-2
does), and ``plan_flash_backward`` splits launch B's walk over the group's
heads so that its blocks cover the SMs, a split's blocks summing their dk
and dv in a fixed order through a thread block cluster's shared memory;
``flash_attention_backward_staged`` is that decomposition in plain
PyTorch, for the CPU tests.  hd 16 and 32 keep ``mma.sync``; fp32, the
parity path, stays on the CUDA cores.  The backward takes every pair of
``HEAD_DIM_PAIRS``: at MLA's (192, 128) the products over q and k run at
192 and those over v and dout at 128 (its group is one head, so launch B
is not split).
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._sharding import placement_types as _sharding_types
from repro_torch.kernels._sharding import replicated, splits_evenly
from repro_torch.kernels._build import plain_float

SOURCE = "src/repro_torch/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:80"
# the gradient of that kernel; the reference takes jax.grad of
# repro/models/layers.py:chunked_attention (:103) instead
BACKWARD_SOURCE = "src/repro_torch/csrc/flash_attention_backward.cu"
HEAD_DIMS = (16, 32, 64, 96, 128)   # 96: phi-3-vision
# the (hd, hd_v) pairs the kernel is built for
HEAD_DIM_PAIRS = tuple((hd, hd) for hd in HEAD_DIMS) + ((192, 128),)
NEG_INF = -1e30


def tile_rows(B: int, Sq: int, H: int, sm_count: int) -> int:
    """Query rows per block of the bf16 kernel: 64 (each of its two warp
    groups four warps of 16 rows), or 32 where 64 would leave more than an
    eighth of the SMs without a block (MLA's 16 heads at S = 256: 64
    blocks of 64 rows, 128 of 32).  A function of shapes only."""
    blocks = B * H * -(-Sq // 64)
    return 64 if 8 * blocks >= 7 * sm_count else 32


BWD_TILE = 64          # rows of the bf16 backward's wgmma tiles (hd >= 64)
BWD_MAX_SPLIT = 8      # launch B's blocks a group: a portable cluster


class FlashBackwardPlan(NamedTuple):
    """Launch B's split of a group: one block per (b, KV head, 64-key tile,
    split), each split walking ``heads_per`` of the group's heads (the
    last split the rest), the ``splits`` blocks of a unit one cluster.
    Launch A takes one block per (b, head, 64-row query tile)."""
    heads_per: int
    splits: int


@functools.lru_cache(maxsize=512, typed=True)  # a launch pays no planning
def plan_flash_backward(B: int, Sq: int, Sk: int, H: int, Hkv: int, hd: int,
                        sm_count: int) -> FlashBackwardPlan:
    """The bf16 backward's plan from shapes only.  At hd 64, 96 and 128
    (wgmma, 64-row tiles) launch B splits each group of G = H / Hkv heads
    into the fewest splits s of ceil(G / s) heads (at most 8) whose B Hkv
    ceil(Sk / 64) s blocks reach seven eighths of the SMs (qwen2.5-3b's
    train step, [8,128,16,128] / [8,128,2,128] on 132 SMs: 4 splits of 2
    heads, 128 blocks; G = 1, as zamba2, phi-3 and whisper: none); hd 16
    and 32 (mma.sync) walk the whole group in one block."""
    for name, v in (("B", B), ("Sq", Sq), ("Sk", Sk), ("H", H),
                    ("Hkv", Hkv), ("hd", hd), ("sm_count", sm_count)):
        if not isinstance(v, int) or isinstance(v, bool):
            raise TypeError(f"plan_flash_backward: {name} must be an int, "
                            f"not {type(v).__name__}")
    G = H // Hkv
    if hd < 64:
        return FlashBackwardPlan(G, 1)
    units = B * Hkv * -(-Sk // BWD_TILE)
    heads_per = G
    for s in range(1, min(G, BWD_MAX_SPLIT) + 1):
        heads_per = -(-G // s)
        if 8 * units * -(-G // heads_per) >= 7 * sm_count:
            break
    return FlashBackwardPlan(heads_per, -(-G // heads_per))


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """fp32 softmax over the last axis with masked entries at -1e30
    (``repro/models/layers.py:_masked_softmax``)."""
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    e = torch.exp(scores - m)
    return e / e.sum(-1, keepdim=True).clamp_min(1e-30)


def _mask(Sq, Sk, causal, window, q_offset, device):
    pq = torch.arange(Sq, device=device)[:, None] + q_offset
    pk = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=device)
    if causal:
        mask &= pq >= pk
    if window:
        mask &= pq - pk < window
    return mask


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: Optional[float] = None,
                          q_offset: Optional[int] = None) -> torch.Tensor:
    """The same function in plain PyTorch (the CPU path and the oracle),
    -> [B,Sq,H,hd_v], in fp32 (fp64 for fp64 inputs, which gradcheck
    takes).  Probabilities are cast to v's dtype before the PV product, as
    the reference does."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    q_offset = Sk - Sq if q_offset is None else q_offset
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", plain_float(q), plain_float(k)) * scale
    a = masked_softmax(s, _mask(Sq, Sk, causal, window, q_offset, q.device))
    o = torch.einsum("bhqk,bkhd->bqhd", plain_float(a.to(v.dtype)), plain_float(v))
    return o.to(q.dtype)


def flash_attention_backward_plain(q, k, v, out, dout, *, causal: bool = True,
                                   window: int = 0,
                                   scale: Optional[float] = None,
                                   q_offset: Optional[int] = None):
    """The gradient in plain PyTorch (the CPU path and the oracle): (dq,
    dk, dv) in the inputs' dtypes, for the forward's ``out`` and its
    gradient ``dout``.  P is the forward's fp32 softmax, recomputed; dv
    takes P cast to v's dtype, as the forward's PV product does, and
    ``dS = P (dP - rowsum(dout * out))``."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = hd ** -0.5 if scale is None else scale
    q_offset = Sk - Sq if q_offset is None else q_offset
    kf, vf = plain_float(k), plain_float(v)
    if G != 1:
        kf = kf.repeat_interleave(G, dim=2)
        vf = vf.repeat_interleave(G, dim=2)
    qf, dof = plain_float(q), plain_float(dout)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = masked_softmax(s, _mask(Sq, Sk, causal, window, q_offset, q.device))
    dv = torch.einsum("bhqk,bqhd->bkhd", plain_float(p.to(v.dtype)), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * plain_float(out)).sum(-1).transpose(1, 2)[..., None]
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    if G != 1:
        dk = dk.reshape(B, Sk, Hkv, G, hd).sum(3)
        dv = dv.reshape(B, Sk, Hkv, G, v.shape[-1]).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _visible_keys(q0, rows, Sq, Sk, causal, window, q_offset):
    """[k_lo, k_hi) of the keys some query row of [q0, q0 + rows) can
    see (launch A's walk)."""
    last = min(q0 + rows, Sq) - 1 + q_offset
    hi = min(Sk, last + 1) if causal else Sk
    lo = max(0, q0 + q_offset - window + 1) if window > 0 else 0
    return lo, hi


def _visible_rows(k0, keys, Sq, Sk, causal, window, q_offset):
    """[i_lo, i_hi) of the query rows that can see some key of [k0, k0 +
    keys) (launch B's walk)."""
    k1 = min(Sk, k0 + keys)
    lo = max(0, k0 - q_offset) if causal else 0
    hi = min(Sq, k1 - 1 + window - q_offset) if window > 0 else Sq
    return lo, hi


def flash_attention_backward_staged(q, k, v, out, dout, *, causal=True,
                                    window=0, scale=None, q_offset=None,
                                    plan: Optional[FlashBackwardPlan] = None):
    """The bf16 wgmma kernel's decomposition in plain PyTorch, in fp32
    (fp64 for fp64 inputs), with its bf16 roundings of P and dS where the
    inputs are bf16: launch A per 64-row query tile over the 64-key tiles
    its rows can see, in order (lse over the visible keys; dQ summed tile
    by tile); launch B per 64-key tile and split of ``plan`` (``plan_flash_
    backward`` at 132 SMs unless given), each split summing its heads'
    query tiles of 64 rows in order, the splits' partials then summed in
    split order.  -> (dq, dk, dv) in the inputs' dtypes."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = hd ** -0.5 if scale is None else scale
    q_offset = Sk - Sq if q_offset is None else q_offset
    if plan is None:
        plan = plan_flash_backward(B, Sq, Sk, H, Hkv, hd, 132)
    T = BWD_TILE
    rnd = (lambda t: t.to(q.dtype).to(t.dtype)) \
        if q.dtype == torch.bfloat16 else (lambda t: t)
    qf, kf, vf = plain_float(q), plain_float(k), plain_float(v)
    dof, of = plain_float(dout), plain_float(out)
    mask = _mask(Sq, Sk, causal, window, q_offset, q.device)
    ft = qf.dtype
    hd_v = v.shape[-1]
    dq = torch.zeros(B, Sq, H, hd, dtype=ft)
    dk = torch.zeros(B, Sk, Hkv, hd, dtype=ft)
    dv = torch.zeros(B, Sk, Hkv, hd_v, dtype=ft)
    lse = torch.full((B, H, Sq), float("inf"), dtype=ft)
    delta = (dof * of).sum(-1).transpose(1, 2)          # [B, H, Sq]
    for h in range(H):
        hk = h // G
        for q0 in range(0, Sq, T):
            rows = slice(q0, min(Sq, q0 + T))
            lo, hi = _visible_keys(q0, T, Sq, Sk, causal, window, q_offset)
            if hi <= lo:
                continue
            tiles = range(lo // T * T, hi, T)
            s_of = {t: torch.einsum("bqd,bkd->bqk", qf[:, rows, h],
                                    kf[:, t:t + T, hk]) * scale
                    for t in tiles}
            vis = {t: mask[rows, t:min(t + T, hi)] for t in tiles}
            s_all = torch.cat(
                [torch.where(vis[t], s_of[t][..., :vis[t].shape[-1]],
                             -float("inf")) for t in tiles], -1)
            m = s_all.amax(-1, keepdim=True)
            m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
            l = torch.exp(s_all - m).sum(-1, keepdim=True)
            lse_r = torch.where(l > 0, m + torch.log(l), float("inf"))
            lse[:, h, rows] = lse_r[..., 0]
            for t in tiles:
                n = vis[t].shape[-1]
                p = torch.where(vis[t], torch.exp(s_of[t][..., :n] - lse_r),
                                0.0)
                dp = torch.einsum("bqd,bkd->bqk", dof[:, rows, h],
                                  vf[:, t:t + n, hk])
                ds = rnd(p * (dp - delta[:, h, rows, None]))
                dq[:, rows, h] += torch.einsum("bqk,bkd->bqd", ds,
                                               kf[:, t:t + n, hk])
    dq *= scale
    for hk in range(Hkv):
        for k0 in range(0, Sk, T):
            keys = slice(k0, min(Sk, k0 + T))
            lo, hi = _visible_rows(k0, T, Sq, Sk, causal, window, q_offset)
            parts = []
            for c in range(plan.splits):
                pk = torch.zeros(B, keys.stop - k0, hd, dtype=ft)
                pv = torch.zeros(B, keys.stop - k0, hd_v, dtype=ft)
                heads = range(c * plan.heads_per,
                              min(G, (c + 1) * plan.heads_per))
                for g in heads:
                    h = hk * G + g
                    for i0 in range(lo, hi, T):
                        rows = slice(i0, min(Sq, i0 + T))
                        st = torch.einsum("bkd,bqd->bkq", kf[:, keys, hk],
                                          qf[:, rows, h]) * scale
                        vis = mask[rows, keys].T
                        p = torch.where(vis, torch.exp(
                            st - lse[:, h, None, rows]), 0.0)
                        dpt = torch.einsum("bkd,bqd->bkq", vf[:, keys, hk],
                                           dof[:, rows, h])
                        ds = rnd(p * (dpt - delta[:, h, None, rows]))
                        pv += torch.einsum("bkq,bqd->bkd", rnd(p),
                                           dof[:, rows, h])
                        pk += torch.einsum("bkq,bqd->bkd", ds, qf[:, rows, h])
                parts.append((pk, pv))
            sk, sv = parts[0]
            for pk, pv in parts[1:]:
                sk, sv = sk + pk, sv + pv
            dk[:, keys, hk] = sk * scale
            dv[:, keys, hk] = sv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: int, scale: float,
              q_offset: int) -> torch.Tensor:
    raise NotImplementedError(
        f"flash_attention: no implementation on {q.device}")


@_flash_op.register_kernel("cpu")
def _flash_cpu(q, k, v, causal, window, scale, q_offset):
    return _build.contiguous(flash_attention_plain(
        q, k, v, causal=causal, window=window, scale=scale,
        q_offset=q_offset))


@_flash_op.register_fake
def _flash_fake(q, k, v, causal, window, scale, q_offset):
    return q.new_empty(*q.shape[:-1], v.shape[-1])


_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
             + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _launch(q, k, v, causal, window, scale, q_offset, short_tiles=0):
    """One launch of the kernel on CUDA tensors.  ``short_tiles`` > 0 only
    plants a fault for the checks: the kernel then visits that many fewer
    K tiles than the causal bound allows."""
    B, Sq, H, hd = q.shape
    Sk, Hkv, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    _build.require(q.dtype in _build.DTYPE_CODES and k.dtype == q.dtype
                   and v.dtype == q.dtype,
                   f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    _build.require(all(t.is_contiguous() and t.device == q.device
                       for t in (q, k, v)),
                   "flash_attention: q, k, v must be contiguous on one device")
    _build.require((hd, hd_v) in HEAD_DIM_PAIRS,
                   f"flash_attention: hd={hd}, hd_v={hd_v} not in "
                   f"{HEAD_DIM_PAIRS}")
    _build.require(k.shape == (B, Sk, Hkv, hd)
                   and v.shape == (B, Sk, Hkv, hd_v) and H % Hkv == 0,
                   f"flash_attention: shapes {q.shape} {k.shape} {v.shape}")
    out = q.new_empty(B, Sq, H, hd_v)
    if q.numel() == 0:
        return out
    rows = tile_rows(B, Sq, H, _build.sm_count(q.device))
    fn = _build.entry("flash_attention_launch", _ARGTYPES)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, Sq, Sk, H, Hkv, hd, hd_v, int(causal), window, scale,
                    q_offset, rows, short_tiles, _build.DTYPE_CODES[q.dtype],
                    _build.stream_handle(q)),
                 "flash_attention")
    return out


@_flash_op.register_kernel("cuda")
def _flash_cuda(q, k, v, causal, window, scale, q_offset):
    out = _launch(q, k, v, causal, window, scale, q_offset)
    if q.numel():
        flash_attention.launches += 1
        flash_attention.by_shape[(tuple(q.shape), tuple(k.shape))] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: Optional[float] = None,
                    q_offset: Optional[int] = None) -> torch.Tensor:
    """q [B,Sq,H,hd]; k [B,Sk,Hkv,hd]; v [B,Sk,Hkv,hd_v] -> [B,Sq,H,hd_v].
    CUDA tensors launch the kernel, CPU tensors take the plain version."""
    hd, Sq, Sk = q.shape[-1], q.shape[1], k.shape[1]
    return _flash_op(q, k, v, bool(causal), int(window),
                     float(hd ** -0.5 if scale is None else scale),
                     int(Sk - Sq if q_offset is None else q_offset))


flash_attention.launches = 0    # kernel launches (CUDA path only)
flash_attention.by_shape = Counter()   # ... by (q.shape, k.shape)


# ------------------------------------------------------------- backward --
@torch.library.custom_op("repro_torch::flash_attention_backward",
                         mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, dout: torch.Tensor, causal: bool,
                  window: int, scale: float, q_offset: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    raise NotImplementedError(
        f"flash_attention_backward: no implementation on {q.device}")


@_flash_bwd_op.register_kernel("cpu")
def _flash_bwd_cpu(q, k, v, out, dout, causal, window, scale, q_offset):
    return _build.contiguous(flash_attention_backward_plain(
        q, k, v, out, dout, causal=causal, window=window, scale=scale,
        q_offset=q_offset))


@_flash_bwd_op.register_fake
def _flash_bwd_fake(q, k, v, out, dout, causal, window, scale, q_offset):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                 + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _launch_backward(q, k, v, out, dout, causal, window, scale, q_offset,
                     short_tiles=0, plan: Optional[FlashBackwardPlan] = None):
    """One run of the backward (two launches) on CUDA tensors, by ``plan``
    (``plan_flash_backward`` unless given).  ``short_tiles`` > 0 only
    plants a fault for the checks: launch A then walks that many fewer K
    tiles."""
    B, Sq, H, hd = q.shape
    Sk, Hkv, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    _build.require(all(t.dtype == q.dtype for t in (k, v, out, dout))
                   and q.dtype in _build.DTYPE_CODES,
                   "flash_attention_backward: q, k, v, out and dout must "
                   "share one dtype (fp32 or bf16)")
    _build.require(all(t.is_contiguous() and t.device == q.device
                       for t in (q, k, v, out, dout)),
                   "flash_attention_backward: inputs must be contiguous on "
                   "one device")
    _build.require((hd, hd_v) in HEAD_DIM_PAIRS,
                   f"flash_attention_backward: hd={hd}, hd_v={hd_v} not in "
                   f"{HEAD_DIM_PAIRS}")
    _build.require(k.shape == (B, Sk, Hkv, hd)
                   and v.shape == (B, Sk, Hkv, hd_v)
                   and out.shape == (B, Sq, H, hd_v) and dout.shape == out.shape
                   and H % Hkv == 0 and B * H < 65536,
                   f"flash_attention_backward: shapes {q.shape} {k.shape} "
                   f"{v.shape} {out.shape} {dout.shape}")
    _build.require(all(t.data_ptr() % 16 == 0 for t in (q, k, v, out, dout)),
                   "flash_attention_backward: inputs must start on 16-byte "
                   "boundaries")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    if plan is None:
        plan = plan_flash_backward(B, Sq, Sk, H, Hkv, hd,
                                   _build.sm_count(q.device))
    _build.require(hd_v == hd or plan.splits == 1,
                   f"flash_attention_backward: launch B splits a group of "
                   f"{H // Hkv} heads only where hd_v = hd (hd={hd}, "
                   f"hd_v={hd_v}, {plan})")
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    fn = _build.entry("flash_attention_backward_launch", _BWD_ARGTYPES)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), lse.data_ptr(), delta.data_ptr(), B, Sq,
                    Sk, H, Hkv, hd, hd_v, int(causal), window, scale, q_offset,
                    short_tiles, plan.heads_per, _build.DTYPE_CODES[q.dtype],
                    _build.stream_handle(q)),
                 "flash_attention_backward")
    return dq, dk, dv


@_flash_bwd_op.register_kernel("cuda")
def _flash_bwd_cuda(q, k, v, out, dout, causal, window, scale, q_offset):
    # a view autograd handed over may start off a 16-byte boundary
    q, k, v, out, dout = (t if t.data_ptr() % 16 == 0 else t.clone()
                          for t in (q, k, v, out, dout))
    grads = _launch_backward(q, k, v, out, dout, causal, window, scale,
                             q_offset)
    if q.numel() and k.numel():
        flash_attention_backward.launches += 1
    return grads


def flash_attention_backward(q, k, v, out, dout, *, causal: bool = True,
                             window: int = 0, scale: Optional[float] = None,
                             q_offset: Optional[int] = None):
    """(dq, dk, dv) of ``flash_attention(q, k, v, ...) = out`` for its
    gradient ``dout``.  CUDA tensors launch the kernel, CPU tensors take
    the plain version."""
    hd, Sq, Sk = q.shape[-1], q.shape[1], k.shape[1]
    return _flash_bwd_op(q, k, v, out, dout.contiguous(), bool(causal),
                         int(window),
                         float(hd ** -0.5 if scale is None else scale),
                         int(Sk - Sq if q_offset is None else q_offset))


flash_attention_backward.launches = 0   # kernel runs (CUDA path only)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window, scale, q_offset = inputs
    ctx.save_for_backward(q, k, v, output)
    ctx.args = dict(causal=causal, window=window, scale=scale,
                    q_offset=q_offset)


def _backward(ctx, dout):
    q, k, v, out = ctx.saved_tensors
    dq, dk, dv = flash_attention_backward(q, k, v, out, dout, **ctx.args)
    return dq, dk, dv, None, None, None, None


torch.library.register_autograd("repro_torch::flash_attention", _backward,
                                setup_context=_setup_context)


# ------------------------------------------------------------- sharding --
def _sharding(q, k, v, causal, window, scale, q_offset):
    """Batch split; heads split only when every head split DTensor could
    make divides both q's H and k/v's Hkv (``splits_evenly``), so that
    local q head i reads local kv head i // G.  A head split of q over
    whole K/V would read kv head i // G of the full K/V, wrong on every
    rank but the first.  The sequence is never split."""
    S, R, _ = _sharding_types()
    rest = [None] * 4
    rows = [([S(0)], [S(0)] * 3 + rest)]
    if splits_evenly(q.mesh, q.shape[2], k.shape[2]):
        rows.append(([S(2)], [S(2)] * 3 + rest))
    return rows + [replicated(1, (q, k, v, causal, window, scale, q_offset))]


def _backward_sharding(q, k, v, out, dout, causal, window, scale, q_offset):
    """The forward's rows: dq, dk, dv split as q, k, v."""
    S, R, _ = _sharding_types()
    rest = [None] * 4
    rows = [([S(0)] * 3, [S(0)] * 5 + rest)]
    if splits_evenly(q.mesh, q.shape[2], k.shape[2]):
        rows.append(([S(2)] * 3, [S(2)] * 5 + rest))
    return rows + [replicated(3, (q, k, v, out, dout, causal, window, scale,
                                  q_offset))]


SHARDING = (("flash_attention", _sharding),
            ("flash_attention_backward", _backward_sharding))
