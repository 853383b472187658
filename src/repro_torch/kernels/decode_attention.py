"""Single-token GQA decode attention: a hand-written CUDA kernel and its
plain version.

Replaces the TPU kernel ``repro/kernels/decode_attention.py:
decode_attention`` (Pallas): ``q [B,H,hd]`` against caches
``[B,W,Hkv,hd]`` with slots ``>= lengths[b]`` masked, the G query heads of
a KV group served together, fp32 softmax.  It is the dense form of
``repro/models/layers.py:decode_attention`` (there ``lengths = pos + 1``).

What bounds it on the H100: bytes, reached only with enough loads in
flight.  Each valid K/V row is read once and used for ~4·G flops per
element.  The kernel (``csrc/decode_attention.cuh``) splits the cache into
``plan_splits(...)`` chunks, one block per (chunk, kv head, b): 128 blocks
at serving batch 4 (16 splits of 64 slots at W = 1024; one block per
(b, kv head) would give 8).  The plan is a function of shapes only and never
reads ``lengths`` (a host read would be a host sync); a block whose chunk
lies past ``lengths[b]`` reads nothing.  Each block stages its rows by
``cp.async`` 16 bytes a lane, forms the G heads' scores of a 32-row tile
before one fp32 softmax update per head, and leaves a partial (m, l,
acc); the last block of each (b, kv head) to finish merges the partials
in split order by the rule of ``merge_partials``, which it mirrors, so the
bits do not depend on timing.  It needs fp32 scratch (``torch.empty``,
per call) and a per-device counter buffer allocated and zeroed once (the
merging block resets its counter), so a CUDA graph can capture a call.

The int8-cache form (``decode_attention_int8``, its own custom op, launch
counter and ``by_shape``) is the same kernel over int8 caches with one
fp32 scale per (slot, kv head) for K and for V, as the reference computes
with ``k_scale`` / ``v_scale``: it stages 16 int8 values a lane, reads a
tile's scales beside its rows, and weighs each row's scores by its K
scale and its V row by ``p * v_scale``; the softmax sum takes no scale,
so the partials merge as the bf16 form's do.  Both forms share
``plan_splits`` and the arrival counters (the two never run at once on a
stream), and both capture under a CUDA graph.  The plain version also
covers the sliding-window ring, which the model runs as the dense form
over the ring's first ``min(pos + 1, W)`` slots.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._sharding import placement_types as _sharding_types
from repro_torch.kernels._sharding import replicated, splits_evenly
from repro_torch.kernels.flash_attention import HEAD_DIMS, masked_softmax

SOURCE = "src/repro_torch/csrc/decode_attention.cu"
# the int8-cache form's entry point; both instantiate the kernel of
# csrc/decode_attention.cuh
INT8_SOURCE = "src/repro_torch/csrc/decode_attention_int8.cu"
REPLACES = "src/repro/kernels/decode_attention.py:60"
GROUP_SIZES = (1, 2, 4, 6, 8, 9, 16)   # instantiated in the .cu's switch
FAULT_DROP_LAST_HEAD = 1   # csrc: kDropLastHead, for the checks only
FAULT_IGNORE_V_SCALE = 2   # csrc: kIgnoreVScale (int8 form), the same
SPLIT_GRANULE = 32      # the kernel's tile of cache rows
MAX_SPLITS = 32
MAX_CHUNK = 128         # slots one block walks, where MAX_SPLITS allows


class SplitPlan(NamedTuple):
    """W cut into ``splits`` chunks of ``chunk`` slots (the last may be
    shorter); the kernel's grid is (splits, Hkv, B)."""
    splits: int
    chunk: int


def plan_splits(B: int, Hkv: int, W: int, sm_count: int) -> SplitPlan:
    """The split of the cache for a decode call, from shapes only: enough
    chunks that the B·Hkv pairs fill about one block per SM and that no
    chunk is longer than ``MAX_CHUNK`` slots (at most ``MAX_SPLITS``),
    each a multiple of the kernel's 32-row tile.  Takes plain ints, never
    a tensor, so no host read of ``lengths`` can enter it (B 4, Hkv 2,
    W 1024 on 132 SMs: 16 splits of 64; zamba2's Hkv 32: 8 of 128)."""
    for name, x in (("B", B), ("Hkv", Hkv), ("W", W), ("sm_count", sm_count)):
        if not isinstance(x, int) or isinstance(x, bool):
            raise TypeError(f"plan_splits: {name} must be an int, "
                            f"not {type(x).__name__}")
    W = max(W, 1)
    want = max(-(-sm_count // max(B * Hkv, 1)), -(-W // MAX_CHUNK))
    want = max(1, min(MAX_SPLITS, want))
    chunk = -(-W // want)
    chunk = -(-chunk // SPLIT_GRANULE) * SPLIT_GRANULE
    return SplitPlan(-(-W // chunk), chunk)


def merge_partials(m: torch.Tensor, l: torch.Tensor,
                   acc: torch.Tensor) -> torch.Tensor:
    """The kernel's merge rule.  ``m``, ``l`` [S, ...] and ``acc`` [S, ...,
    hd] are the S splits' running max, sum and unnormalised output (a
    split with no valid slot has m = -inf, l = 0, acc = 0); they are
    combined in split order: M = max m, L = sum l·e^(m-M),
    out = sum acc·e^(m-M) / max(L, 1e-30)."""
    M = m.amax(0)
    M = torch.where(torch.isinf(M), torch.zeros_like(M), M)
    L = torch.zeros_like(M)
    out = torch.zeros_like(acc[0])
    for s in range(m.shape[0]):
        f = torch.exp(m[s] - M)
        L = L + l[s] * f
        out = out + acc[s] * f[..., None]
    return out / L.clamp_min(1e-30)[..., None]


def decode_attention_split(q, k_cache, v_cache, lengths, plan: SplitPlan, *,
                           scale: Optional[float] = None, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """The kernel's algorithm in plain PyTorch (fp32): each split's partial
    (m, l, acc) over its chunk of valid slots, then ``merge_partials``.
    With ``k_scale``/``v_scale`` (int8 caches) each slot's scores take its
    K scale and its V row is weighed by ``p * v_scale``, while ``l`` sums
    ``p`` alone, as the kernel's int8 form does."""
    B, H, hd = q.shape
    W, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(B, Hkv, G, hd).float()
    ms, ls, accs = [], [], []
    for s in range(plan.splits):
        lo, hi = min(s * plan.chunk, W), min((s + 1) * plan.chunk, W)
        slots = torch.arange(lo, hi, device=q.device)
        valid = slots[None] < lengths.long()[:, None]             # [B, n]
        sc = torch.einsum("bhgd,bkhd->bhgk", qg,
                          k_cache[:, lo:hi].float()) * scale
        if k_scale is not None:
            sc = sc * k_scale[:, lo:hi, :, 0].transpose(1, 2)[:, :, None]
        sc = sc.masked_fill(~valid[:, None, None], float("-inf"))
        m = sc.amax(-1) if hi > lo else sc.new_full((B, Hkv, G),
                                                    float("-inf"))
        p = torch.exp(sc - torch.where(torch.isinf(m), 0.0, m)[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        if v_scale is not None:
            p = p * v_scale[:, lo:hi, :, 0].transpose(1, 2)[:, :, None]
        accs.append(torch.einsum("bhgk,bkhd->bhgd", p,
                                 v_cache[:, lo:hi].float()))
    out = merge_partials(torch.stack(ms), torch.stack(ls), torch.stack(accs))
    return out.reshape(B, H, hd).to(q.dtype)


def decode_attention_plain(q, k_cache, v_cache, lengths, *,
                           scale: Optional[float] = None, window: int = 0,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """The same function in plain PyTorch (the CPU path and the oracle).

    Position ``lengths - 1`` is the current token.  With ``window`` the
    cache is the ring ``slot = p % W``; with ``k_scale``/``v_scale``
    ([B,W,Hkv,1]) it holds int8 values.  Probabilities are cast to v's
    dtype before the PV product, as the reference does, except on the
    int8 path, where they are weighed by ``v_scale`` in fp32."""
    B, H, hd = q.shape
    W, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    scale = hd ** -0.5 if scale is None else scale
    pos = lengths.long()[:, None] - 1
    slots = torch.arange(W, device=q.device)[None]
    if window:
        slot_pos = pos - torch.remainder(pos - slots, W)
    else:
        slot_pos = slots.expand(B, W)
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window:
        valid &= pos - slot_pos < window
    qg = q.reshape(B, Hkv, G, hd).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * scale
    if k_scale is not None:
        s = s * k_scale[..., 0].transpose(1, 2)[:, :, None, :]
    a = masked_softmax(s, valid[:, None, None])
    if v_scale is not None:
        a = a * v_scale[..., 0].transpose(1, 2)[:, :, None, :]
        o = torch.einsum("bhgk,bkhd->bhgd", a, v_cache.float())
    else:
        o = torch.einsum("bhgk,bkhd->bhgd", a.to(v_cache.dtype).float(),
                         v_cache.float())
    return o.reshape(B, H, hd).to(q.dtype)


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def _decode_op(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               lengths: torch.Tensor, scale: float) -> torch.Tensor:
    raise NotImplementedError(
        f"decode_attention: no implementation on {q.device}")


@_decode_op.register_kernel("cpu")
def _decode_cpu(q, k_cache, v_cache, lengths, scale):
    return decode_attention_plain(q, k_cache, v_cache, lengths, scale=scale)


@_decode_op.register_fake
def _decode_fake(q, k_cache, v_cache, lengths, scale):
    return torch.empty_like(q)


_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_INT8_ARGTYPES = [ctypes.c_void_p] * 2 + _ARGTYPES


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """The per-(b, kv head) arrival counters on ``device``: allocated and
    zeroed once (grown when a call needs more), and left at zero by every
    call, so no call clears them.  A buffer outgrown is kept, never freed:
    a CUDA graph captured on it goes on using its address."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _OUTGROWN.append(buf)
        buf = _COUNTERS[device] = torch.zeros(max(n, 256), dtype=torch.int32,
                                              device=device)
    return buf


_COUNTERS: dict = {}
_OUTGROWN: list = []


def _launch(q, k_cache, v_cache, lengths, scale, plan=None, fault: int = 0,
            k_scale=None, v_scale=None):
    """One launch of the kernel on CUDA tensors, split by ``plan``
    (``plan_splits`` unless given: a plan that does not cover W only
    plants a fault for the checks, as ``fault`` does); with ``k_scale``
    and ``v_scale`` the int8-cache form."""
    B, H, hd = q.shape
    W, Hkv = k_cache.shape[1], k_cache.shape[2]
    int8 = k_scale is not None
    cache_dt = torch.int8 if int8 else q.dtype
    _build.require(q.dtype in _build.DTYPE_CODES
                   and k_cache.dtype == cache_dt
                   and v_cache.dtype == cache_dt,
                   f"decode_attention: dtypes {q.dtype}/{k_cache.dtype}/"
                   f"{v_cache.dtype}")
    _build.require(lengths.dtype == torch.int32 and lengths.shape == (B,),
                   "decode_attention: lengths must be int32 [B]")
    scales = (k_scale, v_scale) if int8 else ()
    _build.require(all(s is not None and s.dtype == torch.float32
                       and s.shape == (B, W, Hkv, 1) for s in scales),
                   f"decode_attention: the int8 form's scales must be fp32 "
                   f"[B, W, Hkv, 1] = {[B, W, Hkv, 1]}")
    _build.require(all(t.is_contiguous() and t.device == q.device
                       for t in (q, k_cache, v_cache, lengths) + scales),
                   "decode_attention: inputs must be contiguous on one device")
    _build.require(hd in HEAD_DIMS and H % Hkv == 0
                   and H // Hkv in GROUP_SIZES,
                   f"decode_attention: hd={hd}, H={H}, Hkv={Hkv} not supported")
    _build.require(k_cache.shape == (B, W, Hkv, hd)
                   and v_cache.shape == k_cache.shape,
                   f"decode_attention: cache shapes {k_cache.shape} "
                   f"{v_cache.shape}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    if plan is None:
        plan = plan_splits(B, Hkv, W, _build.sm_count(q.device))
    scratch = torch.empty(B * Hkv * plan.splits * H // Hkv * (hd + 2),
                          dtype=torch.float32, device=q.device)
    if int8:
        fn = _build.entry("decode_attention_int8_launch", _INT8_ARGTYPES)
        ptrs = (q, k_cache, v_cache, k_scale, v_scale)
    else:
        fn = _build.entry("decode_attention_launch", _ARGTYPES)
        ptrs = (q, k_cache, v_cache)
    _build.check(fn(*(t.data_ptr() for t in ptrs), lengths.data_ptr(),
                    out.data_ptr(), scratch.data_ptr(),
                    _counters(q.device, B * Hkv).data_ptr(), B, H, Hkv, W,
                    hd, plan.splits, plan.chunk, scale,
                    _build.DTYPE_CODES[q.dtype], fault,
                    _build.stream_handle(q)),
                 "decode_attention_int8" if int8 else "decode_attention")
    return out


@_decode_op.register_kernel("cuda")
def _decode_cuda(q, k_cache, v_cache, lengths, scale):
    out = _launch(q, k_cache, v_cache, lengths, scale)
    if q.numel():
        decode_attention.launches += 1
        decode_attention.by_shape[(tuple(q.shape),
                                   tuple(k_cache.shape))] += 1
    return out


def decode_attention(q, k_cache, v_cache, lengths, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q [B,H,hd]; caches [B,W,Hkv,hd]; lengths [B] int32 -> [B,H,hd].
    CUDA tensors launch the kernel, CPU tensors take the plain version."""
    hd = q.shape[-1]
    return _decode_op(q, k_cache, v_cache, lengths,
                      float(hd ** -0.5 if scale is None else scale))


decode_attention.launches = 0    # kernel launches (CUDA path only)
decode_attention.by_shape = Counter()   # ... by (q.shape, k_cache.shape)


@torch.library.custom_op("repro_torch::decode_attention_int8",
                         mutates_args=())
def _decode_int8_op(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, lengths: torch.Tensor,
                    k_scale: torch.Tensor, v_scale: torch.Tensor,
                    scale: float) -> torch.Tensor:
    raise NotImplementedError(
        f"decode_attention_int8: no implementation on {q.device}")


@_decode_int8_op.register_kernel("cpu")
def _decode_int8_cpu(q, k_cache, v_cache, lengths, k_scale, v_scale, scale):
    return decode_attention_plain(q, k_cache, v_cache, lengths, scale=scale,
                                  k_scale=k_scale, v_scale=v_scale)


@_decode_int8_op.register_fake
def _decode_int8_fake(q, k_cache, v_cache, lengths, k_scale, v_scale, scale):
    return torch.empty_like(q)


@_decode_int8_op.register_kernel("cuda")
def _decode_int8_cuda(q, k_cache, v_cache, lengths, k_scale, v_scale, scale):
    out = _launch(q, k_cache, v_cache, lengths, scale, k_scale=k_scale,
                  v_scale=v_scale)
    if q.numel():
        decode_attention_int8.launches += 1
        decode_attention_int8.by_shape[(tuple(q.shape),
                                        tuple(k_cache.shape))] += 1
    return out


def decode_attention_int8(q, k_cache, v_cache, lengths, k_scale, v_scale, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q [B,H,hd] fp32 or bf16; caches int8 [B,W,Hkv,hd]; scales fp32
    [B,W,Hkv,1]; lengths [B] int32 -> [B,H,hd] in q's dtype.  CUDA tensors
    launch the kernel's int8 form, CPU tensors take the plain version."""
    hd = q.shape[-1]
    return _decode_int8_op(q, k_cache, v_cache, lengths, k_scale, v_scale,
                           float(hd ** -0.5 if scale is None else scale))


decode_attention_int8.launches = 0    # kernel launches (CUDA path only)
decode_attention_int8.by_shape = Counter()   # ... by (q.shape, k_cache.shape)


# ------------------------------------------------------------- sharding --
def _sharding(q, k_cache, v_cache, lengths, scale):
    """Batch split; heads under flash attention's rule (q's H and the
    caches' Hkv split evenly alike).  The cache's slot dim stays whole: a
    kernel over a slot shard would normalise its softmax over that shard
    alone, so DTensor gathers a slot-split cache first."""
    S, R, _ = _sharding_types()
    rows = [([S(0)], [S(0)] * 4 + [None])]
    if splits_evenly(q.mesh, q.shape[1], k_cache.shape[2]):
        rows.append(([S(1)], [S(1), S(2), S(2), R, None]))
    return rows + [replicated(1, (q, k_cache, v_cache, lengths, scale))]


def _int8_sharding(q, k_cache, v_cache, lengths, k_scale, v_scale, scale):
    """The dense form's rows, the scales split as their caches."""
    S, R, _ = _sharding_types()
    rows = [([S(0)], [S(0)] * 6 + [None])]
    if splits_evenly(q.mesh, q.shape[1], k_cache.shape[2]):
        rows.append(([S(1)], [S(1), S(2), S(2), R, S(2), S(2), None]))
    return rows + [replicated(1, (q, k_cache, v_cache, lengths, k_scale,
                                  v_scale, scale))]


SHARDING = (("decode_attention", _sharding),
            ("decode_attention_int8", _int8_sharding))
