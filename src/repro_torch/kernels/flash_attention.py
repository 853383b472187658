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
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional

import torch

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:80"
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


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """fp32 softmax over the last axis with masked entries at -1e30
    (``repro/models/layers.py:_masked_softmax``)."""
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    e = torch.exp(scores - m)
    return e / e.sum(-1, keepdim=True).clamp_min(1e-30)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: Optional[float] = None,
                          q_offset: Optional[int] = None) -> torch.Tensor:
    """The same function in plain PyTorch (the CPU path and the oracle),
    -> [B,Sq,H,hd_v].  Probabilities are cast to v's dtype before the PV
    product, as the reference does."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    q_offset = Sk - Sq if q_offset is None else q_offset
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    pq = torch.arange(Sq, device=q.device)[:, None] + q_offset
    pk = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= pq >= pk
    if window:
        mask &= pq - pk < window
    a = masked_softmax(s, mask)
    o = torch.einsum("bhqk,bkhd->bqhd", a.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: int, scale: float,
              q_offset: int) -> torch.Tensor:
    raise NotImplementedError(
        f"flash_attention: no implementation on {q.device}")


@_flash_op.register_kernel("cpu")
def _flash_cpu(q, k, v, causal, window, scale, q_offset):
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 scale=scale, q_offset=q_offset)


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
