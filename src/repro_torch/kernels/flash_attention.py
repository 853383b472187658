"""GQA prefill attention: a hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py:flash_attention``
(Pallas) and computes what ``repro/models/layers.py:chunked_attention``
computes: causal, sliding-window or bidirectional attention of
``q [B,Sq,H,hd]`` against ``k, v [B,Sk,Hkv,hd]``, query i at position
``i + q_offset`` (end-aligned by default: ``q_offset = Sk - Sq``), query
head h reading KV head ``h // (H // Hkv)``, fp32 softmax.

What bounds it on the H100: operations at long sequences (4·hd flops per
query-key pair), bytes at the short prompts a server sees.  The kernel
(``csrc/flash_attention.cu``) keeps the online-softmax state in fp32
registers and carries it across K/V tiles staged in shared memory, so
the [Sq, Sk] scores never reach device memory; tiles a query tile cannot
see (causal, window) are skipped and the ragged edge is masked.  Its
products run on the CUDA cores in fp32; tensor cores (wgmma) are a later
step.  A block serves one query head, so the G query heads of a KV group
each stage the same K/V tiles (as fp32); giving one block the whole
group, as the decode kernel does, is the step before wgmma.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:80"
HEAD_DIMS = (16, 32, 64, 128)
NEG_INF = -1e30


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
    """The same function in plain PyTorch (the CPU path and the oracle).
    Probabilities are cast to v's dtype before the PV product, as the
    reference does."""
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
    return torch.empty_like(q)


_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


@_flash_op.register_kernel("cuda")
def _flash_cuda(q, k, v, causal, window, scale, q_offset):
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    _build.require(q.dtype in _build.DTYPE_CODES and k.dtype == q.dtype
                   and v.dtype == q.dtype,
                   f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    _build.require(all(t.is_contiguous() and t.device == q.device
                       for t in (q, k, v)),
                   "flash_attention: q, k, v must be contiguous on one device")
    _build.require(hd in HEAD_DIMS, f"flash_attention: hd={hd} not in "
                   f"{HEAD_DIMS}")
    _build.require(k.shape == (B, Sk, Hkv, hd) and v.shape == k.shape
                   and H % Hkv == 0,
                   f"flash_attention: shapes {q.shape} {k.shape} {v.shape}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    fn = _build.entry("flash_attention_launch", _ARGTYPES)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, Sq, Sk, H, Hkv, hd, int(causal), window, scale,
                    q_offset, _build.DTYPE_CODES[q.dtype],
                    _build.stream_handle(q)),
                 "flash_attention")
    flash_attention.launches += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: Optional[float] = None,
                    q_offset: Optional[int] = None) -> torch.Tensor:
    """q [B,Sq,H,hd]; k, v [B,Sk,Hkv,hd] -> [B,Sq,H,hd].  CUDA tensors
    launch the kernel, CPU tensors take the plain version."""
    hd, Sq, Sk = q.shape[-1], q.shape[1], k.shape[1]
    return _flash_op(q, k, v, bool(causal), int(window),
                     float(hd ** -0.5 if scale is None else scale),
                     int(Sk - Sq if q_offset is None else q_offset))


flash_attention.launches = 0    # kernel launches (CUDA path only)
