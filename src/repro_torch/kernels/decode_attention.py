"""Single-token GQA decode attention: a hand-written CUDA kernel and its
plain version.

Replaces the TPU kernel ``repro/kernels/decode_attention.py:
decode_attention`` (Pallas): ``q [B,H,hd]`` against caches
``[B,W,Hkv,hd]`` with slots ``>= lengths[b]`` masked, the G query heads of
a KV group served together, fp32 softmax.  It is the dense form of
``repro/models/layers.py:decode_attention`` (there ``lengths = pos + 1``).

What bounds it on the H100: bytes.  Each valid K/V row is read once and
used for ~4·G flops per element.  The kernel (``csrc/decode_attention.cu``)
runs one block per (b, kv head), so every K/V row is read once for its G
heads, skips the masked tail of the cache instead of reading it, and
merges its warps' softmax states in a fixed order.  B·Hkv blocks leave
most SMs idle at serving batch sizes; splitting W is the next step.

The plain version also covers the forms the kernel does not take yet: the
sliding-window ring cache and int8 caches with per-(token, head) scales.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import HEAD_DIMS, masked_softmax

SOURCE = "src/repro_torch/csrc/decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention.py:60"
GROUP_SIZES = (1, 2, 4, 8, 16)


def decode_attention_plain(q, k_cache, v_cache, lengths, *,
                           scale: Optional[float] = None, window: int = 0,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """The same function in plain PyTorch (the CPU path and the oracle).

    Position ``lengths - 1`` is the current token.  With ``window`` the
    cache is the ring ``slot = p % W``; with ``k_scale``/``v_scale``
    ([B,W,Hkv,1]) it holds int8 values.  Probabilities are cast to v's
    dtype before the PV product, as the reference does."""
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


_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


@_decode_op.register_kernel("cuda")
def _decode_cuda(q, k_cache, v_cache, lengths, scale):
    B, H, hd = q.shape
    W, Hkv = k_cache.shape[1], k_cache.shape[2]
    _build.require(q.dtype in _build.DTYPE_CODES and k_cache.dtype == q.dtype
                   and v_cache.dtype == q.dtype,
                   f"decode_attention: dtypes {q.dtype}/{k_cache.dtype}/"
                   f"{v_cache.dtype}")
    _build.require(lengths.dtype == torch.int32 and lengths.shape == (B,),
                   "decode_attention: lengths must be int32 [B]")
    _build.require(all(t.is_contiguous() and t.device == q.device
                       for t in (q, k_cache, v_cache, lengths)),
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
    fn = _build.entry("decode_attention_launch", _ARGTYPES)
    _build.check(fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    lengths.data_ptr(), out.data_ptr(), B, H, Hkv, W, hd,
                    scale, _build.DTYPE_CODES[q.dtype],
                    _build.stream_handle(q)),
                 "decode_attention")
    decode_attention.launches += 1
    return out


def decode_attention(q, k_cache, v_cache, lengths, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q [B,H,hd]; caches [B,W,Hkv,hd]; lengths [B] int32 -> [B,H,hd].
    CUDA tensors launch the kernel, CPU tensors take the plain version."""
    hd = q.shape[-1]
    return _decode_op(q, k_cache, v_cache, lengths,
                      float(hd ** -0.5 if scale is None else scale))


decode_attention.launches = 0    # kernel launches (CUDA path only)
