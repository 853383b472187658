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
atomics).  In bf16 all five products run on the tensor cores (``mma.sync``
as in the forward, dS rounded to bf16 before dQ and dK, as
FlashAttention-2 does); fp32, the parity path, stays on the CUDA cores.
hd 16 to 128 with hd_v = hd.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional

import torch

from repro_torch.kernels import _build
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
    return flash_attention_backward_plain(q, k, v, out, dout, causal=causal,
                                          window=window, scale=scale,
                                          q_offset=q_offset)


@_flash_bwd_op.register_fake
def _flash_bwd_fake(q, k, v, out, dout, causal, window, scale, q_offset):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _launch_backward(q, k, v, out, dout, causal, window, scale, q_offset,
                     short_tiles=0):
    """One run of the backward (two launches) on CUDA tensors.
    ``short_tiles`` > 0 only plants a fault for the checks: launch A then
    walks that many fewer K tiles."""
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
    _build.require(hd_v == hd and hd in HEAD_DIMS,
                   f"flash_attention_backward: hd={hd}, hd_v={hd_v}: the "
                   f"backward takes hd_v = hd in {HEAD_DIMS} (MLA's (192, "
                   f"128) waits for the moe_gmm backward, ROADMAP.md Queue "
                   f"2 item 7)")
    _build.require(k.shape == (B, Sk, Hkv, hd) and v.shape == k.shape
                   and out.shape == q.shape and dout.shape == q.shape
                   and H % Hkv == 0 and B * H < 65536,
                   f"flash_attention_backward: shapes {q.shape} {k.shape} "
                   f"{v.shape} {out.shape} {dout.shape}")
    _build.require(all(t.data_ptr() % 16 == 0 for t in (q, k, v, out, dout)),
                   "flash_attention_backward: inputs must start on 16-byte "
                   "boundaries")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    fn = _build.entry("flash_attention_backward_launch", _BWD_ARGTYPES)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), lse.data_ptr(), delta.data_ptr(), B, Sq,
                    Sk, H, Hkv, hd, int(causal), window, scale, q_offset,
                    short_tiles, _build.DTYPE_CODES[q.dtype],
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
