"""Chunkwise mLSTM scan: a hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``repro/kernels/mlstm.py:mlstm_chunk_scan``
(Pallas) and computes what ``repro/models/xlstm.py:mlstm_forward``
computes between its gates and its output gate: over chunked views, the
intra-chunk masked ``q kᵀ v`` plus ``q C e^{cumf}``, normalised by
``max(|n|, 1)``, with the matrix memory C and the normaliser n carried
from chunk to chunk.  Unlike the Pallas kernel it also returns the final
(C, n), which the model keeps as its decode cache.

What bounds it on the H100: bytes, at the card's bf16 rates (one read of
q, k, v and one write of y and the state); this kernel, in fp32 on the
CUDA cores, is bound by its operations (the Q² dh score products).  The
Pallas grid (B, nc) keeps every head's C in one program (1 MiB per head
at xlstm-350m's dh = 512); the kernel (``csrc/mlstm_scan.cu``) gives a
block one (b, head) and a 64-wide tile of C's value columns (128 KB of
shared memory), 32 blocks per request, each recomputing its head's
scores and normaliser.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan import MAX_Q, _causal

SOURCE = "src/repro_torch/csrc/mlstm_scan.cu"
REPLACES = "src/repro/kernels/mlstm.py:54"
MAX_DH = 512


def mlstm_chunk_plain(q, k, v, cumf, li, C_prev, n_prev, *,
                      diagonal: int = 0):
    """One chunk, as ``repro/kernels/ref.py:mlstm_chunk``: q, k, v
    [B,Q,nh,dh]; cumf, li [B,Q,nh]; C_prev [B,nh,dh,dh]; n_prev [B,nh,dh]
    -> (y, C, n).  The causal mask keeps ``j <= i + diagonal`` (the
    model's is 0)."""
    Q = q.shape[1]
    q, k, v = q.float(), k.float(), v.float()
    scores = torch.einsum("bihd,bjhd->bijh", q, k)
    decay = torch.exp(cumf[:, :, None] - cumf[:, None, :] + li[:, None])
    lmat = torch.where(_causal(Q, diagonal, q.device)[None, :, :, None],
                       decay, 0.0)
    y_diag = torch.einsum("bijh,bjhd->bihd", scores * lmat, v)
    n_diag = torch.einsum("bijh,bjhd->bihd", lmat, k)
    iw = torch.exp(cumf)
    y_off = torch.einsum("bihd,bhde->bihe", q, C_prev) * iw[..., None]
    n_off = torch.einsum("bihd,bhd->bih", q, n_prev) * iw
    n = (q * n_diag).sum(-1) + n_off
    y = (y_diag + y_off) / torch.clamp_min(n.abs()[..., None], 1.0)
    kbar = k * torch.exp(cumf[:, -1:] - cumf + li)[..., None]
    cd = torch.exp(cumf[:, -1])
    C = C_prev * cd[:, :, None, None] + torch.einsum("bjhd,bjhe->bhde",
                                                     kbar, v)
    n_new = n_prev * cd[..., None] + kbar.sum(1)
    return y, C, n_new


def mlstm_chunk_scan_plain(q, k, v, cumf, li, *, diagonal: int = 0):
    """The same function as the kernel in plain PyTorch (the CPU path and
    the oracle): ``mlstm_chunk_plain`` chained over the chunks.

    q, k, v [B,nc,Q,nh,dh]; cumf, li [B,nc,Q,nh] fp32 -> (y [B,nc,Q,nh,dh]
    fp32, C [B,nh,dh,dh] fp32, n [B,nh,dh] fp32)."""
    B, nc, Q, nh, dh = q.shape
    C = q.new_zeros(B, nh, dh, dh, dtype=torch.float32)
    n = q.new_zeros(B, nh, dh, dtype=torch.float32)
    ys = []
    for c in range(nc):
        y, C, n = mlstm_chunk_plain(q[:, c], k[:, c], v[:, c], cumf[:, c],
                                    li[:, c], C, n, diagonal=diagonal)
        ys.append(y)
    return torch.stack(ys, 1), C, n


@torch.library.custom_op("repro_torch::mlstm_chunk_scan", mutates_args=())
def _scan_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             cumf: torch.Tensor, li: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    raise NotImplementedError(
        f"mlstm_chunk_scan: no implementation on {q.device}")


@_scan_op.register_kernel("cpu")
def _scan_cpu(q, k, v, cumf, li):
    return mlstm_chunk_scan_plain(q, k, v, cumf, li)


@_scan_op.register_fake
def _scan_fake(q, k, v, cumf, li):
    B, _, _, nh, dh = q.shape
    f32 = torch.float32
    return (torch.empty_like(q, dtype=f32), q.new_empty(B, nh, dh, dh,
                                                        dtype=f32),
            q.new_empty(B, nh, dh, dtype=f32))


_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


@_scan_op.register_kernel("cuda")
def _scan_cuda(q, k, v, cumf, li):
    B, nc, Q, nh, dh = q.shape
    _build.require(q.dtype in _build.DTYPE_CODES and k.dtype == q.dtype
                   and v.dtype == q.dtype and cumf.dtype == torch.float32
                   and li.dtype == torch.float32,
                   f"mlstm_chunk_scan: dtypes {q.dtype}/{k.dtype}/{v.dtype}/"
                   f"{cumf.dtype}/{li.dtype}")
    _build.require(k.shape == q.shape and v.shape == q.shape
                   and cumf.shape == (B, nc, Q, nh) and li.shape == cumf.shape,
                   f"mlstm_chunk_scan: shapes {q.shape} {k.shape} {v.shape} "
                   f"{cumf.shape} {li.shape}")
    _build.require(all(t.is_contiguous() and t.device == q.device
                       for t in (q, k, v, cumf, li)),
                   "mlstm_chunk_scan: inputs must be contiguous on one device")
    _build.require(1 <= Q <= MAX_Q and 1 <= dh <= MAX_DH,
                   f"mlstm_chunk_scan: Q={Q}, dh={dh} not supported")
    f32 = torch.float32
    y = torch.empty_like(q, dtype=f32)
    C = q.new_empty(B, nh, dh, dh, dtype=f32)
    n = q.new_empty(B, nh, dh, dtype=f32)
    fn = _build.entry("mlstm_chunk_scan_launch", _ARGTYPES)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), cumf.data_ptr(),
                    li.data_ptr(), y.data_ptr(), C.data_ptr(), n.data_ptr(),
                    B, nc, Q, nh, dh, _build.DTYPE_CODES[q.dtype],
                    _build.stream_handle(q)),
                 "mlstm_chunk_scan")
    mlstm_chunk_scan.launches += 1
    return y, C, n


def mlstm_chunk_scan(q, k, v, cumf, li):
    """q, k, v [B,nc,Q,nh,dh]; cumf, li [B,nc,Q,nh] fp32 -> (y
    [B,nc,Q,nh,dh] fp32 normalised, C [B,nh,dh,dh] fp32, n [B,nh,dh]
    fp32).  CUDA tensors launch the kernel, CPU tensors take the plain
    version."""
    return _scan_op(q, k, v, cumf, li)


mlstm_chunk_scan.launches = 0    # kernel launches (CUDA path only)
