"""Chunkwise mLSTM scan: a hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``repro/kernels/mlstm.py:mlstm_chunk_scan``
(Pallas) and computes what ``repro/models/xlstm.py:mlstm_forward``
computes between its gates and its output gate: over chunked views, the
intra-chunk masked ``q kᵀ v`` plus ``q C e^{cumf}``, normalised by
``max(|n|, 1)``, with the matrix memory C and the normaliser n carried
from chunk to chunk.  Unlike the Pallas kernel it also returns the final
(C, n), which the model keeps as its decode cache.

What bounds it on the H100: operations at xlstm-350m's widths (with bf16
q, k, v each product with an fp32 operand costs three bf16 products on
the tensor cores, a little more time than one read of q, k, v and one
write of y and the state).  The Pallas grid (B, nc) walks the chunks in order with
every head's C in one program (1 MiB a head at xlstm-350m's dh = 512).
The kernel (``csrc/mlstm_scan.cu``) regroups the caller's chunks into
kernel chunks of 64 rows (``mamba_scan.plan_scan``; cumf rebased,
``mamba_scan.rebase``) and runs in stages over (b, kernel chunk, head,
tile): the state entering each kernel chunk (one ordered pass per (b,
head, 64 x 64 tile of C)), the masked, decayed scores and their row sums
once per (b, kernel chunk, head), then the outputs per 32 value columns.
bf16 inputs run on the tensor cores, every fp32 operand split into three
bf16 parts (``mamba_scan.split_bf16``); fp32 inputs on the CUDA cores.
``mlstm_chunk_scan_staged`` is the same plan and stages in plain PyTorch,
for the CPU tests.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan import (FAULT_WRONG_STATE, MAX_Q, _causal,
                                            chunked, last_rows, plan_scan,
                                            rebase, split_bf16, unchunked)

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


def mlstm_chunk_scan_staged(q, k, v, cumf, li, *, split: bool = False,
                            fault: int = 0):
    """The kernel's plan and stages in plain PyTorch, in fp32: the state
    entering each kernel chunk by one ordered pass, the masked, decayed
    scores and their row sums once per (b, kernel chunk, head), then the
    outputs.  With ``split`` the three products whose operand is fp32
    (w ⊙ k against v, P against v, q against C) see that operand as the
    bf16 kernel does (``split_bf16``); q kᵀ is exact from bf16 either
    way.  Same arguments and results as ``mlstm_chunk_scan_plain``;
    ``fault`` plants the kernel's faults."""
    B, nc, Q, nh, dh = q.shape
    plan = plan_scan(nc, Q)
    S, L, n = nc * Q, plan.chunk, plan.chunks
    sp = (lambda x: split_bf16(x, fault=fault)) if split else (lambda x: x)
    g = rebase(cumf, plan, fault=fault)                  # [B,n,L,nh]
    gl = last_rows(g, S)                                 # [B,n,nh]
    qc, kc, vc = (chunked(t.float(), plan) for t in (q, k, v))
    lic = chunked(li, plan)
    valid = (torch.arange(n, device=g.device)[:, None] * L
             + torch.arange(L, device=g.device) < S)     # [n,L]
    w = torch.exp(gl[:, :, None] - g + lic) * valid[None, :, :, None]
    C = q.new_zeros(B, nh, dh, dh, dtype=torch.float32)
    nv = q.new_zeros(B, nh, dh, dtype=torch.float32)
    Cin, nin = [], []
    for c in range(n):                                   # the ordered pass
        Cin.append(C)
        nin.append(nv)
        d = torch.exp(gl[:, c])
        kw = w[:, c, ..., None] * kc[:, c]
        C = C * d[..., None, None] + torch.einsum("bjhd,bjhe->bhde", sp(kw),
                                                  vc[:, c])
        nv = nv * d[..., None] + kw.sum(1)
    scores = torch.einsum("bcihd,bcjhd->bcijh", qc, kc)  # once per chunk
    decay = torch.exp(g[:, :, :, None] - g[:, :, None, :] + lic[:, :, None])
    keep = _causal(L, 0, g.device)[None] & valid[:, :, None]
    Pm = torch.where(keep[None, ..., None], scores * decay, 0.0)
    rowsum = Pm.sum(3)                                   # [B,n,L,nh]
    ys = []
    for c in range(n):
        src = c - 1 if fault & FAULT_WRONG_STATE else c
        eg = torch.exp(g[:, c])                          # [B,L,nh]
        num = torch.einsum("bijh,bjhe->bihe", sp(Pm[:, c]), vc[:, c])
        den = rowsum[:, c]
        if src > 0:
            num = num + torch.einsum("bihd,bhde->bihe", qc[:, c],
                                     sp(Cin[src])) * eg[..., None]
            den = den + torch.einsum("bihd,bhd->bih", qc[:, c],
                                     nin[src]) * eg
        ys.append(num / torch.clamp_min(den.abs()[..., None], 1.0))
    return unchunked(torch.stack(ys, 1), nc, Q), C, nv


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


_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def _launch(q, k, v, cumf, li, fault: int = 0):
    """One call of the kernel on CUDA tensors (its two launches); a
    ``fault`` only plants a fault for the checks."""
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
    _build.require(dh * q.element_size() % 16 == 0
                   and all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
                   f"mlstm_chunk_scan: q, k, v rows of dh={dh} must be "
                   f"16-byte aligned")
    plan = plan_scan(nc, Q)
    f32 = torch.float32
    y = torch.empty_like(q, dtype=f32)
    C = q.new_empty(B, nh, dh, dh, dtype=f32)
    n = q.new_empty(B, nh, dh, dtype=f32)
    if y.numel() == 0:
        return y, C, n
    # scratch: the state entering each kernel chunk but the first; the
    # masked, decayed scores of each (b, kernel chunk, head), row sums.
    # Cin grows with the prompt: nh·dh²·4 bytes a kernel chunk and batch
    # row (4 MiB at xlstm-350m: 60 MiB at 1,024 tokens, 2 GiB at 32k)
    Cin = q.new_empty(plan.chunks - 1, B, nh, dh, dh, dtype=f32)
    nin = q.new_empty(plan.chunks - 1, B, nh, dh, dtype=f32)
    P = q.new_empty(B, plan.chunks, nh, plan.chunk, plan.chunk, dtype=f32)
    den = q.new_empty(B, plan.chunks, nh, plan.chunk, dtype=f32)
    fn = _build.entry("mlstm_chunk_scan_launch", _ARGTYPES)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), cumf.data_ptr(),
                    li.data_ptr(), y.data_ptr(), C.data_ptr(), n.data_ptr(),
                    Cin.data_ptr(), nin.data_ptr(), P.data_ptr(),
                    den.data_ptr(), B, nc, Q, nh, dh, plan.chunk, plan.chunks,
                    _build.DTYPE_CODES[q.dtype], fault,
                    _build.stream_handle(q)),
                 "mlstm_chunk_scan")
    return y, C, n


@_scan_op.register_kernel("cuda")
def _scan_cuda(q, k, v, cumf, li):
    out = _launch(q, k, v, cumf, li)
    if out[0].numel():
        mlstm_chunk_scan.launches += 1
    return out


def mlstm_chunk_scan(q, k, v, cumf, li):
    """q, k, v [B,nc,Q,nh,dh]; cumf, li [B,nc,Q,nh] fp32 -> (y
    [B,nc,Q,nh,dh] fp32 normalised, C [B,nh,dh,dh] fp32, n [B,nh,dh]
    fp32).  CUDA tensors launch the kernel, CPU tensors take the plain
    version."""
    return _scan_op(q, k, v, cumf, li)


mlstm_chunk_scan.launches = 0    # kernel launches (CUDA path only)
