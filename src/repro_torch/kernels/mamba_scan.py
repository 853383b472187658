"""Mamba2 SSD chunk scan: a hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``repro/kernels/mamba_scan.py:
mamba_chunk_scan_chunked`` (Pallas) and computes what
``repro/models/ssm.py:mamba2_forward`` computes between its projections
and its gate: over chunked views, the intra-chunk term
``(C Bᵀ ⊙ decay mask) x̄``, the carried-state term ``C e^{cum} h`` and the
state ``h <- h e^{cum[-1]} + Σ_j B_j e^{cum[-1] - cum_j} x̄_j`` carried
from chunk to chunk; it returns y and the final state, which the model
keeps as its decode cache.

What bounds it on the H100: operations at zamba2's widths.  The Pallas
grid (B, nc) keeps every head's state in one program (1 MiB per batch row
at zamba2's width); the kernel (``csrc/mamba_scan.cu``) gives a block one
(b, head) and a 32-wide slice of P, so a B = 1 prefill runs 128 blocks,
each looping over the chunks with its state slice in shared memory.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/csrc/mamba_scan.cu"
REPLACES = "src/repro/kernels/mamba_scan.py:73"
MAX_Q, MAX_N = 256, 64


def _causal(Q: int, diagonal: int, device) -> torch.Tensor:
    return torch.ones(Q, Q, dtype=torch.bool, device=device).tril(diagonal)


def mamba_chunk_plain(xbar, B_c, C_c, cum, h_prev, *, diagonal: int = 0):
    """One chunk, as ``repro/kernels/ref.py:mamba_chunk``: xbar [B,Q,nh,P];
    B_c, C_c [B,Q,N]; cum [B,Q,nh]; h_prev [B,nh,P,N] -> (y, new state).
    The causal mask keeps ``j <= i + diagonal`` (the model's is 0)."""
    Q = xbar.shape[1]
    Bf, Cf = B_c.float(), C_c.float()
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


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


@_scan_op.register_kernel("cuda")
def _scan_cuda(xbar, B_c, C_c, cum):
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
    y = torch.empty_like(xbar)
    state = xbar.new_empty(B, nh, P, N)
    fn = _build.entry("mamba_chunk_scan_launch", _ARGTYPES)
    _build.check(fn(xbar.data_ptr(), B_c.data_ptr(), C_c.data_ptr(),
                    cum.data_ptr(), y.data_ptr(), state.data_ptr(), B, nc, Q,
                    nh, P, N, _build.DTYPE_CODES[B_c.dtype],
                    _build.stream_handle(xbar)),
                 "mamba_chunk_scan")
    mamba_chunk_scan.launches += 1
    return y, state


def mamba_chunk_scan(xbar, B_c, C_c, cum):
    """xbar [B,nc,Q,nh,P] fp32; B_c, C_c [B,nc,Q,N]; cum [B,nc,Q,nh] fp32
    -> (y [B,nc,Q,nh,P] fp32, final state [B,nh,P,N] fp32).  CUDA tensors
    launch the kernel, CPU tensors take the plain version."""
    return _scan_op(xbar, B_c, C_c, cum)


mamba_chunk_scan.launches = 0    # kernel launches (CUDA path only)
