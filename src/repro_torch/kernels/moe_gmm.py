"""Grouped expert matmul: a hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``repro/kernels/moe_gmm.py:moe_gmm`` (Pallas) and
computes what ``repro/kernels/ref.py:moe_gmm`` computes: ``x [E,C,D] @
w [E,D,F] -> [E,C,F]``, one product per expert, summed over D in fp32 and
written in x's dtype.

What bounds it on the H100: bytes.  The MoE layer's capacity dispatch
gives every expert its C rows (6 at a deepseek decode step, 32 to 64 at
its prefill buckets) whether or not a token went there, so each call
streams the whole weight tensor for a few dozen rows.  The kernel
(``csrc/moe_gmm.cu``) gives one block a 64-column tile of one expert's
output with all of its rows (up to 64; more rows add row tiles), so each
weight element is read from device memory once; the D loop stages
16-byte loads of x and w through shared memory and accumulates in fp32
registers, with no divisibility required of C, D or F.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/csrc/moe_gmm.cu"
REPLACES = "src/repro/kernels/moe_gmm.py:34"


def moe_gmm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch (the CPU path and the oracle)."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


@torch.library.custom_op("repro_torch::moe_gmm", mutates_args=())
def _moe_gmm_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    raise NotImplementedError(f"moe_gmm: no implementation on {x.device}")


@_moe_gmm_op.register_kernel("cpu")
def _moe_gmm_cpu(x, w):
    return moe_gmm_plain(x, w)


@_moe_gmm_op.register_fake
def _moe_gmm_fake(x, w):
    return x.new_empty(x.shape[0], x.shape[1], w.shape[2])


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _rows_aligned(t: torch.Tensor) -> bool:
    """Every row of the contiguous ``t`` starts on a 16-byte boundary."""
    return t.data_ptr() % 16 == 0 and t.shape[-1] * t.element_size() % 16 == 0


@_moe_gmm_op.register_kernel("cuda")
def _moe_gmm_cuda(x, w):
    _build.require(x.dim() == 3 and w.dim() == 3 and x.shape[0] == w.shape[0]
                   and x.shape[2] == w.shape[1],
                   f"moe_gmm: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    _build.require(x.dtype in _build.DTYPE_CODES and w.dtype == x.dtype,
                   f"moe_gmm: dtypes {x.dtype}/{w.dtype}")
    _build.require(x.is_contiguous() and w.is_contiguous()
                   and w.device == x.device,
                   "moe_gmm: x and w must be contiguous on one device")
    E, R, D = x.shape
    F = w.shape[2]
    out = x.new_empty(E, R, F)
    if out.numel() == 0:
        return out
    fn = _build.entry("moe_gmm_launch", _ARGTYPES)
    _build.check(fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), E, R, D, F,
                    int(_rows_aligned(x)), int(_rows_aligned(w)),
                    _build.DTYPE_CODES[x.dtype], _build.stream_handle(x)),
                 "moe_gmm")
    moe_gmm.launches += 1
    return out


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [E,C,D] @ w [E,D,F] -> [E,C,F].  CUDA tensors launch the kernel,
    CPU tensors take the plain version."""
    return _moe_gmm_op(x, w)


moe_gmm.launches = 0    # kernel launches (CUDA path only)
