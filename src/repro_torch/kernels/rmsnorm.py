"""RMSNorm: a hand-written CUDA kernel and its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/rmsnorm.py:rmsnorm`` (Pallas) and
computes what the rmsnorm branch of ``repro/models/layers.py:apply_norm``
computes: ``x * rsqrt(mean(x^2, -1) + eps) * scale`` in fp32, written in
x's dtype, with the fp32 scale applied before the cast.

What bounds it on the H100: bytes.  It does ~4 flops per element against
4 (bf16) or 8 (fp32) bytes moved.  The kernel (``csrc/rmsnorm.cu``) gives
each row one block, moves 16 bytes per thread per access, reduces in fp32
with warp shuffles and writes each element once.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/csrc/rmsnorm.cu"
REPLACES = "src/repro/kernels/rmsnorm.py:24"


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """The same function in plain PyTorch (the CPU path and the oracle)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=())
def _rmsnorm_op(x: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    raise NotImplementedError(f"rmsnorm: no implementation on {x.device}")


@_rmsnorm_op.register_kernel("cpu")
def _rmsnorm_cpu(x, scale, eps):
    return rmsnorm_plain(x, scale, eps)


@_rmsnorm_op.register_fake
def _rmsnorm_fake(x, scale, eps):
    return torch.empty_like(x)


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


@_rmsnorm_op.register_kernel("cuda")
def _rmsnorm_cuda(x, scale, eps):
    D = x.shape[-1]
    _build.require(x.dtype in _build.DTYPE_CODES,
                   f"rmsnorm: dtype {x.dtype} not supported")
    _build.require(x.is_contiguous(), "rmsnorm: x must be contiguous")
    _build.require(D % 8 == 0, f"rmsnorm: D={D} is not a multiple of 8")
    _build.require(scale.dtype == torch.float32 and scale.shape == (D,)
                   and scale.is_contiguous() and scale.device == x.device,
                   "rmsnorm: scale must be a contiguous fp32 [D] on x's device")
    out = torch.empty_like(x)
    rows = x.numel() // D
    if rows == 0:
        return out
    fn = _build.entry("rmsnorm_launch", _ARGTYPES)
    _build.check(fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D,
                    eps, _build.DTYPE_CODES[x.dtype], _build.stream_handle(x)),
                 "rmsnorm")
    rmsnorm.launches += 1
    return out


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x [..., D]; scale [D] fp32.  CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    return _rmsnorm_op(x, scale, float(eps))


rmsnorm.launches = 0    # kernel launches (CUDA path only)
