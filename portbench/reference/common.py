"""Plain float32 pieces shared by the reference models.

Plain PyTorch only: nothing here imports ``repro_torch``, JAX or any kernel.
Every product runs in float32 with TF32 off (``fp32``)."""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def fp32():
    """Float32 products without TF32 (the card would round them to TF32)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def f(t):
    return t.float()


def rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * f(scale)


def rope(x, pos, theta):
    """x [S, H, d]: rotate the two halves of each head by pos * theta^(-i/half)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float64,
                                   device=x.device) / half)
    ang = (pos.double()[:, None] * freq).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * torch.cos(ang) - x2 * torch.sin(ang),
                      x2 * torch.cos(ang) + x1 * torch.sin(ang)], -1)


def causal_attention(q, k, v):
    """q, k [S, H, d], v [S, H, dv] -> [S, H, dv]; softmax(q k^T / sqrt(d))."""
    S = q.shape[0]
    s = torch.einsum("qhd,khd->hqk", q, k) * q.shape[-1] ** -0.5
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v)


def swiglu(x, w1, w3, w2):
    return (F.silu(x @ f(w1)) * (x @ f(w3))) @ f(w2)
