"""Mamba2 (SSD) blocks: chunked prefill and recurrent decode.

Counterpart of ``repro/models/ssm.py``.  The reference computes the SSD
chunk scan in pure JAX (an ``associative_scan`` across chunks); here the
intra-chunk term, the chunk states, the inter-chunk carry and the
carried-state term are one call of the ``mamba_chunk_scan`` kernel, which
also returns the final state.  The projections, the causal conv, the
``D`` skip, the ``silu(z)`` gate, the inner norm (the ``rmsnorm`` kernel)
and the output projection stay around it.  The single-token decode has no
kernel in the reference and stays plain PyTorch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import kernels as K
from repro_torch import sharding as SH
from repro_torch.models.layers import ParamSpec, apply_norm, norm_schema


def pick_chunk(S: int, chunk: int) -> int:
    """Largest divisor of S that is <= chunk (SSD chunk must divide S)."""
    q = min(chunk, S)
    while S % q:
        q -= 1
    return q


def mamba2_dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = s.num_heads or d_in // s.head_dim
    return d_in, nh, s.head_dim, s.state_dim


def mamba2_schema(cfg):
    D = cfg.d_model
    d_in, nh, P, N = mamba2_dims(cfg)
    Kw = cfg.ssm.conv_width
    return {
        "w_z": ParamSpec((D, d_in), ("fsdp", "ssm_inner"), D ** -0.5),
        "w_x": ParamSpec((D, d_in), ("fsdp", "ssm_inner"), D ** -0.5),
        "w_B": ParamSpec((D, N), ("fsdp", None), D ** -0.5),
        "w_C": ParamSpec((D, N), ("fsdp", None), D ** -0.5),
        "w_dt": ParamSpec((D, nh), ("fsdp", "ssm_heads"), D ** -0.5),
        "conv_x": ParamSpec((Kw, d_in), ("conv", "ssm_inner"), 0.1),
        "conv_b": ParamSpec((Kw, 2 * N), ("conv", None), 0.1),
        "bias_x": ParamSpec((d_in,), ("ssm_inner",), 0.0),
        "bias_bc": ParamSpec((2 * N,), (None,), 0.0),
        "A_log": ParamSpec((nh,), ("ssm_heads",), 0.0, "float32"),
        "D_skip": ParamSpec((nh,), ("ssm_heads",), -1.0, "float32"),
        "dt_bias": ParamSpec((nh,), ("ssm_heads",), 0.02, "float32"),
        "norm": norm_schema(d_in),
        "out_proj": ParamSpec((d_in, D), ("ssm_inner", "fsdp"), d_in ** -0.5),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv along S.  x [B,S,C]; w [K,C]."""
    Kw = w.shape[0]
    pad = SH.pad(x, (0, 0, Kw - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(Kw))
    return F.silu(out + b)


def _proj_all(p, x, rules=None):
    """-> z [..,d_in], xs raw [..,d_in], BC raw [..,2N], dt [..,nh]."""
    z = x @ p["w_z"]
    xs = x @ p["w_x"]
    BC = torch.cat([x @ p["w_B"], x @ p["w_C"]], -1)
    dt = x @ p["w_dt"]
    if rules is not None and x.ndim == 3:
        # their gradients come back as they were split (grad_like): one
        # split on seq would not flatten into the products' rows
        z = SH.grad_like(SH.constrain(z, ("batch", None, "ssm_inner"),
                                      rules))
        xs = SH.grad_like(SH.constrain(xs, ("batch", None, "ssm_inner"),
                                       rules))
        BC, dt = SH.grad_like(BC), SH.grad_like(dt)
    return z, xs, BC, dt


def mamba2_forward(p, x, cfg, rules=None):
    """x [B,S,D] -> (y [B,S,D], final state) via the chunked SSD kernel."""
    B, S, D = x.shape
    d_in, nh, P, N = mamba2_dims(cfg)
    Q = pick_chunk(S, cfg.ssm.chunk)
    nc = S // Q

    z, xs_raw, BC_raw, dt = _proj_all(p, x, rules)
    Kw = cfg.ssm.conv_width
    conv_tail = {"x": xs_raw[:, -(Kw - 1):], "bc": BC_raw[:, -(Kw - 1):]}
    xs = _causal_conv(xs_raw, p["conv_x"], p["bias_x"]).reshape(B, S, nh, P)
    BC = _causal_conv(BC_raw, p["conv_b"], p["bias_bc"])
    Bm, Cm = BC[..., :N], BC[..., N:]
    dt = F.softplus(dt.float() + p["dt_bias"])          # [B,S,nh]
    da = dt * -torch.exp(p["A_log"])                    # log-decay [B,S,nh]

    c = lambda t: t.reshape(B, nc, Q, *t.shape[2:])
    cum = torch.cumsum(c(da), dim=2)                    # [B,nc,Q,nh]
    xbar = (c(xs) * c(dt)[..., None]).float()
    y, state = K.mamba_chunk_scan(xbar.contiguous(), c(Bm).contiguous(),
                                  c(Cm).contiguous(), cum.contiguous())
    y = y.reshape(B, S, nh, P) + p["D_skip"][:, None] * xs.float()
    y = y.reshape(B, S, d_in).to(x.dtype) * F.silu(z)
    y = apply_norm(p["norm"], y)
    # whole on seq before the row-parallel product (DTensor would flatten
    # a seq split of the scan's output into strided shards)
    y = SH.grad_like(SH.constrain(y, ("batch", None, "ssm_inner"), rules))
    return y @ p["out_proj"], {"ssm": state, "conv": conv_tail}


def mamba2_init_state(cfg, batch, dtype, device):
    d_in, nh, P, N = mamba2_dims(cfg)
    Kw = cfg.ssm.conv_width
    z = lambda *s, dt=dtype: torch.zeros(s, dtype=dt, device=device)
    return {"ssm": z(batch, nh, P, N, dt=torch.float32),
            "conv": {"x": z(batch, Kw - 1, d_in),
                     "bc": z(batch, Kw - 1, 2 * N)}}


def mamba2_decode(p, x, cfg, state):
    """x [B,1,D]; recurrent single-token update -> (y [B,1,D], new state)."""
    B = x.shape[0]
    d_in, nh, P, N = mamba2_dims(cfg)
    z, xs_raw, BC_raw, dt = _proj_all(p, x[:, 0])
    win_x = torch.cat([state["conv"]["x"], xs_raw[:, None]], 1)
    xs = F.silu((win_x * p["conv_x"][None]).sum(1) + p["bias_x"])
    win_bc = torch.cat([state["conv"]["bc"], BC_raw[:, None]], 1)
    BC = F.silu((win_bc * p["conv_b"][None]).sum(1) + p["bias_bc"])
    new_conv = {"x": win_x[:, 1:], "bc": win_bc[:, 1:]}
    xs = xs.reshape(B, nh, P)
    Bm, Cm = BC[..., :N].float(), BC[..., N:].float()
    dt = F.softplus(dt.float() + p["dt_bias"])          # [B,nh]
    a = torch.exp(dt * -torch.exp(p["A_log"]))          # [B,nh]
    xbar = (xs * dt[..., None]).float()
    h = state["ssm"] * a[..., None, None] + \
        torch.einsum("bn,bhp->bhpn", Bm, xbar)
    y = torch.einsum("bn,bhpn->bhp", Cm, h)
    y = y + p["D_skip"][:, None] * xs.float()
    y = y.reshape(B, d_in).to(x.dtype) * F.silu(z)
    y = apply_norm(p["norm"], y)
    return (y @ p["out_proj"])[:, None], {"ssm": h, "conv": new_conv}
