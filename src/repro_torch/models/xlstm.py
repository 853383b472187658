"""xLSTM blocks: mLSTM (chunkwise matrix memory) and sLSTM (scalar memory
with exponential gating and a stabiliser state).

Counterpart of ``repro/models/xlstm.py``.  The reference computes the
mLSTM chunk scan in pure JAX (an ``associative_scan`` across chunks);
here the intra-chunk term, the carried (C, n), the inter-chunk term and
the normalisation are one call of the ``mlstm_chunk_scan`` kernel, which
also returns the final (C, n) for the decode cache.  The sLSTM recurrence
is non-linear and has no kernel in the reference (``lax.scan``): it is a
plain loop over time here.

The mLSTM head dim is ``d_in // nh`` (512 at xlstm-350m's width), not
``cfg.head_dim``; the sLSTM's is ``D // nh``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import kernels as K
from repro_torch import sharding as SH
from repro_torch.models.layers import ParamSpec, apply_norm, norm_schema
from repro_torch.models.ssm import pick_chunk
from repro_torch.sharding import constrain


def mlstm_dims(cfg):
    d_in = int(cfg.d_model * cfg.xlstm.proj_factor_m)
    nh = cfg.num_heads
    return d_in, nh, d_in // nh


def mlstm_schema(cfg):
    D = cfg.d_model
    d_in, nh, dh = mlstm_dims(cfg)
    return {
        "w_up": ParamSpec((D, 2 * d_in), ("fsdp", "ssm_inner"), D ** -0.5),
        "wq": ParamSpec((d_in, d_in), ("ssm_inner", None), d_in ** -0.5),
        "wk": ParamSpec((d_in, d_in), ("ssm_inner", None), d_in ** -0.5),
        "wv": ParamSpec((d_in, d_in), ("ssm_inner", None), d_in ** -0.5),
        "w_if": ParamSpec((D, 2 * nh), ("fsdp", "ssm_heads"), D ** -0.5),
        "b_if": ParamSpec((2 * nh,), ("ssm_heads",), 0.0, "float32"),
        "norm": norm_schema(d_in),
        "w_down": ParamSpec((d_in, D), ("ssm_inner", "fsdp"), d_in ** -0.5),
    }


def _mlstm_qkvgates(p, x, cfg):
    d_in, nh, dh = mlstm_dims(cfg)
    # its gradient comes back as it was split (a seq split would not
    # flatten into the product's rows)
    up = SH.grad_like(x @ p["w_up"])
    z, h_in = up[..., :d_in], up[..., d_in:]
    shp = x.shape[:-1]
    q = (h_in @ p["wq"]).reshape(*shp, nh, dh) * dh ** -0.5
    k = (h_in @ p["wk"]).reshape(*shp, nh, dh) * dh ** -0.5
    v = (h_in @ p["wv"]).reshape(*shp, nh, dh)
    gates = (x @ p["w_if"]).float() + p["b_if"]
    logf = F.logsigmoid(gates[..., :nh])             # per-head forget (log)
    logi = gates[..., nh:]                           # input gate (log-space)
    return z, q, k, v, logf, logi


def mlstm_forward(p, x, cfg, rules=None):
    """Chunkwise mLSTM. x [B,S,D] -> ([B,S,D], (C [B,nh,dh,dh], n [B,nh,dh]))."""
    B, S, D = x.shape
    d_in, nh, dh = mlstm_dims(cfg)
    Q = pick_chunk(S, cfg.xlstm.chunk)
    nc = S // Q
    z, q, k, v, logf, logi = _mlstm_qkvgates(p, x, cfg)
    if rules is not None:
        q, k, v = (constrain(t, ("batch", None, None, None), rules)
                   for t in (q, k, v))
    c = lambda t: t.reshape(B, nc, Q, *t.shape[2:]).contiguous()
    li = torch.clamp_max(c(logi), 8.0)               # bounded exp input gate
    cumf = torch.cumsum(c(logf), dim=2)              # [B,nc,Q,nh]  (<= 0)
    y, C, n = K.mlstm_chunk_scan(c(q), c(k), c(v), cumf, li)
    y = y.reshape(B, S, d_in).to(x.dtype) * F.silu(z)
    y = apply_norm(p["norm"], y)
    y = SH.grad_like(constrain(y, ("batch", None, "ssm_inner"), rules))
    return y @ p["w_down"], (C, n)


def mlstm_init_state(cfg, batch, device):
    d_in, nh, dh = mlstm_dims(cfg)
    return {"C": torch.zeros(batch, nh, dh, dh, device=device),
            "n": torch.zeros(batch, nh, dh, device=device)}


def mlstm_decode(p, x, cfg, state):
    """x [B,1,D] recurrent step -> (y [B,1,D], new state)."""
    B = x.shape[0]
    d_in, nh, dh = mlstm_dims(cfg)
    z, q, k, v, logf, logi = _mlstm_qkvgates(p, x[:, 0], cfg)
    f = torch.exp(logf)                              # [B,nh]
    i = torch.exp(torch.clamp_max(logi, 8.0))
    q, k, v = q.float(), k.float(), v.float()
    C = state["C"] * f[..., None, None] + i[..., None, None] * \
        torch.einsum("bhd,bhe->bhde", k, v)
    n = state["n"] * f[..., None] + i[..., None] * k
    y = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.einsum("bhd,bhd->bh", q, n)
    y = y / torch.clamp_min(den.abs()[..., None], 1.0)
    y = y.reshape(B, d_in).to(x.dtype) * F.silu(z)
    y = apply_norm(p["norm"], y)
    return (y @ p["w_down"])[:, None], {"C": C, "n": n}


# ------------------------------------------------------------------ sLSTM --
def slstm_schema(cfg):
    D = cfg.d_model
    nh = cfg.num_heads
    dh = D // nh
    F_ = int(D * cfg.xlstm.proj_factor_s)
    return {
        "w_gates": ParamSpec((D, 4 * D), ("fsdp", "ssm_inner"), D ** -0.5),
        "r_gates": ParamSpec((4, nh, dh, dh), (None, "ssm_heads", None, None),
                             dh ** -0.5),
        "b_gates": ParamSpec((4 * D,), ("ssm_inner",), 0.0, "float32"),
        "norm": norm_schema(D),
        "ffn_w1": ParamSpec((D, F_), ("fsdp", "ffn"), D ** -0.5),
        "ffn_w3": ParamSpec((D, F_), ("fsdp", "ffn"), D ** -0.5),
        "ffn_w2": ParamSpec((F_, D), ("ffn", "fsdp"), F_ ** -0.5),
    }


def _slstm_cell(p, xg, carry, cfg):
    """xg [B,4D] precomputed input gates; carry = (h, c, n, m) each [B,nh,dh]."""
    nh = cfg.num_heads
    dh = cfg.d_model // nh
    B = xg.shape[0]
    h, c, n, m = carry
    rec = torch.einsum("bhd,ghde->bghe", h, p["r_gates"].float())
    # whole over the gates: DTensor (torch 2.11) splits no split dim into
    # subdims narrower than the split
    xg = SH.whole_dims(xg, (1,))
    g = xg.reshape(B, 4, nh, dh).float() + rec
    zt = torch.tanh(g[:, 0])
    it = g[:, 1]                                     # log-space input gate
    ft = g[:, 2]                                     # log-space forget gate
    ot = torch.sigmoid(g[:, 3])
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(logf + m - m_new)
    c = f_p * c + i_p * zt
    n = f_p * n + i_p
    h_new = ot * c / torch.clamp_min(n, 1.0)
    return h_new, c, n, m_new


def _slstm_out(p, y, rules=None):
    """The sLSTM's norm and gated FFN; under ``rules`` its hidden is split
    on ``ffn`` alone, as ``layers.apply_mlp``'s."""
    y = apply_norm(p["norm"], y)
    cst = lambda t: constrain(t, ("batch", None, "ffn"), rules) \
        if t.ndim == 3 else t
    return (cst(F.silu(y @ p["ffn_w1"])) * cst(y @ p["ffn_w3"])) \
        @ p["ffn_w2"]


def slstm_forward(p, x, cfg, rules=None):
    """x [B,S,D] -> ([B,S,D], final (h, c, n, m)): a loop over time.
    Under ``rules`` the gates are pinned to batch-only sharding before
    the loop, as the reference pins them (one gather outside the loop,
    none per step), and the loop runs on each rank's local rows."""
    B, S, D = x.shape
    xg = (x @ p["w_gates"]).float() + p["b_gates"]
    xg = constrain(xg, ("batch", None, None), rules)
    if SH.is_dtensor(xg):
        # the loop runs on each rank's rows of the batch: its S steps
        # would each pay DTensor's dispatch on every op
        xl, pl = SH.rows_local(xg, (0,))
        hs, carry = _slstm_scan({"r_gates": SH.whole_local(p["r_gates"], pl)},
                                xl, cfg)
        mesh = xg.device_mesh
        hs = SH.from_rows(hs, mesh, pl, (B, S, cfg.num_heads,
                                         D // cfg.num_heads))
        carry = tuple(SH.from_rows(t, mesh, pl, (B,) + tuple(t.shape[1:]))
                      for t in carry)
    else:
        hs, carry = _slstm_scan(p, xg, cfg)
    y = hs.reshape(B, S, D).to(x.dtype)
    y = constrain(y, ("batch", None, None), rules)
    return _slstm_out(p, y, rules), carry


def _slstm_scan(p, xg, cfg):
    """The loop over time of xg [B,S,4D] -> (h of every step [B,S,nh,dh],
    final (h, c, n, m))."""
    B, S = xg.shape[:2]
    nh = cfg.num_heads
    dh = cfg.d_model // nh
    carry = tuple(xg.new_zeros(B, nh, dh, dtype=torch.float32)
                  for _ in range(4))
    hs = []
    for t in range(S):
        carry = _slstm_cell(p, xg[:, t], carry, cfg)
        hs.append(carry[0])
    return torch.stack(hs, 1), carry


def slstm_init_state(cfg, batch, device):
    nh, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    return {name: torch.zeros(batch, nh, dh, device=device)
            for name in ("h", "c", "n", "m")}


def slstm_decode(p, x, cfg, state):
    xg = (x[:, 0] @ p["w_gates"]).float() + p["b_gates"]
    carry = (state["h"], state["c"], state["n"], state["m"])
    h, c, n, m = _slstm_cell(p, xg, carry, cfg)
    B, D = x.shape[0], x.shape[-1]
    y = _slstm_out(p, h.reshape(B, D).to(x.dtype))
    return y[:, None], {"h": h, "c": c, "n": n, "m": m}
