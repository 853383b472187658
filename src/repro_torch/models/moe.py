"""Top-k routed Mixture-of-Experts with capacity-based einsum dispatch.

Counterpart of ``repro/models/moe.py``: tokens are split into groups of
``group_size``; per group, each expert takes at most C tokens (one-hot
dispatch/combine einsums, no scatters), in the reference's order, and the
(token, k) pairs past an expert's capacity are dropped.  The expert
products run the grouped-matmul kernel (``kernels.moe_gmm``) on the
dispatched tokens laid out as ``[E, n·C, D]``; the reference's
``[n, E, D, C]`` layout is a sharding choice, and this is the same sum in
another order.  Shared experts (deepseek) are plain matmuls.

Two properties of the reference are kept on purpose (ROADMAP Queue 3):
the token count must be a multiple of the group, and under batched
prefill the pad tokens and the other requests of a bucket share a group,
so they compete with a request's tokens for capacity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import kernels as K
from repro_torch.models.layers import ParamSpec
from repro_torch.sharding import constrain, grad_like, replicate


def moe_schema(cfg):
    D = cfg.d_model
    m = cfg.moe
    E, F_ = m.num_experts, m.expert_d_ff
    # the reference's axis labels for its expert-sharded layout
    s = {
        "router": ParamSpec((D, E), ("norm", "experts"), D ** -0.5, "float32"),
        "w1": ParamSpec((E, D, F_), ("experts", "expert_embed", None),
                        D ** -0.5),
        "w3": ParamSpec((E, D, F_), ("experts", "expert_embed", None),
                        D ** -0.5),
        "w2": ParamSpec((E, F_, D), ("experts", None, "expert_embed"),
                        F_ ** -0.5),
    }
    if m.num_shared_experts:
        Fs = F_ * m.num_shared_experts
        s["shared_w1"] = ParamSpec((D, Fs), ("fsdp", "ffn"), D ** -0.5)
        s["shared_w3"] = ParamSpec((D, Fs), ("fsdp", "ffn"), D ** -0.5)
        s["shared_w2"] = ParamSpec((Fs, D), ("ffn", "fsdp"), Fs ** -0.5)
    return s


def _capacity(group: int, top_k: int, E: int, factor: float) -> int:
    c = int(group * top_k / E * factor)
    return max(top_k, min(group, (c + 3) // 4 * 4))


def route(p, xt, cfg):
    """xt [n,g,D] -> (gates [n,g,E], top_g [n,g,K], top_i [n,g,K]): fp32
    router, softmax, top-k renormalised.  A stable descending sort picks
    the lower expert first on ties, as ``jax.lax.top_k`` does."""
    logits = torch.einsum("ngd,de->nge", xt.float(), p["router"].float())
    gates = torch.softmax(logits, dim=-1)
    top_g, top_i = torch.sort(gates, dim=-1, descending=True, stable=True)
    K_ = cfg.moe.top_k
    top_g, top_i = top_g[..., :K_], top_i[..., :K_]
    top_g = top_g / top_g.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, top_g, top_i


def apply_moe(p, x, cfg, *, group_size: int = 0, rules=None):
    """x [B,S,D] -> (y [B,S,D], aux).  Under ``rules`` the expert
    products are pinned as the reference pins them: experts split (EP,
    16 experts or more: tokens all-to-all to their experts), or the
    dispatched rows split as the token groups are (``batch``) with the
    expert FFN split over ``expert_ffn`` (per-expert TP)."""
    B, S, D = x.shape
    m = cfg.moe
    E, K_ = m.num_experts, m.top_k
    T = B * S
    g = min(group_size or m.group_size or min(T, 4096), T)
    n = T // g
    if n * g != T:      # the reference asserts the same (moe.py:59)
        raise ValueError(f"tokens {T} not divisible by group {g}")
    # its gradient folds back into [B, S] as it was split (grad_like)
    xt = grad_like(x.reshape(n, g, D))
    gates, top_g, top_i = route(p, xt, cfg)

    C = _capacity(g, K_, E, m.capacity_factor)
    # position of each (token, k) within its expert queue
    onehot = F.one_hot(top_i, E).float()                        # [n,g,K,E]
    pos_in_e = (torch.cumsum(onehot.reshape(n, g * K_, E), 1)
                .reshape(n, g, K_, E) - onehot)
    keep = (pos_in_e < C) * onehot
    # one_hot of a position >= C is all zeros, as jax.nn.one_hot gives
    slot = (pos_in_e[..., None] == torch.arange(C, device=x.device)).float()
    dispatch = torch.einsum("ngke,ngkec->ngec", keep, slot)     # [n,g,E,C]
    combine = torch.einsum("ngke,ngk,ngkec->ngec", keep, top_g, slot)

    if p["w1"].shape[0] >= 16:  # EP: experts split, groups whole
        xe_ax = h_ax = ("experts", None, None)
    else:            # per-expert TP: groups stay dp-split, expert ffn tp
        xe_ax, h_ax = (None, "batch", None), (None, "batch", "expert_ffn")
    cst = lambda t, ax: constrain(t, ax, rules)
    xe = torch.einsum("ngec,ngd->encd", dispatch.to(x.dtype), xt)
    xe = cst(xe.reshape(E, n * C, D), xe_ax)
    h = cst(F.silu(K.moe_gmm(xe, p["w1"])) * K.moe_gmm(xe, p["w3"]), h_ax)
    ye = cst(K.moe_gmm(h, p["w2"]), xe_ax).reshape(E, n, C, D)
    # the combine sums over experts and slots: whole expert outputs (an
    # all-gather under EP), since DTensor flattens a split expert dim into
    # the product's inner dim only where it leads (the decode step, which
    # passes no rules, too)
    ye = replicate(ye)
    y = torch.einsum("encd,ngec->ngd", ye, combine.to(x.dtype))

    if "shared_w1" in p:
        hs = F.silu(xt @ p["shared_w1"]) * (xt @ p["shared_w3"])
        hs = cst(hs, (None, None, "ffn"))
        y = y + hs @ p["shared_w2"]

    # groups split on ``batch`` alone before they fold back into [B, S]:
    # a group dim split over model too would not fold into a batch that
    # the mesh cannot split as far
    y = cst(y, ("batch", None, None))
    return y.reshape(B, S, D), _load_balance_loss(gates, top_i, E)


def _load_balance_loss(gates, top_i, E):
    """Switch-style auxiliary load-balancing loss (mean over groups)."""
    me = gates.mean(1)                                           # [n,E]
    ce = F.one_hot(top_i[..., 0], E).float().mean(1)
    return E * (me * ce).sum(-1).mean()
