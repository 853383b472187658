"""Plain float32 reference of a DeepSeek-V2 decoder as the configuration
states it: multi-head latent attention with no query compression, a dense
first layer, then layers of 64 routed experts (softmax router, top-k gates
renormalised) plus shared experts, RMSNorm, separate LM head.

Weights are named by their place in the port's parameter tree: ``embed``,
``lm_head`` [D, V], ``final_norm.scale``; the dense layer is ``stages.0.0.``
and MoE layer i is ``stages.1.<i>.``, each with ``ln1.scale``, ``attn.wq``
[D, H, nope + rope], ``attn.w_dkv`` [D, R + rope], ``attn.kv_norm.scale``
[R], ``attn.w_uk`` [R, H, nope], ``attn.w_uv`` [R, H, v], ``attn.wo``
[H, v, D], ``ln2.scale``; the dense layer's ``mlp.w1/w3/w2``; a MoE layer's
``moe.router`` [D, E] (float32), ``moe.w1`` / ``moe.w3`` [E, D, Fe],
``moe.w2`` [E, Fe, D] and ``moe.shared_w1/w3`` [D, Fs], ``moe.shared_w2``.

Expert capacity is part of the configuration as run (``moe_group_size``,
``moe_capacity_factor``): a prefill of ``prefill_len`` tokens is dispatched
in groups of ``min(moe_group_size, prefill_len)`` tokens, and in each group
an expert keeps only its first C (token, k) pairs in token-then-rank order.
Each token decoded after the prefill is dispatched with the other rows of
its decode batch, which the reference does not see; alone it never reaches
C (C >= top_k), so the reference drops nothing there."""
from __future__ import annotations

import torch

from portbench.reference.common import (causal_attention, f, fp32, rms, rope,
                                        swiglu)


def capacity(group: int, top_k: int, experts: int, factor: float) -> int:
    c = int(group * top_k / experts * factor)
    return max(top_k, min(group, (c + 3) // 4 * 4))


def shapes(conf: dict) -> dict:
    D, H = conf["hidden_size"], conf["num_attention_heads"]
    R, nope = conf["kv_lora_rank"], conf["qk_nope_head_dim"]
    rp, vd = conf["qk_rope_head_dim"], conf["v_head_dim"]
    L, V = conf["num_hidden_layers"], conf["vocab_size"]
    E, K = conf["n_routed_experts"], conf["num_experts_per_tok"]
    Fe, Fd = conf["moe_intermediate_size"], conf["intermediate_size"]
    n_dense = conf["first_k_dense_replace"]
    attn = D * H * (nope + rp) + D * (R + rp) + R * H * (nope + vd) + H * vd * D
    dense = attn + 3 * D * Fd
    moe = attn + (K + conf["n_shared_experts"]) * 3 * D * Fe + D * E
    return {"layers": L, "heads": H, "kv_heads": H, "qk_dim": nope + rp,
            "v_dim": vd, "flash_kv_heads": H, "moe_layers": L - n_dense,
            "experts": E, "top_k": K, "expert_ff": Fe, "hidden": D,
            "group_size": conf["moe_group_size"],
            "capacity_factor": conf["moe_capacity_factor"],
            "body_params": n_dense * dense + (L - n_dense) * moe,
            "head_params": V * D}


def _routed(w, p, h, conf, prefill_len):
    E, K = conf["n_routed_experts"], conf["num_experts_per_tok"]
    gates = torch.softmax(h @ f(w[p + "moe.router"]), -1)
    top_g, top_i = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_g, top_i = top_g[:, :K], top_i[:, :K]
    top_g = top_g / top_g.sum(-1, keepdim=True)
    keep = torch.ones_like(top_g, dtype=torch.bool)
    n = min(prefill_len, h.shape[0])
    g = min(conf["moe_group_size"], n)
    C = capacity(g, K, E, conf["moe_capacity_factor"])
    for s in range(0, n - n % g, g):
        onehot = torch.nn.functional.one_hot(top_i[s:s + g], E).reshape(g * K, E)
        seen = (torch.cumsum(onehot, 0) - onehot).reshape(g, K, E)
        keep[s:s + g] = (seen.gather(-1, top_i[s:s + g, :, None])[..., 0] < C)
    y = torch.zeros_like(h)
    for e in range(E):
        rows, slot = torch.nonzero((top_i == e) & keep, as_tuple=True)
        if rows.numel():
            out = swiglu(h[rows], w[p + "moe.w1"][e], w[p + "moe.w3"][e],
                         w[p + "moe.w2"][e])
            y.index_add_(0, rows, out * top_g[rows, slot][:, None])
    return y


def logits(w: dict, conf: dict, tokens, first: int, prefill_len: int):
    """Float32 logits [S - first, V] at positions first..S-1 of ``tokens``
    [S]: one causal pass, the first ``prefill_len`` tokens dispatched to the
    experts as the prefill dispatched them."""
    H, R = conf["num_attention_heads"], conf["kv_lora_rank"]
    nope, eps = conf["qk_nope_head_dim"], conf["rms_norm_eps"]
    theta = float(conf["rope_theta"])
    n_dense = conf["first_k_dense_replace"]
    with fp32(), torch.no_grad():
        tok = torch.as_tensor(tokens, device=w["embed"].device).long()
        S = tok.shape[0]
        pos = torch.arange(S, device=tok.device)
        x = f(w["embed"][tok])
        for i in range(conf["num_hidden_layers"]):
            p = f"stages.0.{i}." if i < n_dense else f"stages.1.{i - n_dense}."
            h = rms(x, w[p + "ln1.scale"], eps)
            q = torch.einsum("sd,dhk->shk", h, f(w[p + "attn.wq"]))
            q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, theta)], -1)
            ckr = h @ f(w[p + "attn.w_dkv"])
            c = rms(ckr[:, :R], w[p + "attn.kv_norm.scale"], eps)
            kr = rope(ckr[:, None, R:], pos, theta).expand(S, H, -1)
            k = torch.cat([torch.einsum("sr,rhk->shk", c, f(w[p + "attn.w_uk"])),
                           kr], -1)
            v = torch.einsum("sr,rhk->shk", c, f(w[p + "attn.w_uv"]))
            o = causal_attention(q, k, v)
            x = x + torch.einsum("shk,hkd->sd", o, f(w[p + "attn.wo"]))
            h = rms(x, w[p + "ln2.scale"], eps)
            if i < n_dense:
                x = x + swiglu(h, w[p + "mlp.w1"], w[p + "mlp.w3"], w[p + "mlp.w2"])
            else:
                x = x + _routed(w, p, h, conf, prefill_len) + swiglu(
                    h, w[p + "moe.shared_w1"], w[p + "moe.shared_w3"],
                    w[p + "moe.shared_w2"])
        x = rms(x[first:], w["final_norm.scale"], eps)
        return x @ f(w["lm_head"])
