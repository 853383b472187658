"""Plain float32 reference of a Qwen2 decoder (GQA with q/k/v biases, RoPE on
the two halves of each head, SwiGLU MLP, RMSNorm, tied or separate LM head).

The weights are the tensors the benchmark made (``weights.py``), named by
their place in the port's parameter tree: ``embed`` [V, D],
``final_norm.scale``, and per layer ``stages.0.<i>.`` + ``ln1.scale``,
``attn.wq`` [D, H, hd], ``attn.wk`` / ``attn.wv`` [D, Hkv, hd], ``attn.bq``
[H, hd], ``attn.bk`` / ``attn.bv`` [Hkv, hd], ``attn.wo`` [H, hd, D],
``ln2.scale``, ``mlp.w1`` / ``mlp.w3`` [D, F], ``mlp.w2`` [F, D]; ``lm_head``
[D, V] when the embeddings are not tied."""
from __future__ import annotations

import torch

from portbench.reference.common import (causal_attention, f, fp32, rms, rope,
                                        swiglu)


def shapes(conf: dict) -> dict:
    """The sizes the benchmark's counts need, from the configuration."""
    D, H = conf["hidden_size"], conf["num_attention_heads"]
    Hkv, hd, F_ = conf["num_key_value_heads"], D // H, conf["intermediate_size"]
    L, V = conf["num_hidden_layers"], conf["vocab_size"]
    layer = D * H * hd + 2 * D * Hkv * hd + H * hd * D + 3 * D * F_
    return {"layers": L, "heads": H, "kv_heads": Hkv, "qk_dim": hd,
            "v_dim": hd, "flash_kv_heads": Hkv, "moe_layers": 0,
            "body_params": L * layer, "head_params": V * D}


def logits(w: dict, conf: dict, tokens, first: int, prefill_len: int):
    """Float32 logits [S - first, V] at positions first..S-1 of ``tokens``
    [S], from one causal pass over the whole sequence (no cache).
    ``prefill_len`` is unused: nothing in this model depends on how the
    positions were batched."""
    D, H = conf["hidden_size"], conf["num_attention_heads"]
    Hkv, hd = conf["num_key_value_heads"], D // H
    eps, theta = conf["rms_norm_eps"], float(conf["rope_theta"])
    with fp32(), torch.no_grad():
        tok = torch.as_tensor(tokens, device=w["embed"].device).long()
        pos = torch.arange(tok.shape[0], device=tok.device)
        x = f(w["embed"][tok])
        for i in range(conf["num_hidden_layers"]):
            p = f"stages.0.{i}."
            h = rms(x, w[p + "ln1.scale"], eps)
            q = torch.einsum("sd,dhk->shk", h, f(w[p + "attn.wq"])) + f(w[p + "attn.bq"])
            k = torch.einsum("sd,dhk->shk", h, f(w[p + "attn.wk"])) + f(w[p + "attn.bk"])
            v = torch.einsum("sd,dhk->shk", h, f(w[p + "attn.wv"])) + f(w[p + "attn.bv"])
            q, k = rope(q, pos, theta), rope(k, pos, theta)
            k = k.repeat_interleave(H // Hkv, dim=1)
            v = v.repeat_interleave(H // Hkv, dim=1)
            o = causal_attention(q, k, v)
            x = x + torch.einsum("shk,hkd->sd", o, f(w[p + "attn.wo"]))
            h = rms(x, w[p + "ln2.scale"], eps)
            x = x + swiglu(h, w[p + "mlp.w1"], w[p + "mlp.w3"], w[p + "mlp.w2"])
        x = rms(x[first:], w["final_norm.scale"], eps)
        head = w["embed"].T if conf["tie_word_embeddings"] else w["lm_head"]
        return x @ f(head)
