"""Config helpers shared by the port's tests and launchers.

``smoke_shrink`` is a copy of the reference's (``repro.configs.common``);
the reference's ``input_specs`` builds JAX abstract values and has no
counterpart here.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


def smoke_shrink(cfg: ModelConfig, **over) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    small = dict(
        num_layers=min(cfg.num_layers, 2), d_model=64,
        num_heads=4, num_kv_heads=min(cfg.num_kv_heads, 2) or 2,
        head_dim=16, d_ff=128, vocab_size=256, max_seq=256,
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else 0,
    )
    if cfg.moe is not None:
        small["moe"] = dataclasses.replace(
            cfg.moe, num_experts=min(cfg.moe.num_experts, 4),
            top_k=min(cfg.moe.top_k, 2), expert_d_ff=64)
    if cfg.ssm is not None:
        small["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=8, head_dim=8, chunk=16)
    if cfg.xlstm is not None:
        small["num_layers"] = 6
        small["xlstm"] = dataclasses.replace(cfg.xlstm, slstm_at=(3,), chunk=16)
    if cfg.mla is not None:
        small["mla"] = dataclasses.replace(
            cfg.mla, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16)
        small["num_layers"] = 3
    if cfg.encdec is not None:
        small["encdec"] = dataclasses.replace(
            cfg.encdec, num_encoder_layers=2, encoder_seq=24)
    if cfg.vlm is not None:
        small["vlm"] = dataclasses.replace(cfg.vlm, num_image_tokens=8)
    if cfg.family == "hybrid":
        small["num_layers"] = 4
        small["shared_every"] = 2
    if cfg.dense_first_layer_d_ff:
        small["dense_first_layer_d_ff"] = 128
    small["name"] = cfg.name + "-smoke"
    small.update(over)
    return dataclasses.replace(cfg, **small)
