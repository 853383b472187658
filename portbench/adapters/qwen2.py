"""The port's ``ModelConfig`` for a Qwen2 configuration file."""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

EPS = 1e-5      # the port's rmsnorm takes no other eps


def port_config(conf: dict) -> ModelConfig:
    if conf["rms_norm_eps"] != EPS or conf.get("use_sliding_window"):
        raise ValueError(f"{conf['name']}: the port runs Qwen2 with "
                         f"rms_norm_eps {EPS} and no sliding window")
    D, H = conf["hidden_size"], conf["num_attention_heads"]
    return ModelConfig(
        name=conf["name"], family="dense",
        num_layers=conf["num_hidden_layers"], d_model=D, num_heads=H,
        num_kv_heads=conf["num_key_value_heads"], head_dim=D // H,
        d_ff=conf["intermediate_size"], vocab_size=conf["vocab_size"],
        max_seq=conf["max_position_embeddings"], attention="gqa",
        rope_theta=float(conf["rope_theta"]), qkv_bias=True,
        tie_embeddings=conf["tie_word_embeddings"], dtype=conf["torch_dtype"])
