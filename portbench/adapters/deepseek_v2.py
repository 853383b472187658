"""The port's ``ModelConfig`` for a DeepSeek-V2 configuration file."""
from __future__ import annotations

from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

EPS = 1e-5      # the port's rmsnorm takes no other eps


def port_config(conf: dict) -> ModelConfig:
    as_run = {"rms_norm_eps": EPS, "first_k_dense_replace": 1,
              "q_lora_rank": None, "scoring_func": "softmax",
              "norm_topk_prob": True, "rope_scaling": None,
              "routed_scaling_factor": 1, "moe_layer_freq": 1,
              "topk_method": "greedy"}
    off = {k: conf.get(k) for k, v in as_run.items() if conf.get(k) != v}
    if off:
        raise ValueError(f"{conf['name']}: the port does not run {off}")
    return ModelConfig(
        name=conf["name"], family="moe",
        num_layers=conf["num_hidden_layers"], d_model=conf["hidden_size"],
        num_heads=conf["num_attention_heads"],
        num_kv_heads=conf["num_key_value_heads"],
        d_ff=conf["intermediate_size"], vocab_size=conf["vocab_size"],
        max_seq=conf["max_position_embeddings"], attention="mla",
        rope_theta=float(conf["rope_theta"]),
        tie_embeddings=conf["tie_word_embeddings"],
        mla=MLAConfig(kv_lora_rank=conf["kv_lora_rank"],
                      qk_nope_head_dim=conf["qk_nope_head_dim"],
                      qk_rope_head_dim=conf["qk_rope_head_dim"],
                      v_head_dim=conf["v_head_dim"]),
        moe=MoEConfig(num_experts=conf["n_routed_experts"],
                      num_shared_experts=conf["n_shared_experts"],
                      top_k=conf["num_experts_per_tok"],
                      expert_d_ff=conf["moe_intermediate_size"],
                      capacity_factor=conf["moe_capacity_factor"],
                      group_size=conf["moe_group_size"]),
        dense_first_layer_d_ff=conf["intermediate_size"],
        dtype=conf["torch_dtype"])
