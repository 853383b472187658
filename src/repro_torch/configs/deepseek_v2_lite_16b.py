"""deepseek-v2-lite-16b [moe] — MLA (kv_lora 512), 64 routed top-6 +
2 shared experts, dense layer 0. [arXiv:2405.04434; hf]"""
from repro_torch.models.config import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=10944, vocab_size=102400, max_seq=163840,
    attention="mla", rope_theta=1e4,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=64, num_shared_experts=2, top_k=6,
                  expert_d_ff=1408, capacity_factor=1.25, group_size=256),
    dense_first_layer_d_ff=10944,
)
