"""mixtral-8x22b [moe] — GQA, 8 experts top-2, SWA (per assignment).
[arXiv:2401.04088; hf]"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=32768, max_seq=532480,
    attention="gqa", rope_theta=1e6, sliding_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=16384,
                  capacity_factor=1.25, group_size=1024),
)
