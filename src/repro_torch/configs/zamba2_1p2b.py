"""zamba2-1.2b [hybrid] — Mamba2 backbone (ssm_state 64) + shared
attention+MLP block applied every 6 SSM layers (weights shared across
applications, zamba-style). [arXiv:2411.15242; hf]"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=36, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000, max_seq=532480,
    attention="gqa", rope_theta=1e4,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk=256),
    shared_every=6,
)
