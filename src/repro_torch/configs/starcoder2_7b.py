"""starcoder2-7b [dense] — GQA, RoPE, sliding-window 4096, bias.
[arXiv:2402.19173; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4, head_dim=128,
    d_ff=18432, vocab_size=49152, max_seq=532480,
    attention="gqa", rope_theta=1e5, qkv_bias=True, mlp_bias=True,
    sliding_window=4096,
)
