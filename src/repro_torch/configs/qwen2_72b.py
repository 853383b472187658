"""qwen2-72b [dense] — GQA, QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152064, max_seq=532480,
    attention="gqa", rope_theta=1e6, qkv_bias=True,
)
