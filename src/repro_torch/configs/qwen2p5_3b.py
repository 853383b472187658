"""qwen2.5-3b [dense] — GQA, QKV bias, tied embeddings.
[hf:Qwen/Qwen2.5-3B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2, head_dim=128,
    d_ff=11008, vocab_size=151936, max_seq=532480,
    attention="gqa", rope_theta=1e6, qkv_bias=True, tie_embeddings=True,
)
