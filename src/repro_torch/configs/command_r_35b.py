"""command-r-35b [dense] — GQA, parallel attn+FFN block, no bias.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=22528, vocab_size=256000, max_seq=532480,
    attention="gqa", rope_theta=8e6, qkv_bias=False,
    parallel_block=True, logit_scale=0.0625, norm="layernorm",
)
