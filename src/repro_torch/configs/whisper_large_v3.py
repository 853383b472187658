"""whisper-large-v3 [audio] — encoder-decoder backbone; conv frontend is a
STUB: input_specs() provides precomputed (B, 1500, 1280) frame embeddings.
Learned positions (rope disabled), LayerNorm, GELU MLP with bias.
[arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ModelConfig, EncDecConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20, head_dim=64,
    d_ff=5120, vocab_size=51866, max_seq=33792,
    attention="gqa", rope_theta=0.0, qkv_bias=True, mlp_bias=True,
    norm="layernorm", act="gelu",
    encdec=EncDecConfig(num_encoder_layers=32, encoder_seq=1500),
)
