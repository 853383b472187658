"""phi-3-vision-4.2b [vlm] — phi3-mini text backbone; CLIP vision frontend
is a STUB: input_specs() provides precomputed (B, 576, d_model) patch
embeddings prepended to the text sequence.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from repro_torch.models.config import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32, head_dim=96,
    d_ff=8192, vocab_size=32064, max_seq=532480,
    attention="gqa", rope_theta=1e4,
    vlm=VLMConfig(num_image_tokens=576),
)
