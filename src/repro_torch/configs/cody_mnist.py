"""Paper-faithful workload: a small MLP-mixer-style MNIST classifier, the
class of workload the paper records (MNIST inference, Table 1).  Used by the
record/replay benchmarks to reproduce Fig. 7 / Tables 1-2 quantitatively.

Modeled as a tiny dense transformer over 49 patch tokens (28x28 / 4x4),
which keeps it inside the unified stage-structured model."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="cody-mnist", family="dense",
    num_layers=4, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=256, max_seq=64,
    attention="gqa", rope_theta=1e4,
)
