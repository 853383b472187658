"""xlstm-350m [ssm] — mLSTM blocks with sLSTM at layers {3,9,15,21};
no standalone FFN (d_ff=0; blocks carry their own projections).
[arXiv:2405.04517; unverified]"""
from repro_torch.models.config import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4, head_dim=256,
    d_ff=0, vocab_size=50304, max_seq=532480,
    attention="none", rope_theta=0.0,
    xlstm=XLSTMConfig(slstm_at=(3, 9, 15, 21), proj_factor_m=2.0,
                      proj_factor_s=1.3334, chunk=256),
)
