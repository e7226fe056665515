"""mamba2-130m — attention-free SSD (state-space duality) model.

[arXiv:2405.21060; unverified]: 24L, d_model 768, d_ff 0 (no FFN — the
Mamba block is the whole layer), vocab 50280, ssm_state 128,
expand 2 (d_inner 1536), head_dim 64 (24 SSD heads), conv width 4.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=1,          # unused: attention-free
    n_kv_heads=1,
    head_dim=1,
    d_ff=0,
    vocab_size=50_280,
    layer_pattern=("ssm",),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_expand=2,
    tie_embeddings=True,
)
