"""stablelm-1.6b — StableLM-2 1.6B.

[hf:stabilityai/stablelm-2-1_6b; unverified]: 24L, d_model 2048, 32 heads
(kv=32, i.e. MHA, head_dim 64), d_ff 5632 (SwiGLU), vocab 100352,
LayerNorm, partial rotary (25% of head_dim).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=100_352,
    mlp_type="swiglu",
    norm_type="layernorm",
    rope_fraction=0.25,
)
