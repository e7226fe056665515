"""starcoder2-7b — GQA + RoPE code model.

[arXiv:2402.19173; hf]: 32L, d_model 4608, 36 heads (GQA kv=4, head_dim 128),
d_ff 18432 (GeLU), vocab 49152, LayerNorm, RoPE theta 1e5.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49_152,
    mlp_type="gelu",
    norm_type="layernorm",
    rope_theta=100_000.0,
)
