"""internvl2-26b — InternViT frontend (STUB) + InternLM2-20B backbone.

[arXiv:2404.16821; hf]: backbone 48L, d_model 6144, 48 heads (GQA kv=8,
head_dim 128), d_ff 16384 (SwiGLU), vocab 92553, RoPE theta 1e6.
The ViT frontend is a stub per task spec: ``input_specs()`` provides
precomputed patch embeddings projected to d_model.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92_553,
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
    frontend="vision",
)
