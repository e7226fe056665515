"""recurrentgemma-9b — Griffin-style hybrid: RG-LRU + local attention, 1:2.

[arXiv:2402.19427; unverified]: 38L, d_model 4096, 16 heads (MQA kv=1,
head_dim 256), d_ff 12288 (GeGLU), vocab 256000, window 2048,
lru_width 4096, tied embeddings.  Pattern: (rglru, rglru, local-attn)
repeated; 38 = 2 prefix recurrent layers + 12 x 3.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    layer_pattern=("rglru", "rglru", "local"),
    prefix_pattern=("rglru", "rglru"),
    window_size=2048,
    mlp_type="geglu",
    tie_embeddings=True,
    rglru_width=4096,
)
