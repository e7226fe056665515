"""gemma2-9b — local+global alternating attention, logit softcaps.

[arXiv:2408.00118; hf]: 42L, d_model 3584, 16 heads (GQA kv=8, head_dim 256),
d_ff 14336 (GeGLU), vocab 256000, sliding window 4096 on odd layers,
attn softcap 50, final softcap 30, sandwich (pre+post) RMSNorm,
tied embeddings.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256_000,
    layer_pattern=("local", "attn"),
    window_size=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    mlp_type="geglu",
    use_post_norm=True,
    tie_embeddings=True,
)
