"""granite-3-8b — IBM Granite 3 dense decoder.

[hf:ibm-granite/granite-3.0 family; hf]: 40L, d_model 4096, 32 heads
(GQA kv=8, head_dim 128), d_ff 12800 (SwiGLU), vocab 49155, RMSNorm.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49_155,
    mlp_type="swiglu",
)
