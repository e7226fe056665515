"""deepseek-moe-16b — fine-grained MoE with shared experts.

[arXiv:2401.06066; hf]: 28L, d_model 2048, 16 heads (kv=16, head_dim 128),
expert d_ff 1408, vocab 102400, 2 shared + 64 routed experts top-6,
first layer dense FFN (d_ff 10944).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102_400,
    mlp_type="swiglu",
    n_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    d_expert=1408,
    moe_layer_start=1,
    d_ff_dense=10944,
)
