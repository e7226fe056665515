"""moonshot-v1-16b-a3b — Moonlight-style fine-grained MoE.

[hf:moonshotai/Moonlight-16B-A3B; hf]: per the assignment: 48L,
d_model 2048, 16 heads (kv=16, head_dim 128), expert d_ff 1408,
vocab 163840, MoE 64 routed experts top-6 (no shared experts listed —
the deepseek sibling carries those).  First layer uses a dense FFN
(DeepSeek-style), remaining layers are MoE.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163_840,
    mlp_type="swiglu",
    n_experts=64,
    moe_top_k=6,
    d_expert=1408,
    moe_layer_start=1,
    d_ff_dense=11264,
)
