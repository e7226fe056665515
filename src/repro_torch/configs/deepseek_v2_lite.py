"""deepseek-v2-lite — multi-head latent attention (MLA) and DeepSeekMoE.

[arXiv:2405.04434 §2.1; hf deepseek-ai/DeepSeek-V2-Lite config.json]: 27L,
d_model 2048, 16 heads; MLA with kv_lora_rank 512, no q LoRA, q/k head dim
128 (no rope) + 64 (rope), v head dim 128; YaRN rope (factor 40 over 4,096
original positions, beta_fast 32, beta_slow 1, mscale = mscale_all_dim =
0.707); the FFN is deepseek-moe-16b's: layer 0 dense (d_ff 10944), then 64
routed + 2 shared experts of 1408, top-6, softmax scoring; vocab 102400,
RMSNorm eps 1e-6.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=192,
    d_ff=1408,
    vocab_size=102_400,
    mlp_type="swiglu",
    n_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    d_expert=1408,
    moe_layer_start=1,
    d_ff_dense=10944,
    attention="mla",
    kv_lora_rank=512,
    q_lora_rank=None,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_scaling_factor=40.0,
    rope_original_max_position=4096,
    rope_beta_fast=32.0,
    rope_beta_slow=1.0,
    rope_mscale=0.707,
    rope_mscale_all_dim=0.707,
)
