"""seamless-m4t-large-v2 — encoder-decoder multimodal backbone.

[arXiv:2308.11596; hf]: d_model 1024, 16 heads (kv=16, head_dim 64),
d_ff 8192, vocab 256206.  Interpreted as 24 encoder + 24 decoder layers
(the assignment's "24L enc-dec"); the audio frontend is a stub per task
spec — ``input_specs()`` provides precomputed frame embeddings.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256_206,
    mlp_type="gelu",
    norm_type="layernorm",
    tie_embeddings=True,
    frontend="audio",
)
