"""Architecture configuration for all assigned model families.

The port's own copy of the reference's ``repro/models/config.py`` (it is
framework-free; the port imports nothing of the reference).  One
:class:`ModelConfig` covers dense / hybrid / MoE / SSM / VLM / enc-dec LMs.
Per-architecture instances (exact public configs) live in
``repro_torch/configs/<arch>.py``; reduced smoke variants are derived with
:meth:`ModelConfig.smoke`.  The port's LM builds only the families it has
ported (:mod:`repro_torch.models.lm`).

Beyond the reference's fields the port has DeepSeek-V2's multi-head latent
attention (``attention="mla"``, :mod:`repro_torch.models.mla`) and its YaRN
rope scaling; their defaults leave every other config as it was.  MLA is
served on one card: :func:`refuse_mla` stops the paths that do not take it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

__all__ = ["ModelConfig", "refuse_mla"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|hybrid|moe|ssm|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # layer pattern, repeated to fill n_layers: members in
    # {"attn","local","rglru","ssm"}
    layer_pattern: tuple[str, ...] = ("attn",)
    # layers preceding the scanned pattern (e.g. recurrentgemma's 38 = 2 + 12*3)
    prefix_pattern: tuple[str, ...] = ()
    window_size: int = 4096          # sliding window of "local" layers
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0       # stablelm-style partial rotary
    norm_type: str = "rmsnorm"       # rmsnorm|layernorm
    mlp_type: str = "swiglu"         # swiglu|gelu
    use_post_norm: bool = False      # gemma2 sandwich norms
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # MoE (fine-grained, DeepSeekMoE-style)
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_expert: int = 0
    moe_layer_start: int = 0         # layers < this use a dense FFN
    d_ff_dense: int = 0              # width of those dense FFN layers
    moe_capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2

    # RG-LRU (RecurrentGemma / Griffin)
    rglru_width: int = 0             # 0 -> d_model
    rglru_conv: int = 4

    # encoder-decoder
    n_enc_layers: int = 0            # >0 -> enc-dec model; n_layers = decoder

    # modality frontend stub: None | "vision" | "audio"
    frontend: str | None = None

    # compute dtype for activations and matmul weights (norm scales are fp32)
    dtype: str = "bfloat16"

    # attention kind: "gqa" (q, k, v, o over n_kv_heads groups) or "mla"
    # (DeepSeek-V2's multi-head latent attention: k and v from a joint
    # latent of kv_lora_rank, normalised and cached with one rotary key of
    # qk_rope_head_dim shared by every head; head_dim is then qk_nope +
    # qk_rope, the q and k head dim)
    attention: str = "gqa"
    kv_lora_rank: int = 0
    q_lora_rank: int | None = None   # None: q is one projection (no q LoRA)
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # YaRN rope scaling (DeepSeek-V2's "rope_scaling"); factor 1.0: none
    rope_scaling_factor: float = 1.0
    rope_original_max_position: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 1.0
    rope_mscale_all_dim: float = 0.0

    # ----------------------------------------------------------------- utils
    @property
    def pattern_len(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_prefix(self) -> int:
        return len(self.prefix_pattern) + (
            self.moe_layer_start if self.n_experts else 0
        )

    @property
    def n_groups(self) -> int:
        """Number of scan steps = layer-pattern repetitions."""
        n = self.n_layers - self.n_prefix
        assert n % self.pattern_len == 0, (
            f"{self.name}: {n} scanned layers not divisible by "
            f"pattern length {self.pattern_len}"
        )
        return n // self.pattern_len

    @property
    def n_enc_groups(self) -> int:
        return self.n_enc_layers  # encoder layers are homogeneous

    @property
    def d_inner_ssm(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner_ssm // self.ssm_head_dim

    @property
    def d_rnn(self) -> int:
        return self.rglru_width or self.d_model

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def is_subquadratic(self) -> bool:
        """Does every layer avoid unbounded-context full attention?"""
        return all(m != "attn" for m in self.layer_pattern)

    @property
    def supports_long_context(self) -> bool:
        """Eligible for the long_500k shape (see DESIGN.md §Shape-skips).

        True when the architecture bounds per-token decode state growth:
        pure SSM / hybrid recurrent models, and gemma2's alternating
        local/global design (local layers use O(window) ring caches).
        """
        return self.is_subquadratic or "local" in self.layer_pattern

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw: dict = dict(
            n_layers=2 * self.pattern_len + self.n_prefix,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads else 0,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            window_size=min(self.window_size, 16),
            dtype="float32",
        )
        if self.n_experts:
            # capacity factor 8 = dropless at smoke scale, so the
            # prefill/decode consistency check is exact (capacity-based
            # dropping is length-dependent by construction and is covered
            # separately in tests/test_moe.py).
            kw.update(n_experts=8, moe_top_k=2, d_expert=32,
                      n_shared_experts=min(self.n_shared_experts, 1),
                      d_ff_dense=128, moe_capacity_factor=8.0)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=8)
        if self.rglru_width:
            kw.update(rglru_width=64)
        if self.n_enc_layers:
            kw.update(n_enc_layers=2)
        if self.attention == "mla":
            kw.update(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                      v_head_dim=16, head_dim=24)
        return self.replace(name=self.name + "-smoke", **kw)


def refuse_mla(cfg: ModelConfig, what: str) -> None:
    """Raise where ``what`` does not take latent attention: MLA is served
    on one card (no tensor or expert split, no training step, no dry-run
    roofline)."""
    if cfg.attention == "mla":
        raise NotImplementedError(
            f"{cfg.name}: {what} does not take multi-head latent attention (MLA); "
            "MLA configs are served on one card through Server.open_batch")
