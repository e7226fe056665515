"""A latent-attention (MLA) configuration as the benchmark runs it: the
configuration file's keys (the source's own, DeepSeek-V2's ``config.json``)
read as the benchmark's flat keys, the program's configuration, and the
seeded weights of an MLA model, handed to both sides.

:func:`layout` is :func:`perfbench.weights.layout` with each layer's q, k,
v, o replaced by MLA's leaves: ``attn.q`` (d, H, dn + dr), ``attn.kv_a``
(d, R + dr), ``attn.kv_norm.scale`` (R,), ``attn.kv_b`` (R, H, dn + dv) and
``attn.o`` (H, dv, d); a matmul weight is normal times its fan-in ** -0.5
(``o`` H * dv), the latent norm's scale 1 + ``NORM_STD`` * N(0, 1) like
every norm's.  :func:`make` draws them as :func:`perfbench.weights.make`
draws its layout, from the same streams of the seed.
"""

from __future__ import annotations

import math

import torch

from perfbench import port, weights
from perfbench.weights import CHUNK, NORM_STD, sub_seed, tokens

__all__ = ["flat", "layout", "make", "port_config", "tokens"]

#: the benchmark's flat key for each key of the source's config
SOURCE_KEYS = {
    "num_hidden_layers": "n_layers", "hidden_size": "d_model",
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
    "vocab_size": "vocab_size", "rms_norm_eps": "norm_eps", "rope_theta": "rope_theta",
    "intermediate_size": "d_ff_dense", "moe_intermediate_size": "d_expert",
    "n_routed_experts": "n_experts", "n_shared_experts": "n_shared_experts",
    "num_experts_per_tok": "moe_top_k", "first_k_dense_replace": "moe_layer_start",
    "kv_lora_rank": "kv_lora_rank", "q_lora_rank": "q_lora_rank",
    "qk_nope_head_dim": "qk_nope_head_dim", "qk_rope_head_dim": "qk_rope_head_dim",
    "v_head_dim": "v_head_dim",
}

#: the YaRN group's keys
YARN_KEYS = {"factor": "rope_scaling_factor",
             "original_max_position_embeddings": "rope_original_max_position",
             "beta_fast": "rope_beta_fast", "beta_slow": "rope_beta_slow",
             "mscale": "rope_mscale", "mscale_all_dim": "rope_mscale_all_dim"}

#: keys of the source whose value is the only one the program (and the
#: reference) computes; a file stating another is refused
FIXED = {"hidden_act": "silu", "attention_bias": False, "tie_word_embeddings": False,
         "scoring_func": "softmax", "topk_method": "greedy", "n_group": 1,
         "topk_group": 1, "moe_layer_freq": 1, "routed_scaling_factor": 1,
         "norm_topk_prob": True}

#: the benchmark's keys taken as they are
OWN_KEYS = ("dtype", "moe_capacity_factor")


def flat(config: dict) -> dict:
    """The configuration file in the benchmark's flat keys (those
    :mod:`perfbench.weights`, :mod:`perfbench.reference.lm` and
    :mod:`perfbench.reference.mla` read).  Raises where the file states a
    value the program does not compute."""
    for key, want in FIXED.items():
        if config[key] != want:
            raise ValueError(f"{config['arch']}: {key} {config[key]!r}; the program and "
                             f"the reference compute {want!r} only")
    out = {SOURCE_KEYS[k]: v for k, v in config.items() if k in SOURCE_KEYS}
    out.update({YARN_KEYS[k]: v for k, v in config["rope_scaling"].items()
                if k in YARN_KEYS})
    out.update({k: config[k] for k in OWN_KEYS})
    out.update(d_ff=out["d_expert"], head_dim=out["qk_nope_head_dim"]
               + out["qk_rope_head_dim"], mlp_type="swiglu", norm_type="rmsnorm",
               rope_fraction=1.0, tie_embeddings=False)
    return out


def port_config(config: dict):
    """The program's ``ModelConfig``: its registered ``arch`` with every field
    of :func:`flat` set, as :func:`perfbench.port.port_config` sets a
    file's."""
    return port.port_config({"arch": config["arch"], **flat(config)})


def layout(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """``(name, shape, kind, value)`` of every parameter of the flat config
    ``cfg``, as :func:`perfbench.weights.layout` gives them."""
    d, H, R = cfg["d_model"], cfg["n_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    out = []
    for name, shape, kind, value in weights.layout(cfg):
        if ".attn." not in name:
            out.append((name, shape, kind, value))
        elif name.endswith(".attn.q"):
            p = name[:-1]
            out += [(p + "q", (d, H, dn + dr), "normal", d ** -0.5),
                    (p + "kv_a", (d, R + dr), "normal", d ** -0.5),
                    (p + "kv_norm.scale", (R,), "norm", 1.0),
                    (p + "kv_b", (R, H, dn + dv), "normal", R ** -0.5),
                    (p + "o", (H, dv, d), "normal", (H * dv) ** -0.5)]
    return out


@torch.no_grad()
def make(cfg: dict, seed: int, dtype: torch.dtype, device) -> dict[str, torch.Tensor]:
    """Every parameter of the flat config ``cfg`` from ``seed``: matmul
    leaves as views of one flat ``dtype`` buffer, norm leaves of one
    float32 buffer, each drawn on ``device`` from its own stream."""
    leaves = layout(cfg)
    flats, offs = {}, {}
    for stream, kind, dt in ((0, "normal", dtype), (1, "norm", torch.float32)):
        total = sum(math.prod(s) for _, s, k, _ in leaves if k == kind)
        buf = torch.empty(total, dtype=dt, device=device)
        gen = torch.Generator(device=device).manual_seed(sub_seed(seed, stream))
        for lo in range(0, total, CHUNK):
            buf[lo:lo + CHUNK].normal_(generator=gen)
        flats[kind], offs[kind] = buf, 0
    out = {}
    for name, shape, kind, value in leaves:
        size, off = math.prod(shape), offs[kind]
        leaf = flats[kind][off:off + size].view(shape)
        out[name] = leaf.mul_(value) if kind == "normal" else leaf.mul_(NORM_STD).add_(value)
        offs[kind] = off + size
    return out
