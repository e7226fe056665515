"""Assigned input shapes and per-(arch x shape) input specifications.

The port of ``repro/configs/shapes.py``.  The four shape cells (LM shapes
are seq_len x global_batch)::

    train_4k     seq  4 096   batch 256   training
    prefill_32k  seq 32 768   batch  32   inference
    decode_32k   seq 32 768   batch 128   decode w/ cache
    long_500k    seq 524 288  batch   1   long decode

:func:`input_specs` returns tensors on the ``meta`` device (shape and dtype,
no storage) in place of the reference's ``jax.ShapeDtypeStruct``, for every
input of that cell; the caches take the port's layout: a list of per-layer
dicts for :class:`~repro_torch.models.lm.LM` (``{"k", "v"}`` for attention,
``{"h", "conv"}`` for a recurrent layer), ``{"self", "cross", "cross_pos"}``
for :class:`~repro_torch.models.encdec.EncDec`.  The sharding rules
(:mod:`repro_torch.launch.sharding`) read them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.attention import init_kv_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import layer_kinds
from repro_torch.models.rglru import init_rglru_state
from repro_torch.models.ssm import init_ssm_state

__all__ = ["ShapeSpec", "SHAPES", "applicable", "cache_specs", "input_specs",
           "skip_reason"]

META = torch.device("meta")


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# VLM: number of patch-embedding positions inside the sequence budget.
_VLM_PATCHES = 1024
# enc-dec: target length as a fraction of the (source) sequence budget.
_ENCDEC_TGT_FRAC = 4


def skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> str | None:
    """None if the (arch x shape) cell runs; otherwise why it is skipped."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return "skip(full-attn): unbounded full-attention KV at 500k"
    return None


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    return skip_reason(cfg, shape) is None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, dtype,
                src_len: int | None = None):
    """Meta tensors in the port's cache layout: ``LM`` caches sized
    ``max_len`` (a local layer's ring ``min(max_len, window)``), or
    ``EncDec``'s self caches of ``max_len`` and cross caches of ``src_len``."""
    def kv(size):
        return init_kv_cache(batch, cfg.n_kv_heads, size, cfg.head_dim, dtype, META)

    if cfg.is_encdec:
        return {"self": [kv(max_len) for _ in range(cfg.n_layers)],
                "cross": [kv(src_len) for _ in range(cfg.n_layers)],
                "cross_pos": _meta((), torch.int32)}
    caches = []
    for kind in layer_kinds(cfg):
        mixer = "attn" if kind == "attn_dense" else kind
        if mixer == "attn":
            caches.append(kv(max_len))
        elif mixer == "local":
            caches.append(kv(min(max_len, cfg.window_size)))
        elif mixer == "rglru":
            caches.append(init_rglru_state(cfg, batch, dtype, META))
        else:
            caches.append(init_ssm_state(cfg, batch, dtype, META))
    return caches


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta tensors for every input of this cell's step function."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    act = getattr(torch, cfg.dtype)

    if cfg.is_encdec:
        T = max(S // _ENCDEC_TGT_FRAC, 16)
        if shape.kind == "train":
            return {"src_embeds": _meta((B, S, cfg.d_model), act),
                    "inputs": _meta((B, T), i32), "targets": _meta((B, T), i32)}
        if shape.kind == "prefill":
            return {"src_embeds": _meta((B, S, cfg.d_model), act),
                    "inputs": _meta((B, 256), i32)}
        return {"token": _meta((B, 1), i32),
                "caches": cache_specs(cfg, B, T, act, src_len=S),
                "pos": _meta((), i32)}

    if cfg.frontend == "vision":
        n_img = min(_VLM_PATCHES, S // 4)
        if shape.kind == "train":
            return {"extra_embeds": _meta((B, n_img, cfg.d_model), act),
                    "inputs": _meta((B, S - n_img), i32),
                    "targets": _meta((B, S - n_img), i32)}
        if shape.kind == "prefill":
            return {"extra_embeds": _meta((B, n_img, cfg.d_model), act),
                    "inputs": _meta((B, S - n_img), i32)}
    elif shape.kind == "train":
        return {"inputs": _meta((B, S), i32), "targets": _meta((B, S), i32)}
    elif shape.kind == "prefill":
        return {"inputs": _meta((B, S), i32)}
    return {"token": _meta((B, 1), i32), "caches": cache_specs(cfg, B, S, act),
            "pos": _meta((), i32)}
