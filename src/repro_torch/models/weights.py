"""Weights of the port's :class:`~repro_torch.models.lm.LM`: seeded random
initialisation, and conversion from the reference's parameter pytree.

* :func:`init` draws every weight at the reference's scale
  (``repro/models/layers.py``, ``attention.py``, ``lm.py``): normal times
  ``d**-0.5`` for the embedding, q, k, v, ``wi``, ``wg`` and ``lm_head``,
  ``(H * hd)**-0.5`` for ``o``, ``d_ff**-0.5`` for ``wo``; norm scales 1 and
  biases 0.  It draws from a ``torch.Generator`` directly on the model's
  device, so the reference's ``jax.random`` numbers are not reproduced.
* :func:`from_jax_params` takes the reference's ``lm.init`` pytree as numpy
  arrays and maps every leaf exactly once: ``params["groups"][mi][name][leaf]
  [g]`` becomes layer ``g * len(pattern) + mi``.

Matmul weights are stored in ``cfg.dtype`` (or ``dtype``), norm scales and
biases in fp32.  The reference keeps fp32 weights and casts them at every
use, so a cast at load changes no number.  ``param_dtype=torch.float32``
keeps fp32 master weights instead, cast at each use: the training layout.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .config import ModelConfig
from .lm import LM

__all__ = ["from_jax_params", "init", "jax_leaf_names"]


def _scale(cfg: ModelConfig, name: str) -> float | None:
    """Std of a weight by its parameter name; None for norm parameters."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("scale", "bias"):
        return None
    if leaf == "o":
        return (cfg.n_heads * cfg.head_dim) ** -0.5
    if leaf == "wo":
        return cfg.d_ff ** -0.5
    return cfg.d_model ** -0.5          # embed, lm_head, q, k, v, wi, wg


@torch.no_grad()
def init(cfg: ModelConfig, generator: torch.Generator, *, device=None,
         param_dtype: torch.dtype | None = None) -> LM:
    """An :class:`LM` with seeded weights at the reference's scales, made on
    ``device`` (None: the CUDA card); ``generator`` lives on that device.
    The draws are fp32 whatever ``param_dtype`` (default ``cfg.dtype``), so
    one seed gives a bf16 serving model and an fp32 master copy of the same
    weights."""
    model = LM(cfg, device=device, param_dtype=param_dtype)
    for name, param in model.named_parameters():
        std = _scale(cfg, name)
        if std is None:
            param.fill_(0.0 if name.endswith("bias") else 1.0)
            continue
        w = torch.randn(param.shape, generator=generator, device=param.device,
                        dtype=torch.float32)
        param.copy_(w.mul_(std))
    return model


def jax_leaf_names(cfg: ModelConfig, params: Mapping) -> dict[str, Any]:
    """The reference's pytree flattened to the port's parameter names, with
    the group axis unstacked into layers."""
    if params.get("prefix"):
        raise NotImplementedError(
            f"{cfg.name}: prefix layers are not ported yet (ROADMAP.md queue 1 item 17)")
    flat: dict[str, Any] = {"embed": params["embed"]}
    for leaf, arr in params["final_norm"].items():
        flat[f"final_norm.{leaf}"] = arr
    if "lm_head" in params:
        flat["lm_head"] = params["lm_head"]
    P = cfg.pattern_len
    for mi, member in enumerate(params["groups"]):
        for block, leaves in member.items():
            for leaf, stacked in leaves.items():
                for g in range(stacked.shape[0]):
                    flat[f"layers.{g * P + mi}.{block}.{leaf}"] = stacked[g]
    extra = set(params) - {"embed", "final_norm", "lm_head", "groups", "prefix"}
    if extra:
        raise ValueError(f"{cfg.name}: reference leaves with no port counterpart: "
                         f"{sorted(extra)}")
    return flat


@torch.no_grad()
def from_jax_params(cfg: ModelConfig, params_np: Mapping, *, device=None,
                    dtype: torch.dtype | None = None,
                    param_dtype: torch.dtype | None = None) -> LM:
    """The reference's ``lm.init`` parameters (a pytree of numpy arrays) as
    an :class:`LM` on ``device``: compute dtype ``dtype`` (default
    ``cfg.dtype``), matmul weights stored in ``param_dtype`` (default the
    compute dtype; fp32 for training), norm parameters (LayerNorm's
    ``scale`` and ``bias``) in fp32.  Raises unless every reference leaf
    fills exactly one port parameter of the same shape and every port
    parameter is filled."""
    if dtype is not None:
        cfg = cfg.replace(dtype=str(dtype).removeprefix("torch."))
    model = LM(cfg, device=device, param_dtype=param_dtype)
    flat = jax_leaf_names(cfg, params_np)
    params = dict(model.named_parameters())
    extra, missing = set(flat) - set(params), set(params) - set(flat)
    if extra:
        raise ValueError(f"{cfg.name}: reference leaves without a port "
                         f"parameter: {sorted(extra)}")
    if missing:
        raise ValueError(f"{cfg.name}: port parameters without a reference "
                         f"leaf: {sorted(missing)}")
    for name, param in params.items():
        arr = np.asarray(flat[name])
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{name}: reference shape {arr.shape}, port "
                             f"{tuple(param.shape)}")
        param.copy_(torch.from_numpy(np.array(arr, np.float32)))
    return model
