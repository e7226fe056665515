"""Weights of the port's models (:class:`~repro_torch.models.lm.LM` and
:class:`~repro_torch.models.encdec.EncDec`): seeded random initialisation,
and conversion from the reference's parameter pytree.

* :func:`init` draws every weight at the reference's scale
  (``repro/models/layers.py``, ``attention.py``, ``moe.py``, ``ssm.py``,
  ``rglru.py``, ``lm.py``, ``encdec.py``): a matmul weight is normal times
  its fan-in ``** -0.5`` (q, k, v, ``wi``, ``wg``, ``lm_head``, ``router``,
  ``in_proj``: d; ``o``: H * hd; a dense ``wo``: its layer's width,
  ``d_ff``, ``d_ff_dense`` or the shared experts' ``n_shared * d_expert``;
  the experts' ``wo``: ``d_expert``; ``wa``, ``wx``, ``out``: the RG-LRU
  width; ``out_proj``: the SSM's inner width), the embedding ``d ** -0.5``,
  ``conv_w`` times 0.1; the reference's constants elsewhere: norm scales
  and the SSM's ``D`` 1, biases, ``conv_b``, ``ba``, ``bx`` and ``A_log``
  0, ``dt_bias`` -2, ``lam`` ``log(expm1(linspace(2, 6, r)))``.  It draws
  from a ``torch.Generator`` directly on the model's device, so the
  reference's ``jax.random`` numbers are not reproduced.
* :func:`from_jax_params` takes the reference's ``lm.init`` (or
  ``encdec.init_encdec``) pytree as numpy arrays and maps every leaf
  exactly once: ``params["prefix"][i]`` becomes layer ``i`` and
  ``params["groups"][mi][..][g]`` layer ``n_prefix + g * len(pattern) +
  mi``; an enc-dec's stacked ``enc`` / ``dec`` trees become ``enc.i`` /
  ``dec.i``.

Matmul weights are stored in ``cfg.dtype`` (or ``dtype``), norm parameters
and the recurrent blocks' fp32 parameters in fp32.  The reference keeps
fp32 weights and casts them at every use, so a cast at load changes no
number.  ``param_dtype=torch.float32`` keeps fp32 master weights instead,
cast at each use: the training layout.  Each weight is drawn in fp32 and
copied into its slot one parameter at a time, so a bf16 model never holds
an fp32 copy of itself.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from .config import ModelConfig
from .encdec import EncDec
from .lm import LM
from .rglru import lam_init

__all__ = ["from_jax_params", "init", "jax_leaf_names"]


#: parameters set to a constant, by leaf name
_CONSTANT = {"scale": 1.0, "bias": 0.0, "conv_b": 0.0, "ba": 0.0, "bx": 0.0,
             "A_log": 0.0, "D": 1.0, "dt_bias": -2.0}


def _std(name: str, shape: tuple) -> float:
    """Std of a random weight: ``d ** -0.5`` for the embedding (V, d), 0.1
    for a conv, else its fan-in ``** -0.5``: the leading axis, H * hd for
    ``o`` (H, hd, d), the middle axis of an expert stack (E, in, out)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "embed":
        return shape[1] ** -0.5
    if leaf == "conv_w":
        return 0.1
    if leaf == "o":
        return (shape[0] * shape[1]) ** -0.5
    if ".experts." in name:
        return shape[1] ** -0.5
    return shape[0] ** -0.5


def _model(cfg: ModelConfig, **kw) -> nn.Module:
    return EncDec(cfg, **kw) if cfg.is_encdec else LM(cfg, **kw)


@torch.no_grad()
def init(cfg: ModelConfig, generator: torch.Generator, *, device=None,
         param_dtype: torch.dtype | None = None) -> nn.Module:
    """An :class:`LM` (an :class:`EncDec` for an enc-dec config) with seeded
    weights at the reference's scales, made on ``device`` (None: the CUDA
    card); ``generator`` lives on that device.  The draws are fp32 whatever
    ``param_dtype`` (default ``cfg.dtype``), so one seed gives a bf16
    serving model and an fp32 master copy of the same weights."""
    model = _model(cfg, device=device, param_dtype=param_dtype)
    for name, param in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _CONSTANT:
            param.fill_(_CONSTANT[leaf])
        elif leaf == "lam":
            param.copy_(lam_init(param.shape[0], device=param.device))
        else:
            w = torch.randn(param.shape, generator=generator, device=param.device,
                            dtype=torch.float32)
            param.copy_(w.mul_(_std(name, tuple(param.shape))))
    return model


def _layers(tree: Mapping, prefix: str = "") -> dict[str, Any]:
    """The leaves of a nested ``tree`` under dotted names."""
    flat: dict[str, Any] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            flat.update(_layers(value, f"{prefix}{key}."))
        else:
            flat[f"{prefix}{key}"] = value
    return flat


def jax_leaf_names(cfg: ModelConfig, params: Mapping) -> dict[str, Any]:
    """The reference's pytree flattened to the port's parameter names, with
    the group (or encoder / decoder layer) axis unstacked into layers."""
    flat: dict[str, Any] = {"embed": params["embed"]}
    if "lm_head" in params:
        flat["lm_head"] = params["lm_head"]
    norms = ("enc_norm", "final_norm") if cfg.is_encdec else ("final_norm",)
    for norm in norms:
        flat.update(_layers(params[norm], f"{norm}."))
    if cfg.is_encdec:
        trees = ("enc", "dec")
        stacks = [(lambda i, key=key: f"{key}.{i}", params[key]) for key in trees]
    else:
        trees = ("prefix", "groups")
        prefix, P = params.get("prefix") or [], cfg.pattern_len
        for i, layer in enumerate(prefix):
            flat.update(_layers(layer, f"layers.{i}."))
        stacks = [(lambda g, mi=mi: f"layers.{len(prefix) + g * P + mi}", member)
                  for mi, member in enumerate(params["groups"])]
    for layer_name, tree in stacks:
        for name, stacked in _layers(tree).items():
            for i in range(stacked.shape[0]):
                flat[f"{layer_name(i)}.{name}"] = stacked[i]
    extra = set(params) - {"embed", "lm_head", *norms, *trees}
    if extra:
        raise ValueError(f"{cfg.name}: reference leaves with no port counterpart: "
                         f"{sorted(extra)}")
    return flat


@torch.no_grad()
def from_jax_params(cfg: ModelConfig, params_np: Mapping, *, device=None,
                    dtype: torch.dtype | None = None,
                    param_dtype: torch.dtype | None = None) -> nn.Module:
    """The reference's ``lm.init`` (``encdec.init_encdec``) parameters, a
    pytree of numpy arrays, as an :class:`LM` (:class:`EncDec`) on
    ``device``: compute dtype ``dtype`` (default ``cfg.dtype``), matmul
    weights stored in ``param_dtype`` (default the compute dtype; fp32 for
    training), norm parameters and the recurrent blocks' fp32 parameters in
    fp32.  Raises unless every reference leaf fills exactly one port
    parameter of the same shape and every port parameter is filled."""
    if dtype is not None:
        cfg = cfg.replace(dtype=str(dtype).removeprefix("torch."))
    model = _model(cfg, device=device, param_dtype=param_dtype)
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
