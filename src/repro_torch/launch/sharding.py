"""Sharding rules: DP / TP / EP / FSDP placements in one rule set.

The port of ``repro/launch/sharding.py``.  Axis assignment (mesh axes from
:mod:`repro_torch.launch.mesh`):

* ``pod``   — cross-pod data parallelism only (parameters replicated across
  pods, gradients reduced over it).
* ``data``  — data parallelism for activations **and** FSDP/ZeRO-3 sharding
  of parameters and optimizer state.  For ``long_500k`` (batch 1) it is
  re-purposed as a sequence axis over the KV caches.
* ``model`` — tensor parallelism (heads / FFN hidden / vocab), expert
  parallelism (the MoE expert dim) and recurrent-width parallelism.

Rules are name+shape based, keyed on the port's parameter names (the
``nn.Module`` names, ``layers.3.attn.q``; AdamW's ``m`` and ``v`` mirror
them), so one function covers every architecture, the optimizer state and
the caches.  Each rule returns a :class:`P`: one entry per tensor dimension,
an axis name, a tuple of axis names or None (the reference's
``PartitionSpec``).  The port keeps every layer unstacked, so a rule equals
the reference's spec with the leading ``None`` of the stacked group axis
dropped.  :func:`named` turns specs into DTensor placements on a
``DeviceMesh``.

A mesh is a ``DeviceMesh`` or anything with ``axis_names`` and
``devices.shape`` (the reference's ``Mesh``): the rules read only axis
names and sizes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models.config import ModelConfig, refuse_mla

__all__ = [
    "P",
    "NamedPlacement",
    "activation_policy",
    "batch_axes",
    "cache_seq_axes",
    "input_pspecs",
    "local_shape",
    "mesh_axes",
    "model_shard",
    "named",
    "opt_pspecs",
    "output_pspecs",
    "param_pspecs",
    "placements",
]


class P(tuple):
    """A partition spec: ``P("data", None)`` shards dim 0 over ``data``.
    An empty tuple entry means no axis, as in the reference's
    ``PartitionSpec``, and is stored as None."""

    def __new__(cls, *entries):
        return super().__new__(cls, (None if e == () else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


REPL = P()


def mesh_axes(mesh) -> dict[str, int]:
    """Axis name -> size of a ``DeviceMesh``, a reference-style mesh or an
    ordered ``{axis: size}`` dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _axis_size(mesh, name: str) -> int:
    return mesh_axes(mesh).get(name, 1)


def batch_axes(B: int, mesh):
    """Longest (pod, data) prefix whose size divides the global batch."""
    axes = mesh_axes(mesh)
    for c in (("pod", "data"), ("data",), ()):
        if all(a in axes for a in c):
            size = math.prod(axes[a] for a in c)
            if size and B % size == 0:
                return c if len(c) != 1 else c[0]
    return None


# ------------------------------------------------------------------ params

def _param_rule(names: list[str], cfg: ModelConfig, mesh) -> P:
    leaf = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    model_ok = lambda n: n % _axis_size(mesh, "model") == 0    # noqa: E731
    data_ok = lambda n: n % _axis_size(mesh, "data") == 0      # noqa: E731
    d_ax = "data" if data_ok(cfg.d_model) else None

    if leaf in ("scale", "bias", "ba", "bx", "conv_b", "A_log", "D", "dt_bias"):
        return REPL
    if leaf == "embed":
        # vocab over model when divisible; otherwise FSDP the d dim
        if model_ok(cfg.vocab_size):
            return P("model", None)
        return P(None, d_ax)
    if leaf == "lm_head":
        if model_ok(cfg.vocab_size):
            return P(None, "model")
        return P(d_ax, None)
    if parent in ("attn", "self", "cross"):
        if leaf == "q":
            return P(d_ax, "model" if model_ok(cfg.n_heads) else None, None)
        if leaf in ("k", "v"):
            return P(d_ax, "model" if model_ok(cfg.n_kv_heads) else None, None)
        if leaf == "o":
            return P("model" if model_ok(cfg.n_heads) else None, None, d_ax)
    if parent in ("mlp", "shared"):
        if leaf in ("wi", "wg"):
            return P(d_ax, "model")
        if leaf == "wo":
            return P("model", d_ax)
    if leaf == "router":
        return P(None, None)
    if parent == "experts":  # (E, d, de) / (E, de, d): EP over model
        ep = "model" if model_ok(cfg.n_experts) else None
        if leaf in ("wi", "wg"):
            return P(ep, d_ax, None)
        return P(ep, None, d_ax)
    if parent == "rglru":
        r_ax = "model" if model_ok(cfg.d_rnn) else None
        if leaf in ("in_x", "in_g"):
            return P(d_ax, r_ax)
        if leaf in ("wa", "wx", "conv_w"):
            return P(None, r_ax)
        if leaf == "lam":
            return P(r_ax)
        if leaf == "out":
            return P(r_ax, d_ax)
    if parent == "ssm":
        if leaf == "in_proj":
            return P(d_ax, None)
        if leaf == "out_proj":
            return P(None, d_ax)
    return REPL


def _padded(spec: P, ndim: int) -> P:
    if spec == REPL:
        return REPL
    return P(*(list(spec) + [None] * (ndim - len(spec))))


def param_pspecs(cfg: ModelConfig, params_shape: dict, mesh) -> dict[str, P]:
    """Spec of each parameter, by name; ``params_shape`` maps the port's
    parameter names to tensors (meta tensors will do)."""
    refuse_mla(cfg, "the sharding rules (tensor and expert parallel)")
    return {name: _padded(_param_rule(name.split("."), cfg, mesh), t.ndim)
            for name, t in params_shape.items()}


def _model_dims(spec: P, shape, mesh):
    """(dim, ways) of each dimension ``spec`` puts on the ``model`` axis."""
    ways = _axis_size(mesh, "model")
    out = []
    for d, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        if "model" in names and ways > 1:
            if shape[d] % ways:
                raise ValueError(f"dimension {d} of {tuple(shape)} does not split "
                                 f"evenly over a model axis of {ways}")
            out.append((d, ways))
    return out


def local_shape(spec: P, shape, mesh) -> tuple:
    """The shape of one rank's shard over the ``model`` axis of ``mesh`` of a
    tensor of ``shape`` placed by ``spec``: what a rank computes with (the
    other axes are gathered before compute)."""
    out = list(shape)
    for d, ways in _model_dims(spec, shape, mesh):
        out[d] //= ways
    return tuple(out)


def model_shard(t, spec: P, mesh, rank: int):
    """Model rank ``rank``'s shard of the whole tensor ``t`` placed by
    ``spec`` (a view; ``t`` itself when ``spec`` leaves ``model`` out)."""
    for d, ways in _model_dims(spec, t.shape, mesh):
        n = t.shape[d] // ways
        t = t.narrow(d, rank * n, n)
    return t


def opt_pspecs(cfg: ModelConfig, opt_shape: dict, mesh) -> dict:
    """AdamW's state mirrors the parameters under ``m`` and ``v``;
    ``count`` is replicated."""
    out = {k: param_pspecs(cfg, opt_shape[k], mesh) for k in ("m", "v")}
    out["count"] = REPL
    return out


# ------------------------------------------------------------------ inputs

def _cache_rule(names: list[str], leaf, cfg: ModelConfig, mesh, B: int) -> P:
    """Spec of one per-layer cache leaf (kv / recurrent state / conv tail)."""
    bax = batch_axes(B, mesh)
    axes = mesh_axes(mesh)
    name = names[-1]
    model = axes.get("model", 1)
    if name in ("k", "v"):
        # (B, KV, S, hd)
        kv_ax = "model" if cfg.n_kv_heads % model == 0 else None
        seq_axes = [] if kv_ax else ["model"]
        if bax is None and "data" in axes:
            seq_axes = ["data"] + seq_axes
        seq_ax = tuple(seq_axes) if len(seq_axes) > 1 else (seq_axes[0] if seq_axes else None)
        return P(bax, kv_ax, seq_ax, None)
    if name == "h":
        # rglru (B, r) | ssm (B, H, P, N)
        if leaf.ndim == 2:
            return P(bax, "model" if cfg.d_rnn % model == 0 else None)
        h_ax = "model" if cfg.ssm_state and cfg.n_ssm_heads % model == 0 else None
        return P(bax, h_ax, None, None)
    if name == "conv":
        ch_ax = None
        if cfg.rglru_width and cfg.d_rnn % model == 0 and leaf.shape[-1] == cfg.d_rnn:
            ch_ax = "model"
        return P(bax, None, ch_ax)
    return REPL


def cache_seq_axes(cfg: ModelConfig, mesh, B: int) -> tuple[str, ...]:
    """The mesh axes over which the rules shard a kv cache's sequence
    dimension at global batch ``B``, outermost first: ``("model",)`` where
    ``n_kv_heads % model != 0``, else (); ``_cache_rule`` puts ``"data"``
    before it only where :func:`batch_axes` is None, which it never is (it
    gives () when no batch axis divides B), as in the reference.  Every kv
    leaf of a config (self, local, cross) has the same rule."""
    entry = _cache_rule(["k"], None, cfg, mesh, B)[2]
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _map_named(fn, tree, names=()):
    """``fn(names, leaf)`` over a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, names + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, names + (str(i),))
                          for i, v in enumerate(tree))
    return fn(list(names), tree)


def input_pspecs(cfg: ModelConfig, shape: ShapeSpec, specs: dict, mesh) -> dict:
    """Spec tree matching ``configs.shapes.input_specs(cfg, shape)``."""
    B = shape.global_batch
    bax = batch_axes(B, mesh)

    def rule(names, leaf):
        top = names[0]
        if top in ("inputs", "targets", "mask", "token", "extra_embeds", "src_embeds"):
            return P(*([bax] + [None] * (leaf.ndim - 1)))
        if top == "caches":
            return _cache_rule(names, leaf, cfg, mesh, B)
        return REPL

    return _map_named(rule, specs)


def output_pspecs(cfg: ModelConfig, shape: ShapeSpec, out_shape: dict, mesh) -> dict:
    """Serve-step outputs: ``logits`` (vocab over model when divisible) and
    ``caches``."""
    B = shape.global_batch
    bax = batch_axes(B, mesh)
    model = _axis_size(mesh, "model")

    def rule(names, leaf):
        if names[0] == "logits":
            return P(bax, None, "model" if cfg.vocab_size % model == 0 else None)
        if names[0] == "caches":
            return _cache_rule(names, leaf, cfg, mesh, B)
        return REPL

    return _map_named(rule, out_shape)


# ------------------------------------------------------------- placements

@dataclass(frozen=True)
class NamedPlacement:
    """A spec on a mesh as DTensor placements (the reference's
    ``NamedSharding``)."""

    mesh: Any
    spec: P
    placements: tuple


def placements(mesh, spec: P) -> tuple:
    """One placement per mesh dimension: ``Shard(d)`` where the spec puts
    that axis on tensor dim ``d`` (an axis in a tuple entry too), else
    ``Replicate()``."""
    out = []
    for axis in mesh_axes(mesh):
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def named(mesh, spec_tree):
    """A spec tree as a tree of :class:`NamedPlacement`."""
    if isinstance(spec_tree, P):
        return NamedPlacement(mesh, spec_tree, placements(mesh, spec_tree))
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    return type(spec_tree)(named(mesh, v) for v in spec_tree)


def activation_policy(cfg: ModelConfig, shape: ShapeSpec, mesh) -> dict:
    """The activation-sharding policy a launcher installs
    (:mod:`repro_torch.models.act_sharding`): batch over the DP axes,
    vocab-sharded logits, expert-sharded MoE buffers."""
    bax = batch_axes(shape.global_batch, mesh)
    model = _axis_size(mesh, "model")
    pol = {
        "residual": P(bax, None, None),
        "logits": P(bax, None, "model" if cfg.vocab_size % model == 0 else None),
    }
    if cfg.n_experts and cfg.n_experts % model == 0:
        pol["moe_ecd"] = P("model", None, None)
        pol["moe_tokens"] = P(None, None)
    return named(mesh, pol)
