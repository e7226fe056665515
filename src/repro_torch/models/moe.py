"""Fine-grained Mixture-of-Experts layer (DeepSeekMoE / Moonlight style).

The port of ``repro/models/moe.py``: top-k routing over many small experts
(+ optional always-on shared experts) with the reference's Switch-style
capacity rule and load-balancing auxiliary loss.  The reference has no
Pallas kernel here, so this is plain PyTorch; ``OptFlags.moe_impl`` picks
the dispatch, as it does there:

* ``"einsum"`` (the default) — capacity one-hot dispatch and combine
  tables (T, E, C) and two matmuls;
* ``"gather"`` — an (E, C) table of token ids: one gather builds the expert
  buffers, one ``index_add_`` scatters the gate-weighted outputs back.

``"shardmap"`` needs the mesh, and ``set_flags`` refuses it.  Both paths
keep the reference's routing exactly:

* **top-k ties** go to the lower expert index, as ``lax.top_k`` breaks
  them: a stable sort of the negated probabilities, not ``torch.topk``,
  which promises no order;
* **k-major capacity priority**: first choices of every token claim expert
  slots before second choices; ``position`` is the running count of the
  k-major flattened one-hots, and an assignment is kept when
  ``position < C``.  ``jax.nn.one_hot`` gives zeros for a position of -1
  or >= C; the port compares against ``arange(C)``, which does the same,
  where ``F.one_hot`` would raise;
* **dropped assignments** go to a spare column C of an (E, C + 1) table,
  sliced off after (the reference's ``mode="drop"`` scatter).

A token picks distinct experts, so each (token, expert, slot) cell of the
einsum path's tables has at most one of the k terms: the port scatters
them straight into (T, E, C + 1) instead of summing k one-hot tensors of
(K·T, E, C), with the same numbers.  ``capacity`` (decode: ``T``, dropless)
is a host integer from shapes; nothing here reads the device.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import apply_mlp
from .opt_flags import get_flags

__all__ = ["apply_moe", "capacity_of", "moe_spec", "route", "top_k"]


def moe_spec(cfg: ModelConfig, dtype) -> dict:
    """The reference's ``init_moe`` tree as ``{name: (shape, dtype)}``."""
    d, E, de = cfg.d_model, cfg.n_experts, cfg.d_expert
    spec = {"router": ((d, E), dtype),
            "experts": {"wi": ((E, d, de), dtype), "wg": ((E, d, de), dtype),
                        "wo": ((E, de, d), dtype)}}
    if cfg.n_shared_experts:
        ff = cfg.n_shared_experts * de
        spec["shared"] = {"wi": ((d, ff), dtype), "wo": ((ff, d), dtype),
                          "wg": ((d, ff), dtype)}
    return spec


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (``lax.top_k``'s order)."""
    idx = torch.sort(-probs, dim=-1, stable=True).indices[..., :k]
    return torch.gather(probs, -1, idx), idx


def capacity_of(cfg: ModelConfig, n_tokens: int) -> int:
    """The factor-based expert buffer depth ``max(1, ceil(cf * T * K / E))``."""
    return max(1, math.ceil(cfg.moe_capacity_factor * n_tokens * cfg.moe_top_k
                            / cfg.n_experts))


def route(probs: torch.Tensor, K: int, C: int):
    """The reference's routing tables from router probabilities (T, E):
    ``gate_vals`` (T, K) renormalised, ``idx`` (T, K), and per k-major
    assignment (K, T) its slot in its expert (``pos_sel``) and whether it
    fits (``keep_sel``); also the (T, K, E) one-hots the aux loss counts."""
    T, E = probs.shape
    gate_vals, idx = top_k(probs, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    experts = torch.arange(E, device=probs.device)
    onehot = (idx[..., None] == experts).to(torch.int32)           # (T, K, E)
    flat = onehot.transpose(0, 1).reshape(K * T, E)                # k-major
    position = torch.cumsum(flat, dim=0) - 1                       # (K*T, E)
    idx_km = idx.T                                                 # (K, T)
    pos_sel = torch.gather(position.view(K, T, E), 2, idx_km[..., None])[..., 0]
    keep_sel = pos_sel < C
    return gate_vals, idx, pos_sel, keep_sel, onehot


def _expert_ffn(p: Mapping, xin: torch.Tensor) -> torch.Tensor:
    """(E, C, d) buffers -> (E, C, d): each expert's SwiGLU."""
    dtype = xin.dtype
    e = p["experts"]
    h = torch.bmm(xin, e["wi"].to(dtype))
    g = torch.bmm(xin, e["wg"].to(dtype))
    return torch.bmm(F.silu(g) * h, e["wo"].to(dtype))


def _slot_tables(idx, gate_vals, pos_sel, keep_sel, E: int, C: int):
    """(expert, slot) of each k-major assignment, a dropped one in the
    spare column C of expert E - 1, and its gate (0 when dropped)."""
    e_flat = torch.where(keep_sel, idx.T, E - 1).reshape(-1)
    c_flat = torch.where(keep_sel, pos_sel, C).reshape(-1)
    gates = torch.where(keep_sel, gate_vals.T, 0.0).reshape(-1)
    return e_flat, c_flat, gates


def _expert_compute_einsum(p, xt, idx, gate_vals, pos_sel, keep_sel, C):
    """Dispatch and combine as (T, E, C) tables and two matmuls."""
    T, d = xt.shape
    E = p["experts"]["wi"].shape[0]
    K = idx.shape[1]
    e_flat, c_flat, gates = _slot_tables(idx, gate_vals, pos_sel, keep_sel, E, C)
    t_flat = torch.arange(T, device=xt.device).repeat(K)
    kept = keep_sel.reshape(-1).to(torch.float32)
    dispatch = torch.zeros((T, E, C + 1), dtype=torch.float32, device=xt.device)
    dispatch[t_flat, e_flat, c_flat] = kept
    combine = torch.zeros((T, E, C + 1), dtype=torch.float32, device=xt.device)
    combine[t_flat, e_flat, c_flat] = gates
    dispatch = dispatch[..., :C].reshape(T, E * C).to(xt.dtype)
    combine = combine[..., :C].reshape(T, E * C).to(xt.dtype)
    xin = (dispatch.T @ xt).view(E, C, d)
    out = _expert_ffn(p, xin)
    return combine @ out.reshape(E * C, d)


def _expert_compute_gather(p, xt, idx, gate_vals, pos_sel, keep_sel, C):
    """Dispatch by one gather of token rows (sentinel row T reads zeros),
    combine by one ``index_add_`` into (T + 1, d)."""
    T, d = xt.shape
    E = p["experts"]["wi"].shape[0]
    e_flat, c_flat, gates = _slot_tables(idx, gate_vals, pos_sel, keep_sel, E, C)
    tok = torch.where(keep_sel, torch.arange(T, device=xt.device), T).reshape(-1)
    slot_tok = torch.full((E, C + 1), T, dtype=torch.long, device=xt.device)
    slot_tok[e_flat, c_flat] = tok
    gate_slot = torch.zeros((E, C + 1), dtype=torch.float32, device=xt.device)
    gate_slot[e_flat, c_flat] = gates
    slot_tok, gate_slot = slot_tok[:, :C], gate_slot[:, :C]
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
    out = _expert_ffn(p, xt_pad[slot_tok])                         # (E, C, d)
    weighted = out * gate_slot[..., None].to(out.dtype)
    y = out.new_zeros((T + 1, d)).index_add_(0, slot_tok.reshape(-1),
                                             weighted.reshape(E * C, d))
    return y[:T]


def apply_moe(p: Mapping, x: torch.Tensor, cfg: ModelConfig, *,
              capacity: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), aux loss, an fp32 scalar).

    ``capacity`` overrides the per-expert buffer depth; decode passes
    ``capacity = B * S`` (dropless: an expert can never receive more than
    every token), training and prefill use the factor-based value.
    """
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    T = B * S
    xt = x.reshape(T, d)
    logits = (xt @ p["router"].to(x.dtype)).float()                # (T, E)
    probs = torch.softmax(logits, dim=-1)
    C = capacity if capacity is not None else capacity_of(cfg, T)
    gate_vals, idx, pos_sel, keep_sel, onehot = route(probs, K, C)

    if get_flags().moe_impl == "gather":
        y = _expert_compute_gather(p, xt, idx, gate_vals, pos_sel, keep_sel, C)
    else:
        y = _expert_compute_einsum(p, xt, idx, gate_vals, pos_sel, keep_sel, C)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], xt, "swiglu")

    # Switch load-balancing loss: E * sum_e f_e * p_e
    f = onehot.sum(dim=1).float().mean(dim=0)
    aux = E * torch.sum(f * probs.mean(dim=0))
    return y.reshape(B, S, d), aux
