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

* ``"shardmap"`` — the reference's expert-parallel layout: routing tables
  for the rank's experts only, one gather, one ``index_add_`` and one
  SUM-reduce over ``model``.  Under an activation policy whose mesh has a
  ``model`` axis (the dry-run's) capacity applies per data shard, ``C``
  from the rank's own tokens and positions counted over them, as the
  reference documents (``repro/models/moe.py``, ``_expert_compute_shardmap``);
  without one it is the one-shard path over the global microbatch, as the
  reference's Trainer, which clears the policy, runs it.

Over the ``model`` axis (:mod:`~repro_torch.models.tensor_parallel`) a
rank holds ``E / tp`` experts ``[base, base + E / tp)`` where the rules
shard them: every dispatch builds the same tables restricted to those
experts, adds its partial combine to the shared experts' part and
SUM-reduces once.  The router stays replicated (its input and the gates
feed the experts through ``copy_to_model``).  Over the batch axes
(``pod``, ``data``) the routing is the global microbatch's, as in the
reference's jitted step: ``C`` comes from the global token count, and an
assignment's k-major position in its expert adds, to the rank's running
count, every assignment of an earlier k on every rank and of its own k on
the ranks before it (one gather of each rank's (K, E) counts); the
Switch aux loss takes the product of the global means of f and p.

Every path keeps the reference's routing exactly:

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

from . import tensor_parallel as tp
from .act_sharding import current_mesh
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


def route(probs: torch.Tensor, K: int, C: int, *, global_order: bool = True):
    """The reference's routing tables from router probabilities (T, E):
    ``gate_vals`` (T, K) renormalised, ``idx`` (T, K), and per k-major
    assignment (K, T) its slot in its expert (``pos_sel``) and whether it
    fits (``keep_sel``); also the (T, K, E) one-hots the aux loss counts.
    ``global_order``: positions count the global microbatch over the
    installed batch axes (the rank's rows after those of the ranks before
    it, for each k); otherwise the rank's rows alone."""
    T, E = probs.shape
    gate_vals, idx = top_k(probs, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    experts = torch.arange(E, device=probs.device)
    onehot = (idx[..., None] == experts).to(torch.int32)           # (T, K, E)
    km = onehot.transpose(0, 1)                                    # (K, T, E)
    counts = km.sum(dim=1, dtype=torch.int64)                      # (K, E)
    every = tp.batch_counts(counts) if global_order else counts[None]   # (R, K, E)
    total = every.sum(dim=0)
    rank = tp.current().batch_rank if every.shape[0] > 1 else 0
    offset = torch.cumsum(total, dim=0) - total + every[:rank].sum(dim=0)
    position = torch.cumsum(km, dim=1) - 1 + offset[:, None, :]    # (K, T, E)
    pos_sel = torch.gather(position, 2, idx.T[..., None])[..., 0]
    keep_sel = pos_sel < C
    return gate_vals, idx, pos_sel, keep_sel, onehot


def _expert_ffn(p: Mapping, xin: torch.Tensor) -> torch.Tensor:
    """(E, C, d) buffers -> (E, C, d): each expert's SwiGLU."""
    dtype = xin.dtype
    e = p["experts"]
    h = torch.bmm(xin, e["wi"].to(dtype))
    g = torch.bmm(xin, e["wg"].to(dtype))
    return torch.bmm(F.silu(g) * h, e["wo"].to(dtype))


def _slot_tables(idx, gate_vals, pos_sel, keep_sel, base: int, E: int, C: int):
    """(local expert, slot) of each k-major assignment to the experts
    ``[base, base + E)``, any other (dropped, or another rank's) in the
    spare column C of local expert E - 1, and its gate (0 there)."""
    mine = keep_sel & (idx.T >= base) & (idx.T < base + E)
    e_flat = torch.where(mine, idx.T - base, E - 1).reshape(-1)
    c_flat = torch.where(mine, pos_sel, C).reshape(-1)
    gates = torch.where(mine, gate_vals.T, 0.0).reshape(-1)
    return mine, e_flat, c_flat, gates


def _expert_compute_einsum(p, xt, idx, gate_vals, pos_sel, keep_sel, C, base):
    """Dispatch and combine as (T, E, C) tables and two matmuls."""
    T, d = xt.shape
    E = p["experts"]["wi"].shape[0]
    K = idx.shape[1]
    mine, e_flat, c_flat, gates = _slot_tables(idx, gate_vals, pos_sel, keep_sel,
                                               base, E, C)
    t_flat = torch.arange(T, device=xt.device).repeat(K)
    kept = mine.reshape(-1).to(torch.float32)
    dispatch = torch.zeros((T, E, C + 1), dtype=torch.float32, device=xt.device)
    dispatch[t_flat, e_flat, c_flat] = kept
    combine = torch.zeros((T, E, C + 1), dtype=torch.float32, device=xt.device)
    combine[t_flat, e_flat, c_flat] = gates
    dispatch = dispatch[..., :C].reshape(T, E * C).to(xt.dtype)
    combine = combine[..., :C].reshape(T, E * C).to(xt.dtype)
    xin = (dispatch.T @ xt).view(E, C, d)
    out = _expert_ffn(p, xin)
    return combine @ out.reshape(E * C, d)


def _expert_compute_gather(p, xt, idx, gate_vals, pos_sel, keep_sel, C, base):
    """Dispatch by one gather of token rows (sentinel row T reads zeros),
    combine by one ``index_add_`` into (T + 1, d).  The ``"shardmap"``
    dispatch is this over its own routing."""
    T, d = xt.shape
    E = p["experts"]["wi"].shape[0]
    mine, e_flat, c_flat, gates = _slot_tables(idx, gate_vals, pos_sel, keep_sel,
                                               base, E, C)
    tok = torch.where(mine, torch.arange(T, device=xt.device), T).reshape(-1)
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


def _per_data_shard() -> bool:
    """``"shardmap"`` under a policy whose mesh has a ``model`` axis."""
    mesh = current_mesh()
    return mesh is not None and "model" in (mesh.mesh_dim_names or ())


def apply_moe(p: Mapping, x: torch.Tensor, cfg: ModelConfig, *,
              capacity: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), aux loss, an fp32 scalar).

    ``capacity`` overrides the per-expert buffer depth; decode passes
    ``capacity`` = the global batch's tokens (dropless: an expert can never
    receive more than every token), training and prefill use the
    factor-based value of the global microbatch (of the rank's rows for
    ``"shardmap"`` per data shard).
    """
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    T = B * S
    xt = x.reshape(T, d)
    logits = (xt @ p["router"].to(x.dtype)).float()                # (T, E)
    probs = torch.softmax(logits, dim=-1)
    impl = get_flags().moe_impl
    per_shard = impl == "shardmap" and _per_data_shard()
    if capacity is not None:
        C = capacity
    else:
        C = capacity_of(cfg, T if per_shard else T * tp.batch_size())
    gate_vals, idx, pos_sel, keep_sel, onehot = route(probs, K, C,
                                                      global_order=not per_shard)

    compute = _expert_compute_einsum if impl == "einsum" else _expert_compute_gather
    E_loc = p["experts"]["wi"].shape[0]
    if tp.model_size() == 1:
        y = compute(p, xt, idx, gate_vals, pos_sel, keep_sel, C, 0)
        if "shared" in p:
            y = y + apply_mlp(p["shared"], xt, "swiglu")
    else:
        # the rank's experts and shared-expert width: partial sums, one
        # reduce (experts the rules leave whole are computed whole)
        x_in = tp.copy_to_model(xt)
        if E_loc < E:
            part = compute(p, x_in, idx, tp.copy_to_model(gate_vals), pos_sel,
                           keep_sel, C, tp.model_rank() * E_loc)
        else:
            whole = compute(p, xt, idx, gate_vals, pos_sel, keep_sel, C, 0)
            part = torch.zeros_like(whole)
        if "shared" in p:
            part = part + apply_mlp(p["shared"], x_in, "swiglu", reduce=False)
        y = tp.reduce_from_model(part)
        if E_loc == E:
            y = y + whole

    # Switch load-balancing loss: E * sum_e f_e * p_e, over the global
    # microbatch's means
    f = tp.mean_over_batch(onehot.sum(dim=1).float().mean(dim=0))
    pbar = tp.mean_over_batch(probs.mean(dim=0))
    aux = E * torch.sum(f * pbar)
    return y.reshape(B, S, d), aux
