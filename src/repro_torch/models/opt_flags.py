"""Performance-tuning flags (the framework's §Perf knob set).

The port's copy of the reference's framework-free ``repro/models/opt_flags.py``.
The flags select between mathematically equivalent implementations, so
every flag combination must pass the same tests.  Installed globally by
launchers (``set_flags``) so model code stays signature-stable.

What the port reads today:

* ``sharded_loss`` — :meth:`repro_torch.models.lm.LM.loss_fn`'s
  vocab-shard-friendly cross-entropy;
* ``flash_bwd`` — the ``"torch"`` attention impl's flash backward
  (:func:`repro_torch.models.attention.flash_attention_chunked`), which
  recomputes the scores chunk by chunk instead of saving them;
* ``n_micro_override`` — the accumulation depth of the train launcher
  (``repro_torch.launch.steps.micro_depth``);
* ``moe_impl`` — :func:`repro_torch.models.moe.apply_moe`'s dispatch,
  ``"einsum"``, ``"gather"`` or ``"shardmap"`` (expert-parallel, with
  capacity per data shard under an activation policy whose mesh has a
  ``model`` axis, as in the reference);
* ``mesh_factor`` — the (data, model) split of the dry-run's production
  mesh (:mod:`repro_torch.launch.dryrun`), its only reader, as in the
  reference;
* ``cache_update`` — ``"stream"`` or ``"inplace"``, both what the port
  already does: the reference's ``"inplace"`` moves the decode caches from
  its layer scan's xs/ys into the scan's carry so that XLA can update them
  in place, and the port, which has no scan, always writes each layer's
  caches in place.  Both values give the same step, bit for bit.

The other field, ``bf16_collectives``, keeps the reference's default, and
:func:`set_flags` refuses any other value of it, so that no setting
silently does nothing (:data:`WAITS` says why): no code of the reference
reads it.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

__all__ = ["OptFlags", "set_flags", "get_flags", "clear_flags"]


@dataclass(frozen=True)
class OptFlags:
    # MoE dispatch implementation:
    #   "einsum" — capacity one-hot einsums (baseline; O(T^2) dispatch flops)
    #   "gather" — sort/scatter token indexing (O(T*K*d); same routing rule)
    #   "shardmap" — expert-parallel layout, capacity per data shard under a
    #                policy with a model axis
    moe_impl: str = "einsum"
    # Mesh factorization override (logical): (dp, tp) with dp*tp = chips per
    # pod.  None -> the launcher's default (16, 16).
    mesh_factor: tuple[int, int] | None = None
    # Cross-entropy: False -> rely on GSPMD propagation through
    # logsumexp/take_along_axis; True -> explicitly vocab-shard-friendly
    # formulation (local partial max/sum + tiny reductions).
    sharded_loss: bool = False
    # Keep the TP-boundary collectives in bf16 (cast back after the sum).
    bf16_collectives: bool = False
    # Flash-attention backward (custom_vjp, recomputes scores per chunk)
    # instead of autodiff-through-scan (which saves fp32 score matrices).
    flash_bwd: bool = False
    # Gradient-accumulation depth override (None -> pick_microbatches).
    # MoE working sets (capacity C, one-hot dispatch tensors) scale with
    # tokens-per-microbatch, so deeper accumulation shrinks them.
    n_micro_override: int | None = None
    # Decode KV-cache update strategy:
    #   "stream"  — caches are scan xs->ys (baseline; XLA copies the full
    #               stacked cache once per layer group per token)
    #   "inplace" — caches are scan CARRY state, updated per group with
    #               dynamic_update_index (aliasing-friendly while state)
    cache_update: str = "stream"


_FLAGS = OptFlags()


#: the fields the port reads; any other must keep its default
READ = ("sharded_loss", "flash_bwd", "n_micro_override", "moe_impl", "mesh_factor",
        "cache_update")
#: the MoE dispatches the port has
MOE_IMPLS = ("einsum", "gather", "shardmap")
#: the reference's cache update strategies, both the port's in-place writes
CACHE_UPDATES = ("stream", "inplace")
#: why each unread field must keep its default
WAITS = {
    "bf16_collectives": "no code of the reference reads it",
}


def set_flags(flags: OptFlags) -> None:
    """Install ``flags``; raises ``ValueError`` on a field the port does not
    read (not in :data:`READ`) set away from its default, on a ``moe_impl``
    outside :data:`MOE_IMPLS` and on a ``cache_update`` outside
    :data:`CACHE_UPDATES`."""
    unread = [f.name for f in fields(OptFlags) if f.name not in READ
              and getattr(flags, f.name) != f.default]
    if unread:
        why = "; ".join(f"{name}: {WAITS[name]}" for name in unread)
        raise ValueError(f"OptFlags {unread} are not read by the port; leave "
                         f"them at their defaults ({why})")
    if flags.moe_impl not in MOE_IMPLS:
        raise ValueError(f"OptFlags moe_impl {flags.moe_impl!r} is not a MoE "
                         f"dispatch; the port has {MOE_IMPLS}")
    if flags.cache_update not in CACHE_UPDATES:
        raise ValueError(f"OptFlags cache_update {flags.cache_update!r} is not a "
                         f"cache update strategy; the reference has {CACHE_UPDATES}")
    global _FLAGS
    _FLAGS = flags


def get_flags() -> OptFlags:
    return _FLAGS


def clear_flags() -> None:
    global _FLAGS
    _FLAGS = OptFlags()
