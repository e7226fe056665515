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
  (``repro_torch.launch.steps.micro_depth``).

The other fields keep the reference's defaults, and :func:`set_flags`
refuses any other value of them, so that no setting silently does nothing:
``moe_impl`` waits for the MoE layers (``ROADMAP.md`` queue 1 item 17);
``mesh_factor`` and ``bf16_collectives`` for the mesh and sharding rules
(item 18).  ``cache_update`` selects nothing: the port's decode step always
updates its caches in place.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

__all__ = ["OptFlags", "set_flags", "get_flags", "clear_flags"]


@dataclass(frozen=True)
class OptFlags:
    # MoE dispatch implementation:
    #   "einsum" — capacity one-hot einsums (baseline; O(T^2) dispatch flops)
    #   "gather" — sort/scatter token indexing (O(T*K*d); same routing rule)
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
READ = ("sharded_loss", "flash_bwd", "n_micro_override")


def set_flags(flags: OptFlags) -> None:
    """Install ``flags``; raises ``ValueError`` on a field the port does not
    read (not in :data:`READ`) set away from its default."""
    unread = [f.name for f in fields(OptFlags) if f.name not in READ
              and getattr(flags, f.name) != f.default]
    if unread:
        raise ValueError(f"OptFlags {unread} are not read by the port yet; "
                         "leave them at their defaults")
    global _FLAGS
    _FLAGS = flags


def get_flags() -> OptFlags:
    return _FLAGS


def clear_flags() -> None:
    global _FLAGS
    _FLAGS = OptFlags()
