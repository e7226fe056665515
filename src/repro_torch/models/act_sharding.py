"""Activation-sharding policy hooks.

The port of ``repro/models/act_sharding.py``.  Model code is mesh-agnostic;
launchers install a policy mapping activation *kinds* to placements (a
:class:`repro_torch.launch.sharding.NamedPlacement`: a ``DeviceMesh`` and
one DTensor placement per mesh dimension), and the model calls
:func:`constrain` at layout-critical points (the residual stream, logits).
With no policy installed, which is how every serving and training path of
the port runs, every hook is the identity.

Kinds:
* ``residual``  — (B, S, d) stream between blocks
* ``logits``    — (B, S, V)
* ``moe_ecd``   — (E, C, d) expert buffers

:func:`constrain` redistributes a DTensor to the kind's placements; a plain
tensor is a rank's local value and passes through unchanged, as does a
tensor whose rank the placements do not fit (the reference skips a mismatch
silently too).  The model computes on plain tensors, each rank on its
``model`` shards, with the collectives GSPMD would insert written out in
:mod:`~repro_torch.models.tensor_parallel`, which a launcher installs apart
from this policy.  The one thing a policy selects is the MoE's
``"shardmap"`` capacity rule: per data shard when the policy's mesh has a
``model`` axis (:func:`current_mesh`), as in the reference.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.distributed.tensor import DTensor, Shard

__all__ = ["set_policy", "clear_policy", "constrain", "policy_active", "current_mesh"]

_POLICY: dict[str, Any] = {}


def set_policy(policy: dict[str, Any]) -> None:
    """policy: kind -> NamedPlacement (or None to skip the kind)."""
    global _POLICY
    _POLICY = dict(policy)


def clear_policy() -> None:
    global _POLICY
    _POLICY = {}


def policy_active() -> bool:
    return bool(_POLICY)


def constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    sh = _POLICY.get(kind)
    if sh is None or not isinstance(x, DTensor):
        return x
    if any(isinstance(p, Shard) and p.dim >= x.ndim for p in sh.placements):
        return x
    return x.redistribute(sh.mesh, sh.placements)


def current_mesh():
    """Mesh of the installed policy (None when no policy / no mesh)."""
    for sh in _POLICY.values():
        mesh = getattr(sh, "mesh", None)
        if mesh is not None:
            return mesh
    return None
