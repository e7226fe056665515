"""Tensor- and expert-parallel compute over the ``model`` mesh axis.

The reference has no counterpart: it jits its steps with the sharding rules'
placements (``repro/launch/sharding.py``) and GSPMD inserts a collective
wherever a weight's sharded output feeds a replicated value.  The port
computes on each rank's shards itself, Megatron-style, and this module holds
the collectives that GSPMD would insert:

* :func:`copy_to_model` — identity forward, SUM all-reduce backward: the
  input of a column-parallel projection (q/k/v, ``wi``/``wg``, the logits),
  whose gradient each rank holds a part of;
* :func:`reduce_from_model` — SUM all-reduce forward, identity backward:
  the output of a row-parallel projection (``o``, ``wo``, the RG-LRU's
  ``out``, the expert combine, the vocab-parallel embedding);
* :func:`gather_from_model` — concatenation of every rank's last dimension;
  the backward takes the rank's slice (the caller puts a
  :func:`copy_to_model` after it where what follows is not replicated);
* :func:`max_from_model` — a MAX all-reduce of a detached tensor (the
  vocab-sharded cross-entropy's logit max);
* :func:`mean_over_batch` and :func:`batch_counts` — the MoE's aux-loss
  means and capacity counts over the batch axes (``pod``, ``data``), so
  that a rank's routing sees the global microbatch, as the reference's
  jitted step does;
* :func:`merge_partials` — over the **sequence group**, the mesh axes over
  which the rules shard a kv cache's sequence (``sharding.cache_seq_axes``:
  ``model`` where ``n_kv_heads % tp != 0``): each rank attends over its
  span of the cache
  (:func:`seq_span`) and the ranks' partial softmaxes merge by one MAX and
  two SUM all-reduces of their log-sum-exps and outputs.

Every collective is a ``dist.all_reduce``: a gather writes the rank's slice
into a zero-filled buffer and SUM-reduces it, because gloo takes only
``broadcast`` and ``all_reduce`` for CUDA tensors.  One code path serves
every backend.

A launcher installs the group with :func:`set_model_group` (or the
:func:`model_group` context): the rank and size of the mesh's ``model``
axis, the batch axes' groups and the sequence group, whose axes the caller
takes from the rules.  It is kept apart from
:mod:`~repro_torch.models.act_sharding`'s policy, because the reference's
Trainer computes over ``model`` with that policy cleared.  With no group, or
a group of size 1, every function here is the identity.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

__all__ = [
    "ModelGroup",
    "batch_counts",
    "batch_size",
    "clear_model_group",
    "copy_to_model",
    "current",
    "gather_from_model",
    "kv_head_slice",
    "local_slice",
    "max_from_model",
    "mean_over_batch",
    "merge_partials",
    "model_group",
    "model_rank",
    "model_size",
    "reduce_from_model",
    "seq_on_model",
    "seq_size",
    "seq_span",
    "set_model_group",
    "shard_span",
    "sliced_replicated",
]


@dataclass(frozen=True)
class ModelGroup:
    """The ``model`` axis of a mesh as this rank sees it, and the batch
    axes over which the rows of a step are split."""

    group: Any                  # the model axis's ProcessGroup (None: size 1)
    rank: int
    size: int
    batch_groups: tuple         # ProcessGroups of the batch axes of size > 1
    batch_rank: int             # the rank's index in the global row order
    batch_size: int             # ranks over which the rows are split
    seq_axes: tuple = ()        # the axes of size > 1 a kv cache's sequence is on
    seq_group: Any = None       # their ProcessGroup (data-major over two)
    seq_ways: tuple = ()        # their sizes
    seq_coords: tuple = ()      # the rank's coordinate on each


_GROUP: ModelGroup | None = None


def _axes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _seq_group(mesh, axes: tuple):
    """The ProcessGroup of ``axes`` of ``mesh``: one axis's own group, or
    the group of the sub-mesh over two (flattened in mesh order, so its
    ranks run data-major, as DTensor splits a dimension over both)."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def set_model_group(mesh, batch_axes: tuple = (), seq_axes: tuple = ()) -> None:
    """Install the ``model`` axis of ``mesh`` (a ``DeviceMesh``), the batch
    axes ``batch_axes`` (outermost first, as the global rows are ordered)
    and the sequence axes ``seq_axes`` of the kv caches (outermost first;
    a caller takes them from ``sharding.cache_seq_axes``) for this rank."""
    global _GROUP
    sizes = _axes(mesh)
    size = sizes.get("model", 1)
    group = mesh.get_group("model") if size > 1 else None
    rank = mesh.get_local_rank("model") if size > 1 else 0
    b_groups, b_rank, b_size = [], 0, 1
    for axis in batch_axes:
        n = sizes.get(axis, 1)
        b_rank = b_rank * n + (mesh.get_local_rank(axis) if n > 1 else 0)
        b_size *= n
        if n > 1:
            b_groups.append(mesh.get_group(axis))
    seq = tuple(a for a in seq_axes if sizes.get(a, 1) > 1)
    _GROUP = ModelGroup(
        group, rank, size, tuple(b_groups), b_rank, b_size, seq,
        _seq_group(mesh, seq) if seq else None, tuple(sizes[a] for a in seq),
        tuple(mesh.get_local_rank(a) for a in seq))


def clear_model_group() -> None:
    global _GROUP
    _GROUP = None


@contextlib.contextmanager
def model_group(mesh, batch_axes: tuple = (), seq_axes: tuple = ()):
    """:func:`set_model_group` inside, the previous group restored after."""
    global _GROUP
    prev = _GROUP
    set_model_group(mesh, batch_axes, seq_axes)
    try:
        yield _GROUP
    finally:
        _GROUP = prev


def current() -> ModelGroup | None:
    return _GROUP


def model_rank() -> int:
    return _GROUP.rank if _GROUP is not None else 0


def model_size() -> int:
    return _GROUP.size if _GROUP is not None else 1


def batch_size() -> int:
    return _GROUP.batch_size if _GROUP is not None else 1


def _all_reduce(t: torch.Tensor, groups, op=dist.ReduceOp.SUM) -> torch.Tensor:
    for group in groups:
        dist.all_reduce(t, op=op, group=group)
    return t


def _active() -> bool:
    return _GROUP is not None and _GROUP.size > 1


# Each Function takes the ModelGroup of its forward, so that its backward
# reduces over the same group wherever autograd runs it.

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), (ctx.mg.group,)), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        return _all_reduce(x.clone(), (mg.group,))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg, dim):
        n = x.shape[dim]
        ctx.span, ctx.dim = (mg.rank * n, n), dim
        shape = list(x.shape)
        shape[dim] = n * mg.size
        buf = x.new_zeros(shape)
        buf.narrow(dim, *ctx.span).copy_(x)
        return _all_reduce(buf, (mg.group,))

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, *ctx.span).contiguous(), None, None


class _MeanOverBatch(torch.autograd.Function):
    """Forward: the mean over the batch ranks.  Backward: the mean of the
    incoming gradients, since the step averages every rank's loss."""

    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return _all_reduce(x.clone(), mg.batch_groups).div_(mg.batch_size)

    @staticmethod
    def backward(ctx, g):
        mg = ctx.mg
        return _all_reduce(g.clone(), mg.batch_groups).div_(mg.batch_size), None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Identity; its gradient is SUM-reduced over the model axis."""
    return _CopyToModel.apply(x, _GROUP) if _active() else x


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The SUM of every model rank's ``x``; its gradient passes through."""
    return _ReduceFromModel.apply(x, _GROUP) if _active() else x


def gather_from_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Every model rank's ``x`` concatenated on dimension ``dim``, in rank
    order; the gradient of the rank's slice is its slice of the gradient."""
    return _GatherFromModel.apply(x, _GROUP, dim) if _active() else x


def max_from_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise MAX over the model ranks of a tensor without
    gradient."""
    if not _active():
        return x
    return _all_reduce(x.detach().clone(), (_GROUP.group,), op=dist.ReduceOp.MAX)


def mean_over_batch(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the batch ranks, differentiable."""
    if _GROUP is None or _GROUP.batch_size == 1:
        return x
    return _MeanOverBatch.apply(x, _GROUP)


def batch_counts(counts: torch.Tensor) -> torch.Tensor:
    """(R, ...) : every batch rank's ``counts``, in the global row order
    (R = 1 with no batch split)."""
    if _GROUP is None or _GROUP.batch_size == 1:
        return counts[None]
    buf = counts.new_zeros((_GROUP.batch_size,) + tuple(counts.shape))
    buf[_GROUP.batch_rank] = counts
    return _all_reduce(buf, _GROUP.batch_groups)


# ------------------------------------------------------ sequence split

def shard_span(size: int, ways, coords) -> tuple[int, int]:
    """(first index, length) of a rank's chunk of a dimension of ``size``
    sharded over mesh axes of sizes ``ways`` at the rank's ``coords`` on
    them, outermost first: DTensor's ``Shard`` over each axis in turn, a
    ceil split (the last chunks may be shorter, or empty)."""
    first, n = 0, size
    for w, c in zip(ways, coords):
        chunk = -(-n // w)
        lo = min(c * chunk, n)
        first, n = first + lo, min(chunk, n - lo)
    return first, n


def seq_size() -> int:
    """The number of spans a kv cache's sequence is split into (1: whole)."""
    return math.prod(_GROUP.seq_ways) if _GROUP is not None else 1


def seq_on_model() -> bool:
    """Whether the sequence split runs over the ``model`` axis: the rules
    then keep every kv head on each rank (``n_kv_heads % tp != 0``), so a
    rank attends with every q head over its span."""
    return _GROUP is not None and "model" in _GROUP.seq_axes


def seq_span(size: int) -> tuple[int, int]:
    """(first slot, slots) of the rank's span of a kv cache of ``size``
    slots: the whole cache with no sequence split.  The split must be even,
    so that a rank's span of ``n`` slots says the cache has ``n *
    seq_size()``."""
    if seq_size() == 1:
        return 0, size
    if size % seq_size():
        raise ValueError(f"a kv cache of {size} slots does not split evenly into "
                         f"{seq_size()} spans over {_GROUP.seq_axes}")
    return shard_span(size, _GROUP.seq_ways, _GROUP.seq_coords)


def merge_partials(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """The attention over every rank's span from the rank's attention ``o``
    (..., hd) over its span and its rows' log-sum-exps ``lse`` (...), in
    fp32: with M the MAX of ``lse`` over the sequence group and w = exp(lse
    - M), the SUM of w o over the SUM of w.  A rank whose span sees no slot
    has lse = -inf and weighs nothing.  Returns ``o``'s dtype; the identity
    with no sequence split."""
    if seq_size() == 1:
        return o
    groups = (_GROUP.seq_group,)
    lse = lse.float()
    w = torch.exp(lse - _all_reduce(lse.clone(), groups, op=dist.ReduceOp.MAX))
    num = _all_reduce(o.float() * w[..., None], groups)
    return (num / _all_reduce(w, groups)[..., None]).to(o.dtype)


# ------------------------------------------------------------ head layout

def kv_head_slice(n_heads_local: int, n_kv_local: int, n_heads: int,
                  n_kv: int) -> tuple[int, int] | None:
    """Which of the kv heads a rank holds its q heads read: None when the
    attention is not split over the model axis (no group, or q replicated);
    else ``(lo, hi)`` into the k/v weights the rank holds.  Where the rules
    shard both, that is every local kv head; where they shard q but
    replicate k and v (``n_kv % tp != 0``), the rank slices the kv heads of
    its q heads, which must form whole groups of equal size."""
    if not _active() or n_heads_local == n_heads:
        return None
    if n_kv_local < n_kv:
        return 0, n_kv_local
    group = n_heads // n_kv
    lo = model_rank() * n_heads_local
    kv_lo, kv_hi = lo // group, (lo + n_heads_local - 1) // group + 1
    if n_heads_local % group and group % n_heads_local:
        raise ValueError(
            f"{n_heads_local} q heads a rank over {n_kv} kv heads in groups of "
            f"{group}: a rank's q heads do not form equal groups of its kv heads")
    return kv_lo, kv_hi


def sliced_replicated(cfg, name: str, size: int) -> bool:
    """Whether the parameter ``name`` is one the rules replicate over a
    model axis of ``size`` while a rank computes with a slice of it: its
    gradient is then a part on each rank, to be SUM-reduced over the axis.
    These are k and v where q is sharded and k/v are not, and the RG-LRU's
    biases when its width is sharded."""
    if size <= 1:
        return False
    parts = name.split(".")
    leaf, parent = parts[-1], parts[-2] if len(parts) > 1 else ""
    if parent in ("attn", "self", "cross") and leaf in ("k", "v"):
        return cfg.n_heads % size == 0 and cfg.n_kv_heads % size != 0
    if parent == "rglru" and leaf in ("ba", "bx", "conv_b"):
        return cfg.d_rnn % size == 0
    return False


def local_slice(n_local: int, n: int) -> slice:
    """The rank's range of a dimension of ``n`` split into ``n_local`` a
    rank (the whole dimension when ``n_local == n``)."""
    if n_local == n:
        return slice(0, n)
    base = model_rank() * n_local
    return slice(base, base + n_local)
