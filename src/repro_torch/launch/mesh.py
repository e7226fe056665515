"""Device meshes over ``torch.distributed``.

The port of ``repro/launch/mesh.py``.  Meshes are built by FUNCTIONS, so
that importing this module touches no process group.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, one device per rank.

Mesh layouts (the reference's):

* single-pod:  (16, 16)      axes ("data", "model")          = 256 ranks
* multi-pod:   (2, 16, 16)   axes ("pod", "data", "model")   = 512 ranks

Axis roles: "pod" = cross-pod data parallelism, "data" = data parallelism
+ FSDP parameter sharding, "model" = tensor/expert parallelism: storage is
sharded over it by the rules, and each rank computes on its ``model``
shards (:mod:`repro_torch.models.tensor_parallel`).

:func:`world` opens a process group of one rank when none exists (gloo on
the CPU, NCCL on the card), so that one device runs the same code as many
ranks.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.compat import resolve_device

__all__ = ["full_tensor", "model_local", "make_host_mesh", "make_mesh", "make_production_mesh",
           "mesh_devices", "world"]


def mesh_devices(n: int) -> np.ndarray:
    """The first ``n`` ranks of the default process group; raises when the
    world is smaller (or no process group is open)."""
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} ranks, have {have}: start the processes with "
            "torch.distributed.init_process_group (or repro_torch.launch.mesh."
            "world for one rank) before building the mesh")
    return np.arange(n)


def _device_type(device) -> str:
    return "cuda" if resolve_device(device).type == "cuda" else "cpu"


def make_mesh(shape: tuple, axes: tuple, *, device=None) -> DeviceMesh:
    """A mesh of ``shape`` over the first ranks in row-major order (rank r
    of a (data, model) mesh sits at (r // model, r % model))."""
    ranks = mesh_devices(int(np.prod(shape))).reshape(shape)
    return DeviceMesh(_device_type(device), torch.from_numpy(ranks),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         factor: tuple[int, int] | None = None,
                         device=None) -> DeviceMesh:
    """Production mesh.  ``factor=(dp, tp)`` refactors the same 256-rank pod
    grid into another logical (data, model) split; default (16, 16)."""
    dp, tp = factor or (16, 16)
    if dp * tp != 256:
        raise ValueError(f"factor {(dp, tp)} does not cover 256 ranks")
    if multi_pod:
        return make_mesh((2, dp, tp), ("pod", "data", "model"), device=device)
    return make_mesh((dp, tp), ("data", "model"), device=device)


def make_host_mesh(data: int = 1, model: int = 1, *, device=None) -> DeviceMesh:
    """Small mesh over the process group's ranks (tests / local runs);
    ``device=None`` means the CUDA card."""
    return make_mesh((data, model), ("data", "model"), device=device)


@contextlib.contextmanager
def world(device=None):
    """Inside, a default process group exists: the caller's, or one of a
    single rank opened here (gloo for the CPU, NCCL for the card, on an
    in-memory store) and destroyed on exit."""
    if dist.is_initialized():
        yield
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None
                           else dev.index)
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1, device_id=dev)
    else:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def full_tensor(dt: DTensor) -> torch.Tensor:
    """The whole tensor behind a DTensor on every rank, gathered one mesh
    axis at a time by SUM all-reducing a zero-filled buffer into which each
    rank writes its shard: ``dist.all_reduce`` is the one collective gloo
    takes for CUDA tensors, so this runs alike on every backend.  Shards
    split as DTensor splits them (ceil-sized chunks, the last ones short)."""
    mesh = dt.device_mesh
    t = dt.to_local()
    for i, p in enumerate(dt.placements):
        n = mesh.size(i)
        if not isinstance(p, Shard) or n == 1:
            continue
        full = dt.shape[p.dim]
        chunk = -(-full // n)
        lo = min(mesh.get_local_rank(i) * chunk, full)
        shape = list(t.shape)
        shape[p.dim] = full
        buf = t.new_zeros(shape)
        buf.narrow(p.dim, lo, t.shape[p.dim]).copy_(t)
        dist.all_reduce(buf, group=mesh.get_group(i))
        t = buf
    return t


def model_local(dt: DTensor) -> torch.Tensor:
    """The rank's ``model`` shard of a DTensor, gathered over every other
    mesh axis (``redistribute`` to ``Replicate`` there): what a rank
    computes with."""
    mesh = dt.device_mesh
    keep = tuple(p if mesh.mesh_dim_names[i] == "model" or mesh.size(i) == 1
                 else Replicate() for i, p in enumerate(dt.placements))
    if keep != tuple(dt.placements):       # a shard over an axis of one rank is whole
        dt = dt.redistribute(mesh, keep)
    return dt.to_local()
