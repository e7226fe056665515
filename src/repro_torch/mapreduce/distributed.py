"""The MapReduce dataflow as one collective: map -> combine -> all_to_all.

The port of the reference's ``shard_map`` pipeline
(``repro/mapreduce/distributed.py``).  Hadoop's pull-based shuffle becomes
a single ``torch.distributed.all_to_all_single`` over a process group: each
of the N ranks (mapper shards) combines its map output into R = N dense
per-partition blocks with ``seg_combine`` (the collect/partition/combine
kernel, :func:`repro_torch.kernels.seg_combine`), the all-to-all
transposes mapper-major blocks into reducer-major blocks, and the reduce
sums the received segments.

Keys are ints in ``[0, key_space)``; partitioning is range-based
(``key // (key_space / R)``), Hadoop's TotalOrderPartitioner analogue, so
the reduced output lands key-sorted across reducers.

The collective runs on the group's own backend and the tensors' device
must match it: NCCL for CUDA tensors (the card), gloo for CPU tensors.
Nothing stands in for either: a CUDA pipeline without NCCL raises.  Only
the dry-run's fake group (torch's ``"fake"`` backend, which moves no data)
takes any device.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from repro_torch.compat import resolve_device

__all__ = ["wordcount_map", "identity_map", "mapreduce_pipeline", "make_pipeline"]

#: the collective backend each device type needs
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def wordcount_map(keys: torch.Tensor, values: torch.Tensor, *, key_space: int):
    """Torch twin of ``jobs._wordcount_map`` (4 words per record, skewed
    ids).  The reference computes the hash in uint32 with wraparound; here
    it is int64, whose product stays under 2**63 for non-negative int32
    keys, masked to the same low 31 bits: bit for bit the same words."""
    n = keys.shape[0]
    reps = 4
    base = torch.repeat_interleave(keys.to(torch.int64), reps)
    offs = torch.arange(reps, dtype=torch.int64, device=keys.device).repeat(n)
    mixed = (base * 2654435761 + offs * 40503) & 0x7FFFFFFF
    hot = (mixed % 2) == 0
    words = torch.where(hot, mixed % 64, mixed % 8192) % key_space
    return words.to(torch.int32), torch.ones(n * reps, dtype=values.dtype,
                                             device=values.device)


def identity_map(keys: torch.Tensor, values: torch.Tensor, *, key_space: int):
    return keys % key_space, values


def _combine(mkeys: torch.Tensor, mvals: torch.Tensor, key_space: int,
             use_kernel: bool) -> torch.Tensor:
    """Dense (key_space,) fp32 sums of one rank's map output."""
    if use_kernel:
        from repro_torch.kernels import seg_combine

        vals = mvals.to(torch.float32).reshape(-1, 1).contiguous()
        return seg_combine(vals, mkeys.to(torch.int32).contiguous(), key_space)[:, 0]
    return torch.zeros(key_space, dtype=torch.float32, device=mvals.device
                       ).index_add_(0, mkeys.to(torch.int64),
                                    mvals.to(torch.float32))


def _check_group(group, device: torch.device) -> tuple[int, int]:
    """(rank, world size) of ``group``, whose backend must be the one the
    tensors' device needs.  A group of torch's ``"fake"`` backend moves no
    data and takes any device: the dry-run
    (:mod:`repro_torch.launch.dryrun_mapreduce`) traces over one on meta
    tensors."""
    if dist.is_initialized() and dist.get_backend(group) == "fake":
        return dist.get_rank(group), dist.get_world_size(group)
    want = _BACKENDS.get(device.type)
    if want is None:
        raise ValueError(f"the pipeline runs on cuda or cpu, not {device}")
    if want == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("CUDA tensors need the NCCL backend, and this "
                           "PyTorch has none")
    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialised: call "
            f"init_process_group({want!r}, ...) first")
    got = dist.get_backend(group)
    if got != want:
        raise RuntimeError(
            f"{device.type} tensors need a {want!r} process group; this "
            f"group's backend is {got!r}")
    return dist.get_rank(group), dist.get_world_size(group)


def mapreduce_pipeline(
    keys: torch.Tensor,         # (n_local,) int — this rank's split
    values: torch.Tensor,       # (n_local,) f32
    *,
    map_fn,
    key_space: int,
    num_shards: int,
    group=None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """One rank's body.  Returns this reducer's dense
    ``(key_space / num_shards,)`` combined and reduced output (sums)."""
    mkeys, mvals = map_fn(keys, values, key_space=key_space)

    # collect/spill+combine: dense per-(partition, local key) sums
    block = key_space // num_shards
    dense = _combine(mkeys, mvals, key_space, use_kernel)
    blocks = dense.reshape(num_shards, block)        # mapper-major segments

    # shuffle: all_to_all == Hadoop's copy phase (Eq. 90).  Row r of
    # `blocks` goes to rank r; received rows stack back on dim 0, so
    # afterwards row m holds mapper m's segment for MY key range.
    recv = torch.empty_like(blocks)
    dist.all_to_all_single(recv, blocks, group=group)

    # reduce-side merge + reduce: segments from every mapper, same key range
    return recv.sum(dim=0)                            # (block,)


def make_pipeline(
    group=None,
    *,
    map_fn=wordcount_map,
    key_space: int = 8192,
    use_kernel: bool = True,
    device=None,
):
    """Global ``(keys, values)`` -> ``(key_space,)`` reduced sums, on every
    rank of ``group`` (``None``: the default group).

    Each rank takes its contiguous split of the global records (the
    reference's ``P(axis)`` sharding), runs :func:`mapreduce_pipeline` on
    ``device`` (``None``: the CUDA card), and the reducers' blocks are
    gathered back in rank order.  The combine runs on the ``seg_combine``
    kernel, whose wrapper takes its plain version for CPU tensors;
    ``use_kernel=False`` (the reference's ``use_pallas=False``) combines
    with ``index_add_``.
    """
    dev = resolve_device(device)
    rank, world = _check_group(group, dev)
    if key_space % world:
        raise ValueError(f"key_space {key_space} is not divisible by the "
                         f"group's {world} ranks")
    body = functools.partial(
        mapreduce_pipeline, map_fn=map_fn, key_space=key_space,
        num_shards=world, group=group, use_kernel=use_kernel)

    def run(keys, values) -> torch.Tensor:
        keys = torch.as_tensor(keys, device=dev)
        values = torch.as_tensor(values, device=dev)
        n = keys.shape[0]
        if n % world or values.shape[0] != n:
            raise ValueError(
                f"{n} records with {values.shape[0]} values do not split "
                f"evenly over {world} ranks")
        local = n // world
        sl = slice(rank * local, (rank + 1) * local)
        out = body(keys[sl], values[sl])
        if world == 1:
            return out
        parts = [torch.empty_like(out) for _ in range(world)]
        dist.all_gather(parts, out, group=group)
        return torch.cat(parts)

    return run
