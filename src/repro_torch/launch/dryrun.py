"""Dry-run every (architecture x input-shape) cell against the production
meshes, on no device, and write its roofline artifact.

The port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each cell's step on 512 placeholder XLA devices and parses the HLO.  Here
one process plays rank 0 of a process group of torch's ``"fake"`` backend
(256 ranks, 512 for two pods), which accepts every collective and moves no
data, and runs the step on ``meta`` tensors, which have shapes and dtypes
and no storage:

* ``train`` cells trace the Trainer's step
  (:func:`repro_torch.runtime.train_loop.sharded_step`): parameters and
  AdamW state as DTensors placed by
  :func:`~repro_torch.launch.sharding.param_pspecs` and ``opt_pspecs``, the
  batch by ``input_pspecs``; ``prefill`` and ``decode`` cells trace
  :func:`~repro_torch.launch.steps.make_prefill_step` /
  ``make_decode_step`` after the same gather of the placed parameters, on
  the rank's batch rows (every other input axis gathered).
* FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``; bytes are
  each op's input and output bytes, counted by a dispatch mode (unfused:
  an upper bound on HBM traffic); collective bytes are every collective the
  step issues, by kind, weighted by
  :data:`repro_torch.core.roofline._WIRE_FACTOR`; memory per device is the
  argument bytes of the rank's shards and the peak of the bytes alive
  (what exists before the step, and every storage an op made until it is
  freed).  A train step starts from its arguments and the gathered module;
  a serving step copies the placed parameters into its module and then
  holds only that, so it starts from the gathered module and its other
  arguments (tokens, caches, positions), the parameters counted once, as
  the reference's XLA memory analysis counts them.  All are per device.
* A training step's microbatches are identical, so a step of ``n``
  microbatches traces two of them and weights what the range
  ``train_step.microbatch`` counts by ``n / 2``; the gather before and the
  reduction and update after are traced once, as the step runs them.
* Attention is traced through the plain path
  (``set_attention_impl("torch")``, restored after): the kernels take no
  meta tensors, and the reference's dry-run compiles its XLA attention.

Each rank traces its own module at local shapes (``weights.empty`` with
``model=(rank, size)``) under the model group
(:mod:`repro_torch.models.tensor_parallel`): tensor- and expert-parallel
compute over ``model`` as the reference's GSPMD partitions it, so the
FLOPs, bytes and memory a device are the rank's share, and the ``model``
axis's all-reduces appear in the collective census by kind and bytes.  The
parameters are gathered over the batch/FSDP axes only, the batch and the
caches keep every shard the rules give them (an SSM's state, which its
replicated compute holds whole, is gathered): a kv cache whose sequence
the rules shard (over ``model`` where ``n_kv_heads % tp != 0``, over
``data`` where the batch does not split over it) keeps the rank's span,
and the model group carries that sequence group.  Each artifact's
``tp_compute`` is ``"model"``.  Artifacts go to ``artifacts/dryrun_torch``, never to the reference's
``artifacts/dryrun``, whose tests read those.  No card is needed.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b \\
        --shape train_4k --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import math
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, SHAPES, get_config, input_specs, skip_reason
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core.roofline import (
    _WIRE_FACTOR,
    CollectiveStats,
    hw_table,
    model_flops,
    roofline_terms,
)
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_mesh, model_local
from repro_torch.launch.steps import (
    MICROBATCH_RANGE,
    make_decode_step,
    make_prefill_step,
    micro_depth,
)
from repro_torch.models import act_sharding
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.attention import get_attention_impl, set_attention_impl
from repro_torch.models.config import ModelConfig, refuse_mla
from repro_torch.models.opt_flags import OptFlags, clear_flags, set_flags
from repro_torch.models.weights import empty
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.train_loop import sharded_step

__all__ = ["OPT_PRESETS", "Census", "fake_world", "main", "run_cell"]

META = torch.device("meta")
DEFAULT_OUT = os.path.join("artifacts", "dryrun_torch")
#: the reference's artifacts, which its tests read; the port never writes there
REFERENCE_OUT = os.path.join("artifacts", "dryrun")
#: ``tp_compute`` of a cell whose compute splits over the ``model`` axis
TP_COMPUTE = "model"

# The reference's §Perf presets, every name.  A preset whose flags
# ``set_flags`` refused would come back as ``skip(...)``; the port takes
# every flag these presets set.
OPT_PRESETS: dict[str, OptFlags] = {
    "baseline": OptFlags(),
    "moe-gather": OptFlags(moe_impl="gather"),
    "dp64-tp4": OptFlags(mesh_factor=(64, 4)),
    "dp32-tp8": OptFlags(mesh_factor=(32, 8)),
    "sharded-loss": OptFlags(sharded_loss=True),
    "moe-gather+dp64": OptFlags(moe_impl="gather", mesh_factor=(64, 4)),
    "moe-gather+loss": OptFlags(moe_impl="gather", sharded_loss=True),
    "dp64+loss": OptFlags(mesh_factor=(64, 4), sharded_loss=True),
    "moe-gather+dp64+loss": OptFlags(
        moe_impl="gather", mesh_factor=(64, 4), sharded_loss=True
    ),
    "dp32+loss": OptFlags(mesh_factor=(32, 8), sharded_loss=True),
    "flash": OptFlags(flash_bwd=True),
    "moe-gather+flash": OptFlags(moe_impl="gather", flash_bwd=True),
    "micro32": OptFlags(n_micro_override=32),
    "moe-shardmap": OptFlags(moe_impl="shardmap"),
    "moe-shardmap+flash": OptFlags(moe_impl="shardmap", flash_bwd=True),
    "inplace-cache": OptFlags(cache_update="inplace"),
    "inplace-cache+moe": OptFlags(cache_update="inplace", moe_impl="shardmap"),
    "dp128+flash": OptFlags(mesh_factor=(128, 2), flash_bwd=True),
    "moe-shardmap+dp64+flash": OptFlags(
        moe_impl="shardmap", mesh_factor=(64, 4), flash_bwd=True
    ),
    "moe-shardmap+dp32+flash": OptFlags(
        moe_impl="shardmap", mesh_factor=(32, 8), flash_bwd=True
    ),
    "einsum+micro32+flash": OptFlags(n_micro_override=32, flash_bwd=True),
    "moe-gather+micro32+flash": OptFlags(
        moe_impl="gather", n_micro_override=32, flash_bwd=True
    ),
    "dp64+flash": OptFlags(mesh_factor=(64, 4), flash_bwd=True),
    "moe-gather+dp64+flash": OptFlags(
        moe_impl="gather", mesh_factor=(64, 4), flash_bwd=True
    ),
    "dp64+flash+loss": OptFlags(
        mesh_factor=(64, 4), flash_bwd=True, sharded_loss=True
    ),
}


# ------------------------------------------------------------ process group

@contextlib.contextmanager
def fake_world(world_size: int):
    """Inside, this process is rank 0 of a process group of ``world_size``
    ranks on torch's ``"fake"`` backend: every collective returns at once
    and moves nothing.  Refuses when a process group is already open;
    destroys its own on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(
            "a process group is already open; the dry-run opens its own fake "
            "group of placeholder ranks and must run outside any other")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ census

# collective op name -> the reference's HLO kind (roofline._WIRE_FACTOR)
_COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce",
    "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_base_": "all-to-all",
}
# ops that move no bytes: metadata, bookkeeping, waits on collectives
_NO_TRAFFIC = {"detach", "lift_fresh", "empty", "empty_like", "empty_strided",
               "wait_tensor", "_wrap_tensor_autograd", "device",
               "_record_function_enter_new", "_record_function_exit"}


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    if isinstance(t, DTensor):       # a rank holds its shard
        t = t._local_tensor
    return t.numel() * t.element_size()


def _group_size(args) -> int:
    """The group of a collective op: a ProcessGroup argument (``c10d``
    ops) or a group name (``_c10d_functional`` ops)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in tree_flatten(args)[0]:
        if isinstance(a, torch.ScriptObject):
            with contextlib.suppress(RuntimeError):   # a ReduceOp, say
                return dist.ProcessGroup.unbox(a).size()
        if isinstance(a, str):
            with contextlib.suppress(RuntimeError):   # a reduce op's name
                return _resolve_process_group(a).size()
    raise ValueError("a collective op without a process group")


class Census(TorchDispatchMode):
    """Per-device counts of what a traced step does, op by op.

    * ``bytes``: each op's input and output tensor bytes (views and
      bookkeeping ops move none), unfused;
    * ``coll``: a :class:`~repro_torch.core.roofline.CollectiveStats` of
      every collective over a group of more than one rank: its result bytes
      times the wire factor (reduce-scatter: times the group size);
    * ``flops``: ``FlopCounterMode``'s count, read at range boundaries;
    * ``peak_bytes``: the largest sum of bytes alive, from ``base_bytes``
      (what exists before the step) plus every storage an op made, until it
      is freed;
    * ``ops``: calls and bytes by op name.

    What runs inside a profiler range named in ``weights`` counts ``w``
    times (the microbatches a trace stands for)."""

    def __init__(self, weights: dict[str, float] | None = None, base_bytes: int = 0,
                 known=()):
        super().__init__()
        self.weights = dict(weights or {})
        self.bytes = 0.0
        self.coll = CollectiveStats()
        self.ops: dict[str, list] = {}
        self.base_bytes = base_bytes
        self.live = 0
        self.peak_new = 0
        self._known = weakref.WeakSet(t.untyped_storage() for t in known)
        self._ranges: list[str] = []
        self._weight = 1.0
        self._flop_mode = FlopCounterMode(display=False)
        self._flops = 0.0
        self._flops_at = 0.0

    @property
    def flops(self) -> float:
        return self._flops + self._weight * (self._flop_mode.get_total_flops()
                                             - self._flops_at)

    @property
    def peak_bytes(self) -> int:
        return self.base_bytes + self.peak_new

    def __enter__(self):
        self._flop_mode.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._flop_mode.__exit__(*exc)
        return out

    def _set_weight(self):
        total = self._flop_mode.get_total_flops()
        self._flops += self._weight * (total - self._flops_at)
        self._flops_at = total
        self._weight = math.prod(self.weights.get(r, 1.0) for r in self._ranges)

    def _track(self, out):
        for t in _tensors(out):
            st = t.untyped_storage()
            if st in self._known:
                continue
            self._known.add(st)
            n = st.nbytes()
            self.live += n
            self.peak_new = max(self.peak_new, self.live)
            weakref.finalize(st, self._free, n)

    def _free(self, n: int):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.__name__.split(".")[0]
        if name == "_record_function_enter_new":
            self._ranges.append(args[0])
            self._set_weight()
            return out
        if name == "_record_function_exit":
            self._ranges.pop()
            self._set_weight()
            return out
        w = self._weight
        kind = _COLLECTIVE_KINDS.get(name)
        if kind is not None:
            n = _group_size((args, kwargs))
            if n > 1:
                moved = _tensors(out) or _tensors(args[0])
                size = sum(_nbytes(t) for t in moved)
                factor = _WIRE_FACTOR.get(kind) or float(n)
                wire = size * factor * w
                self.coll.total_bytes += wire
                self.coll.by_kind[kind] = self.coll.by_kind.get(kind, 0.0) + wire
                self.coll.count += 1
        elif name not in _NO_TRAFFIC and not func.is_view:
            moved = sum(_nbytes(t) for t in _tensors((args, kwargs)) + _tensors(out))
            self.bytes += moved * w
            rec = self.ops.setdefault(str(func), [0, 0.0])
            rec[0] += w
            rec[1] += moved * w
        if not func.is_view:
            self._track(out)
        return out


# ------------------------------------------------------------------- cells

def _mesh_sizes(multi_pod: bool, factor, mesh) -> dict[str, int]:
    if mesh is not None:
        return dict(mesh)
    dp, tp = factor or (16, 16)
    if dp * tp != 256:
        raise ValueError(f"mesh_factor {(dp, tp)} does not cover a 256-chip pod")
    sizes = {"data": dp, "model": tp}
    return {"pod": 2, **sizes} if multi_pod else sizes


def _as_axes(bax) -> tuple:
    if bax is None:
        return ()
    return (bax,) if isinstance(bax, str) else tuple(bax)


def _place(t: torch.Tensor, spec) -> DTensor:
    """A meta tensor's rank-0 shard under ``spec`` (a NamedPlacement)."""
    return distribute_tensor(t, spec.mesh, spec.placements, src_data_rank=None)


def _serve_inputs(batch: dict, mesh) -> dict:
    """The serving step's inputs on this rank: every shard the rules give
    them, but an SSM's (B, H, P, N) state's ``model`` shard (its replicated
    compute holds it whole)."""
    names = mesh.mesh_dim_names

    def one(path, dt):
        if path[-1] == "h" and dt.ndim == 4:
            keep = tuple(Replicate() if names[i] == "model" else p
                         for i, p in enumerate(dt.placements))
            if keep != tuple(dt.placements):
                dt = dt.redistribute(mesh, keep)
        return dt.to_local()

    return shd._map_named(one, batch)


def _trace(cfg, shape: ShapeSpec, mesh, sizes: dict, cell: dict) -> Census:
    axes = _as_axes(shd.batch_axes(shape.global_batch, mesh))
    dp = math.prod(sizes[a] for a in axes)
    specs = input_specs(cfg, shape)
    b_sh = shd.named(mesh, shd.input_pspecs(cfg, shape, specs, mesh))
    batch = tree_map(_place, specs, b_sh)
    train = shape.kind == "train"
    size = sizes.get("model", 1)
    cell["tp_compute"] = TP_COMPUTE
    part = (0, size)                        # rank 0's place on the model axis
    p_dtype = torch.float32 if train else None
    model = empty(cfg, device=META, param_dtype=p_dtype, model=part)
    full = model if part[1] == 1 else empty(cfg, device=META, param_dtype=p_dtype)
    names = {k: p.detach() for k, p in full.named_parameters()}
    p_sh = shd.named(mesh, shd.param_pspecs(cfg, names, mesh))
    params = {k: _place(t, p_sh[k]) for k, t in names.items()}
    args = [*params.values(), *_tensors(batch)]
    if train:
        o_sh = shd.named(mesh, shd.opt_pspecs(cfg, {"m": names, "v": names}, mesh))
        opt = {"m": {k: _place(torch.empty_like(t), o_sh["m"][k]) for k, t in names.items()},
               "v": {k: _place(torch.empty_like(t), o_sh["v"][k]) for k, t in names.items()},
               "count": _place(torch.zeros((), dtype=torch.int32, device=META),
                               o_sh["count"])}
        args += _tensors(opt)
    arg_bytes = sum(_nbytes(t.to_local()) for t in args)
    param_bytes = sum(_nbytes(t) for t in params.values())
    module_bytes = sum(_nbytes(p) for p in model.parameters())
    cell["memory"] = {"argument_size_in_bytes": arg_bytes,
                      "gathered_module_bytes": module_bytes}
    known = [*model.parameters(), *(t.to_local() for t in args)]

    if train:
        rows = batch["inputs"].to_local().shape[0]
        n_micro = micro_depth(shape.global_batch, shape.seq_len, dp)
        cell["n_microbatches"] = n_micro
        if rows % n_micro:
            cell["status"] = (f"skip(micro: {rows} rows a device do not split into "
                              f"{n_micro} microbatches)")
            return None
        traced = min(n_micro, 2)
        take = rows // n_micro * traced
        rows_in = {k: v.to_local()[:take] for k, v in batch.items()}
        census = Census({MICROBATCH_RANGE: n_micro / traced},
                        base_bytes=arg_bytes + module_bytes, known=known)
        cell["traced_microbatches"] = traced
        with census:
            new_p, new_o, _ = sharded_step(model, mesh, params, opt, rows_in,
                                           n_microbatches=traced, opt_cfg=AdamWConfig(),
                                           batch_axes=axes)
        out_bytes = sum(_nbytes(t.to_local()) for t in _tensors((new_p, new_o)))
    else:
        step = (make_prefill_step(cfg, max_len=shape.seq_len) if shape.kind == "prefill"
                else make_decode_step(cfg))
        # the step holds the module, not the placed parameters it copies in
        census = Census(base_bytes=arg_bytes - param_bytes + module_bytes, known=known)
        seq = shd.cache_seq_axes(cfg, mesh, shape.global_batch)
        with census:
            with torch.no_grad():
                for k, p in model.named_parameters():
                    p.copy_(model_local(params[k]))
            local = _serve_inputs(batch, mesh)
            with tp.model_group(mesh, axes, seq):
                out = step(model, local)
        # what the step returns is the rank's shards of its outputs
        out_bytes = sum(_nbytes(t) for t in _tensors(out))
    cell["memory"]["output_size_in_bytes"] = out_bytes
    cell["memory"]["peak_memory_in_bytes"] = census.peak_bytes
    cell["memory"]["total_per_device_bytes"] = census.peak_bytes
    return census


def run_cell(
    arch: str | ModelConfig,
    shape_name: str | ShapeSpec,
    multi_pod: bool,
    hlo_path: str | None = None,
    opt: str = "baseline",
    *,
    mesh: dict[str, int] | None = None,
    hw: str | None = None,
) -> dict:
    """Trace one cell and return its artifact (the reference's keys, plus
    ``hw``, ``flops_source`` and ``tp_compute``).

    ``arch`` is a name in ``ARCHS`` or a ``ModelConfig`` (a ``.smoke()``
    cut, say); ``shape_name`` a name in ``SHAPES`` or a ``ShapeSpec``;
    ``mesh`` is
    an ordered {axis: size} (default: the production mesh, (16, 16) or
    (2, 16, 16), refactored by the preset's ``mesh_factor``); ``hw`` a
    ``HW_TABLES`` name for the roofline terms (default: the reference's).
    ``hlo_path``: where to write the traced op census (gzipped JSON), the
    port's stand-in for the reference's HLO text.  A preset whose flags the
    port refuses, and a cell the reference skips, come back with a
    ``skip(...)`` status."""
    cfg = arch if isinstance(arch, ModelConfig) else get_config(arch)
    refuse_mla(cfg, "the dry-run's roofline")
    shape = shape_name if isinstance(shape_name, ShapeSpec) else SHAPES[shape_name]
    flags = OPT_PRESETS[opt]
    sizes = _mesh_sizes(multi_pod, flags.mesh_factor, mesh)
    chips = math.prod(sizes.values())
    cell = {"arch": cfg.name, "shape": shape.name, "mesh": "x".join(map(str, sizes.values())),
            "chips": chips, "opt": opt, "hw": hw or "tpu_v5e",
            "flops_source": "FlopCounterMode",
            "bytes_source": "each op's input and output bytes, unfused: an upper bound"}
    hw_table(hw)                     # an unknown name raises before any trace
    try:
        set_flags(flags)
    except ValueError as e:
        cell["status"] = f"skip(opt {opt}: {e})"
        return cell
    impl = get_attention_impl()
    try:
        reason = skip_reason(cfg, shape)
        if reason:
            cell["status"] = reason
            return cell
        t0 = time.perf_counter()
        set_attention_impl("torch")
        with fake_world(chips):
            dmesh = make_mesh(tuple(sizes.values()), tuple(sizes), device="cpu")
            act_sharding.set_policy(shd.activation_policy(cfg, shape, dmesh))
            census = _trace(cfg, shape, dmesh, sizes, cell)
        cell["trace_s"] = round(time.perf_counter() - t0, 2)
    finally:
        act_sharding.clear_policy()
        set_attention_impl(impl)
        clear_flags()
    if census is None:
        return cell
    if hlo_path:
        with gzip.open(hlo_path, "wt") as f:
            json.dump({k: {"calls": c, "bytes": b} for k, (c, b) in
                       sorted(census.ops.items(), key=lambda kv: -kv[1][1])}, f)
    cost = {"flops": census.flops, "bytes accessed": census.bytes}
    cell["cost"] = cost
    coll = census.coll
    cell["collectives"] = {"total_bytes": coll.total_bytes, "count": coll.count,
                           "by_kind": dict(coll.by_kind)}
    mf = model_flops(cfg, shape)
    terms = roofline_terms(cost, coll, chips, mf, hw=hw)
    cell["roofline"] = {
        "compute_s": terms.compute_s,
        "memory_s": terms.memory_s,
        "collective_s": terms.collective_s,
        "bound": terms.bound,
        "model_flops": mf,
        "hlo_flops_per_chip": terms.flops,
        "hlo_flops_global": terms.flops * chips,
        "hbm_bytes_per_chip": terms.hbm_bytes,
        "coll_bytes_per_chip": terms.coll_bytes,
        "useful_ratio": terms.useful_ratio,
    }
    cell["status"] = "ok"
    return cell


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape id or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="every cell, both meshes")
    ap.add_argument("--opt", default="baseline", choices=sorted(OPT_PRESETS))
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--hw", default=None, help="HW_TABLES name for the roofline "
                    "terms (default: the reference's table)")
    args = ap.parse_args(argv)
    if os.path.abspath(args.out) == os.path.abspath(REFERENCE_OUT):
        raise SystemExit(f"--out {args.out}: that directory holds the reference's "
                         "dry-run artifacts, which its tests read")

    archs = list(ARCHS) if (args.all or args.arch == "all") else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape == "all") else [args.shape]
    meshes = ([False, True] if (args.all or args.mesh == "both")
              else [args.mesh == "multi"])
    os.makedirs(args.out, exist_ok=True)

    failures = 0
    for arch in archs:
        for shape_name in shapes:
            for multi in meshes:
                tag = f"{arch}__{shape_name}__{'multi' if multi else 'single'}"
                if args.opt != "baseline":
                    tag += f"__opt-{args.opt}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    with open(path) as f:
                        prev = json.load(f)
                    if prev.get("status", "").startswith(("ok", "skip")):
                        print(f"[cached] {tag}: {prev['status']}")
                        continue
                try:
                    cell = run_cell(arch, shape_name, multi,
                                    hlo_path=os.path.join(args.out, tag + ".ops.json.gz"),
                                    opt=args.opt, hw=args.hw)
                except Exception as e:     # one cell's failure is its artifact
                    cell = {"arch": arch, "shape": shape_name,
                            "mesh": "2x16x16" if multi else "16x16",
                            "status": f"FAIL: {e!r}",
                            "traceback": traceback.format_exc()[-4000:]}
                    failures += 1
                with open(path, "w") as f:
                    json.dump(cell, f, indent=1)
                rf = cell.get("roofline", {})
                print(
                    f"[{cell['status'][:60]}] {tag} "
                    f"trace={cell.get('trace_s', '-')}s "
                    f"bound={rf.get('bound', '-')} "
                    f"terms=({rf.get('compute_s', 0):.2e},"
                    f"{rf.get('memory_s', 0):.2e},{rf.get('collective_s', 0):.2e})s",
                    flush=True,
                )
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
