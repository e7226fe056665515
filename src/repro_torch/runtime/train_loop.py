"""Production train loop: sharded storage, checkpoint/auto-resume,
straggler hooks, failure injection.

The port of ``repro/runtime/train_loop.py``.  The Trainer composes the
pieces built elsewhere:

  step           repro_torch.launch.steps.accumulate_grads (microbatches,
                 fp32 accumulation) and repro_torch.optim.adamw_update:
                 make_train_step's two halves, with the data-axis average
                 and the shard update between them
  sharding       repro_torch.launch.sharding rules on a (dp, tp) mesh:
                 parameters and AdamW state are DTensors under the rules'
                 placements
  data           repro_torch.data.TokenPipeline (stateless -> exact resume;
                 each data rank draws only its rows)
  checkpoints    repro_torch.checkpoint.CheckpointManager (atomic, async,
                 CRC-checked, elastic)
  stragglers     repro_torch.runtime.stragglers.StragglerDetector

Each step gathers the rank's ``model`` shards of the parameters over the
batch/FSDP axes only (``redistribute`` to ``Replicate`` on ``pod``/``data``,
``Shard`` kept on ``model``) into a plain ``nn.Module`` of local shapes
(:func:`repro_torch.models.weights.empty` with ``model=(rank, size)``), so
every kernel runs on plain tensors, never through DTensor dispatch; installs
the model group (:mod:`repro_torch.models.tensor_parallel`: tensor- and
expert-parallel compute over ``model``, Megatron-style, and the MoE's
global routing over the batch axes), not the activation policy, which stays
cleared as in the reference's Trainer; runs the microbatches of the rank's
batch shard; averages the gradients and the loss over the batch axes,
SUM-reduces over ``model`` the gradients of parameters the rules replicate
while a rank computes with a slice of them; and updates each rank's shard
with the global gradient norm (squares of ``model``-sharded leaves summed
over the axis, replicated ones counted once).  Each rank holds and
computes only its ``model`` shards.  At one rank the numbers are
``make_train_step``'s.  With no process group,
:func:`~repro_torch.launch.mesh.world` opens one of a single rank for each
:meth:`Trainer.run`, so one device runs the same code as many ranks.

Data: the reference splits the global batch into microbatches of
consecutive rows and shards each over the batch axis, so data rank ``r``'s
microbatch ``i`` holds global rows ``i B / n + r B / (n dp)`` onward; each
rank draws just those rows (:class:`~repro_torch.data.TokenPipeline` is
stateless by row), so that the MoE's global microbatch is the reference's.

``grad_compression``: the reference keeps the field but its Trainer never
reads it (``crosspod_reduce`` is called only by its tests).  The port keeps
the field and refuses any value but ``"none"``, so that no setting silently
does nothing; :func:`repro_torch.runtime.crosspod.crosspod_reduce` is the
function.

Fault-tolerance contract (``tests/test_torch_trainer.py``): ``run()`` after
a crash resumes from the newest valid checkpoint and reproduces the
parameter trajectory of an uninterrupted run bit for bit (data indexing is
stateless, and saves capture parameters, optimizer state and step).  On the
card that needs ``torch.use_deterministic_algorithms(True)`` (with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before the first cuBLAS call).
"""

from __future__ import annotations

import json
import math
import os
import tempfile
import time
from collections import namedtuple
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.checkpoint import CheckpointManager
from repro_torch.compat import resolve_device
from repro_torch.data import PipelineConfig, TokenPipeline
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import full_tensor, make_mesh, model_local, world
from repro_torch.launch.steps import accumulate_grads, init_params
from repro_torch.models import act_sharding
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.config import ModelConfig, refuse_mla
from repro_torch.models.weights import empty
from repro_torch.optim import AdamWConfig, adamw_update, global_norm

from .stragglers import StragglerDetector

__all__ = ["Trainer", "TrainerConfig", "sharded_step"]

#: a mesh's axis names and sizes, all the sharding rules read
MeshShape = namedtuple("MeshShape", ["mesh_dim_names", "shape"])


@dataclass
class TrainerConfig:
    global_batch: int = 8
    seq_len: int = 128
    n_microbatches: int = 1
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_every: int = 50
    keep: int = 3
    async_ckpt: bool = True
    log_every: int = 10
    seed: int = 0
    grad_compression: str = "none"      # only "none": see the module doc
    mesh_shape: tuple = ()              # () -> (world size, 1)
    mesh_axes: tuple = ("data", "model")
    opt: AdamWConfig = field(default_factory=AdamWConfig)
    # failure injection (tests): raise RuntimeError AFTER this step's save
    fail_at_step: int | None = None
    device: Any = None                  # None: the CUDA card

    def __post_init__(self):
        if self.grad_compression != "none":
            raise ValueError(
                f"grad_compression={self.grad_compression!r}: the reference's "
                "Trainer never reads this field, so the port refuses it; "
                "compress a cross-pod reduction with "
                "repro_torch.runtime.crosspod.crosspod_reduce")


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig):
        refuse_mla(cfg, "the Trainer")
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(tcfg.device)
        world_size = dist.get_world_size() if dist.is_initialized() else 1
        rank = dist.get_rank() if dist.is_initialized() else 0
        shape = tuple(tcfg.mesh_shape) or (world_size, 1)
        self.mesh_shape = MeshShape(tuple(tcfg.mesh_axes), shape)
        # the batch is split over the first axis, as in the reference;
        # ranks are row-major over the mesh (launch.mesh.make_mesh)
        self.dp = shape[0]
        self.data_rank = rank // math.prod(shape[1:])
        axes = tuple(tcfg.mesh_axes)
        m = axes.index("model") if "model" in axes else None
        # this rank's (place, size) on the model axis: its module's shards
        self.model_part = ((0, 1) if m is None else
                           (rank // math.prod(shape[m + 1:]) % shape[m], shape[m]))
        n = tcfg.n_microbatches
        self.pipelines = [TokenPipeline(PipelineConfig(
            vocab_size=cfg.vocab_size, seq_len=tcfg.seq_len,
            global_batch=tcfg.global_batch, seed=tcfg.seed,
            num_hosts=self.dp * n, host_index=i * self.dp + self.data_rank))
            for i in range(n)]
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.stragglers = StragglerDetector()
        self.metrics_log: list[dict] = []
        self.straggler_events: list[int] = []
        self.host = f"host{rank}"
        self.mesh = None
        self.model = None
        self._build()

    # ----------------------------------------------------------- specs
    def _build(self):
        """The rules' specs, from parameter shapes on the meta device."""
        shapes = empty(self.cfg, device="meta", param_dtype=torch.float32)
        names = dict(shapes.named_parameters())
        self.p_specs = shd.param_pspecs(self.cfg, names, self.mesh_shape)
        self.o_specs = shd.opt_pspecs(self.cfg, {"m": names, "v": names},
                                      self.mesh_shape)
        self._example = {
            "params": {k: p.detach() for k, p in names.items()},
            "opt": {"count": torch.empty((), dtype=torch.int32, device="meta"),
                    "m": {k: p.detach() for k, p in names.items()},
                    "v": {k: p.detach() for k, p in names.items()}}}

    def batch(self, step: int) -> dict:
        """The rank's rows of global batch ``step``: its shard of each
        microbatch, in microbatch order."""
        parts = [p.batch(step) for p in self.pipelines]
        if len(parts) == 1:
            return parts[0]
        return {k: np.concatenate([b[k] for b in parts]) for k in parts[0]}

    def _init_state(self, p_sh, o_sh):
        """Seeded parameters (every rank draws each leaf whole, one at a
        time, and keeps its shards) and zeroed AdamW state."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        self.model = init_params(gen, self.cfg, device=self.device,
                                 param_dtype=torch.float32, model=self.model_part)
        shapes = self._example["params"]
        params = {k: _from_model_local(p.detach(), p_sh[k], shapes[k].shape)
                  for k, p in self.model.named_parameters()}
        opt = {"m": {k: torch.zeros_like(p) for k, p in params.items()},
               "v": {k: torch.zeros_like(p) for k, p in params.items()},
               "count": distribute_tensor(
                   torch.zeros((), dtype=torch.int32, device=self.device),
                   o_sh["count"].mesh, o_sh["count"].placements, src_data_rank=None)}
        return params, opt

    # ----------------------------------------------------------- step
    def _step(self, params: dict, opt: dict, batch: dict):
        """One step: :func:`sharded_step`, averaged over the mesh's first
        axis (the batch axis, as in the reference)."""
        return sharded_step(self.model, self.mesh, params, opt, batch,
                            n_microbatches=self.tcfg.n_microbatches,
                            opt_cfg=self.tcfg.opt,
                            batch_axes=tuple(self.tcfg.mesh_axes[:1]))

    # ----------------------------------------------------------- training
    def run(self, num_steps: int, *, resume: bool = True) -> dict:
        """Train to ``num_steps`` total; resumes from the latest checkpoint
        at its step + 1.  Returns the full parameters and AdamW state
        (plain tensors by name), the final loss and the log.  A resumed run
        that takes no step does not save its restored checkpoint again."""
        with world(self.device):
            return self._run(num_steps, resume)

    def _run(self, num_steps: int, resume: bool) -> dict:
        tcfg = self.tcfg
        self.mesh = make_mesh(self.mesh_shape.shape, self.mesh_shape.mesh_dim_names,
                              device=self.device)
        p_sh = shd.named(self.mesh, self.p_specs)
        o_sh = shd.named(self.mesh, self.o_specs)
        start, restored = 0, None
        params = opt = None
        if resume:
            state, manifest = self.ckpt.restore(
                self._example, shardings={"params": p_sh, "opt": o_sh})
            if state is not None:
                params, opt = state["params"], state["opt"]
                restored = manifest["step"]
                start = restored + 1
                self.model = empty(self.cfg, device=self.device,
                                   param_dtype=torch.float32, model=self.model_part)
        if params is None:
            params, opt = self._init_state(p_sh, o_sh)

        act_sharding.clear_policy()
        last_loss = float("nan")
        for step in range(start, num_steps):
            batch = self.batch(step)
            t0 = time.perf_counter()
            params, opt, metrics = self._step(params, opt, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            if self.stragglers.observe(self.host, dt):
                self.straggler_events.append(step)
            last_loss = loss
            if step % tcfg.log_every == 0 or step == num_steps - 1:
                self.metrics_log.append({
                    "step": step, "loss": loss, "time_s": dt,
                    "grad_norm": float(metrics.get("grad_norm", 0.0))})
            if tcfg.ckpt_every and (step + 1) % tcfg.ckpt_every == 0:
                self.ckpt.save(step, {"params": params, "opt": opt},
                               blocking=not tcfg.async_ckpt, extra={"loss": loss})
            if tcfg.fail_at_step is not None and step == tcfg.fail_at_step:
                self.ckpt.wait()
                raise RuntimeError(f"injected failure at step {step}")
        self.ckpt.wait()
        if start < num_steps or restored != num_steps - 1:
            self.ckpt.save(num_steps - 1, {"params": params, "opt": opt})
        dist.barrier()      # rank 0's files are on disk for every rank
        full = full_tensor
        return {
            "params": {k: full(p) for k, p in params.items()},
            "opt": {"m": {k: full(t) for k, t in opt["m"].items()},
                    "v": {k: full(t) for k, t in opt["v"].items()},
                    "count": full(opt["count"])},
            "final_loss": last_loss, "log": self.metrics_log,
        }

    # -------------------------------------------------------------- utils
    def save_log(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            for rec in self.metrics_log:
                f.write(json.dumps(rec) + "\n")


def _over_batch(t: torch.Tensor, placements, mesh) -> torch.Tensor:
    """The rank's shard over the non-``model`` axes of a ``model``-local
    tensor (the split DTensor makes, no collective)."""
    rest = tuple(Replicate() if mesh.mesh_dim_names[i] == "model" else p
                 for i, p in enumerate(placements))
    return distribute_tensor(t, mesh, rest, src_data_rank=None).to_local()


def _from_model_local(t: torch.Tensor, place, shape) -> DTensor:
    """A DTensor of global ``shape`` under ``place`` (a NamedPlacement) from
    the rank's ``model``-local tensor ``t``."""
    mesh = place.mesh
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(_over_batch(t, place.placements, mesh), mesh,
                              place.placements, run_check=False, shape=shape,
                              stride=stride)


def sharded_step(model: torch.nn.Module, mesh, params: dict, opt: dict, batch: dict,
                 *, n_microbatches: int, opt_cfg: AdamWConfig,
                 batch_axes: tuple = ("data",)):
    """The Trainer's step on one rank: gather the rank's ``model`` shards of
    the parameters (DTensors under the rules' placements) over the other
    axes into ``model``, a plain module of local shapes; accumulate the
    rank's rows of ``batch`` over ``n_microbatches`` under the model group
    (tensor- and expert-parallel compute, the MoE's global routing over
    ``batch_axes``); average the gradients and the loss over the mesh axes
    ``batch_axes`` (an all-reduce over each axis of more than one rank),
    SUM-reduce over ``model`` the gradients of parameters used in slices;
    and update the rank's shards of the parameters and the AdamW state with
    the global gradient norm.  Returns (params, opt, metrics) as DTensors on
    ``mesh``.  The dry-run (:mod:`repro_torch.launch.dryrun`) traces this
    function."""
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(model_local(params[k]))
    batch_axes = tuple(a for a in batch_axes if a in mesh.mesh_dim_names)
    with tp.model_group(mesh, batch_axes) as group:
        acc, loss = accumulate_grads(model, batch, n_microbatches)
    sizes = shd.mesh_axes(mesh)
    dp = math.prod(sizes[a] for a in batch_axes)
    if dp > 1:
        groups = [mesh.get_group(a) for a in batch_axes if sizes[a] > 1]
        for g in [*acc.values(), loss]:
            for axis_group in groups:
                dist.all_reduce(g, group=axis_group)
            g.div_(dp)
    if group.size > 1:
        for k, g in acc.items():
            if tp.sliced_replicated(model.cfg, k, group.size):
                dist.all_reduce(g, group=group.group)
        gnorm = _global_norm(acc, params, mesh, group)
    else:
        gnorm = global_norm(acc)
    grads = {}
    for k in list(acc):
        grads[k] = _over_batch(acc.pop(k), params[k].placements, mesh)
    local = {k: p.to_local() for k, p in params.items()}
    state = {"m": {k: t.to_local() for k, t in opt["m"].items()},
             "v": {k: t.to_local() for k, t in opt["v"].items()},
             "count": opt["count"].to_local()}
    with torch.no_grad():
        new_p, new_s, metrics = adamw_update(grads, state, local, opt_cfg,
                                             grad_norm=gnorm)
    del grads, local, state

    def wrap(t, like):
        return DTensor.from_local(t, mesh, like.placements, run_check=False,
                                  shape=like.shape, stride=like.stride())

    params = {k: wrap(new_p[k], params[k]) for k in params}
    opt = {"m": {k: wrap(new_s["m"][k], opt["m"][k]) for k in params},
           "v": {k: wrap(new_s["v"][k], opt["v"][k]) for k in params},
           "count": wrap(new_s["count"], opt["count"])}
    return params, opt, {"loss": loss, **metrics}


def _global_norm(grads: dict, params: dict, mesh, group) -> torch.Tensor:
    """The norm of the whole gradient from the ranks' ``model``-local ones:
    the squares of leaves sharded over ``model`` summed over the axis, those
    of replicated leaves (equal on every rank) counted once."""
    axis = mesh.mesh_dim_names.index("model")
    zero = next(iter(grads.values())).new_zeros((), dtype=torch.float32)
    split, whole = zero.clone(), zero.clone()
    for k in sorted(grads):
        sq = torch.sum(torch.square(grads[k].float()))
        if isinstance(params[k].placements[axis], Shard):
            split += sq
        else:
            whole += sq
    dist.all_reduce(split, group=group.group)
    return torch.sqrt(split + whole)
