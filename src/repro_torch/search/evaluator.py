"""Chunked batched config evaluation on one device.

The what-if engine answers the paper's questions by evaluating the analytic
job model (:func:`repro_torch.core.hadoop.model.job_model_torch`) over
*grids* of configurations.  :class:`ChunkedEvaluator` streams a grid through
the batched model:

* **Fixed-size padded chunks** — every batch is padded (edge-replicated) to
  one static ``chunk`` length, so device memory stays bounded whatever the
  grid size.  Rows are independent, so the chunked results are bit-for-bit
  identical to the one-call :func:`evaluate_unchunked` path (tested).
* **On-device top-k** — ``chunk_topk`` reduces each chunk to its ``k`` best
  (and ``k`` best *invalid*) candidates on the device, so a 10^6-config
  search transfers k values per chunk to the host instead of the whole grid.
* **Invalid-config escape hatch** — configs with ``valid == 0`` (closed-form
  merge math out of domain, paper §2.3) are *not* silently ``inf``: top-k
  survivors are routed to :meth:`exact_cost`, the task-scheduler simulator
  (:mod:`repro_torch.core.hadoop.simulator`).

Differences from the reference package's evaluator: PyTorch runs eagerly,
so there is no compiled executable to cache and no compile counter
(``eval_cache_size`` / ``topk_cache_size`` and the "xla compile" trace
instants have no counterpart).  ``devices=[...]`` splits each chunk's model
body over several devices (:func:`repro_torch.compat.split_rows`, the
reference's ``shard_map`` over a ``"search"`` mesh); the top-k reduction
then runs on the first device over the joined outputs.  One device (the
default) takes the unsplit path.

Every evaluator exposes ``param_space`` and ``grad_objective``, the hooks of
gradient search (:func:`repro_torch.search.gradient_descent_ev`): the
Hadoop evaluator's objective is the job model under autograd, on the
evaluator's own device and dtype; a backend without a differentiable cost
raises :class:`NotDifferentiableError`.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.compat import resolve_device, search_devices, split_rows
from repro_torch.core.hadoop.model import job_model_torch, pack_config
from repro_torch.core.hadoop.params import CostFactors, HadoopParams, ProfileStats
from repro_torch.core.hadoop.simulator import SimConfig, simulate_job
from repro_torch.obs import current as _obs_current
from repro_torch.spec import CostReport, JobSpec, ParamSpace, hadoop_space
from repro_torch.spec.report import VALIDITY_CONSTRAINTS

__all__ = [
    "InvalidGridError",
    "ExactCostUnavailable",
    "NotDifferentiableError",
    "SearchResult",
    "BlockTopK",
    "Evaluator",
    "ChunkedEvaluator",
    "cached_evaluator",
    "evaluate_unchunked",
    "apply_assignment",
    "split_overrides",
    "pad_block",
    "sanitize_costs",
    "masked_total",
]


class InvalidGridError(ValueError):
    """Every configuration in the evaluated grid was invalid (no finite cost)."""


class NotDifferentiableError(TypeError):
    """This backend's cost is not a differentiable function of its knobs.

    Raised by :meth:`Evaluator.grad_objective` on backends whose cost comes
    from a simulation or table lookup.  Gradient-based strategies catch it
    and fall back — loudly — to a zeroth-order strategy.
    """


class ExactCostUnavailable(ValueError):
    """``exact_cost`` cannot produce a finite cost for this one candidate
    (e.g. the cluster DES reports the workload never finishes there).

    Raised instead of returning a silent ``inf``: direct callers get the
    explicit failure, while the generic fallback paths (streamed top-k,
    coordinate descent, the what-if service) catch it, log, and leave that
    candidate at ``inf`` rather than aborting a whole completed search.
    """


@dataclass
class SearchResult:
    """Batched model outputs plus the override grid that produced them."""

    overrides: dict[str, np.ndarray]    # key -> (B,) values
    outputs: dict[str, np.ndarray]      # model key -> (B,) values
    total_cost: np.ndarray              # (B,) seconds (inf where invalid)

    def best(self) -> tuple[int, float, dict[str, float]]:
        """Index, cost and override assignment of the cheapest valid config.

        Raises :class:`InvalidGridError` if no config is valid — the seed
        version silently returned index 0 (an invalid config) in that case.
        """
        if self.total_cost.size == 0 or not np.isfinite(self.total_cost).any():
            raise InvalidGridError(
                "no valid configuration in the grid (all costs are inf); "
                "use repro_torch.search.search_topk(exact_fallback=True) to route "
                "invalid configs through the exact simulator instead"
            )
        i = int(np.argmin(self.total_cost))
        return i, float(self.total_cost[i]), {
            k: float(v[i]) for k, v in self.overrides.items()
        }


def apply_assignment(
    p: HadoopParams,
    s: ProfileStats,
    c: CostFactors,
    assignment: Mapping[str, float],
) -> tuple[HadoopParams, ProfileStats, CostFactors]:
    """Route a flat {config key: value} assignment onto the three parameter
    dataclasses with proper int/bool coercion.

    Thin adapter over :meth:`repro_torch.spec.ParamSpace.apply` — the axis
    kinds of :func:`repro_torch.spec.hadoop_space` are the single source of
    coercion.
    """
    return hadoop_space().apply(assignment, p, s, c)


def sanitize_costs(raw, xp=np):
    """NaN/±inf -> +inf, so one bad row can never win a min/top-k.

    The ONE implementation of the cost_key sanitization rule, shared by
    every evaluator's host (numpy) and device (``xp=torch``) reductions.
    """
    return xp.nan_to_num(raw, nan=xp.inf, posinf=xp.inf, neginf=xp.inf)


def masked_total(outputs: Mapping[str, Any], cost_key: str, xp=np):
    """The canonical total-cost column: model cost where ``valid``, else inf.

    Shared by :class:`ChunkedEvaluator`, the cluster planner and the what-if
    service so the invalid-row convention cannot drift between backends.

    Gradient safety: this ``where`` zeroes the gradient of masked rows, but
    a zero gradient times an infinite *local* derivative upstream is still
    NaN (the classic where/inf bug).  The fix lives at the producers — the
    dangerous divisions in ``core/hadoop/model.py`` are double-``where``
    guarded and round counts use the straight-through helpers.
    """
    return xp.where(outputs["valid"] > 0, outputs[cost_key], xp.inf)


@dataclass
class BlockTopK:
    """Per-block top-k reduction: k cheapest valid rows, k cheapest invalid
    rows (candidates for the exact escape hatch), and the block valid count.
    Indices are block-local.  ``reason_counts`` says *why* rows were invalid
    (per closed-form constraint of :data:`repro_torch.spec.VALIDITY_CONSTRAINTS`),
    for backends whose outputs expose the disaggregated flags."""

    costs: np.ndarray
    idx: np.ndarray
    inv_costs: np.ndarray
    inv_idx: np.ndarray
    n_valid: int
    reason_counts: dict[str, int] = field(default_factory=dict)


class Evaluator:
    """Interface every search backend implements.

    ``evaluate`` returns full per-config outputs; ``chunk_topk`` reduces one
    block to its best candidates; ``exact_cost`` (optional) is the escape
    hatch for ``valid == 0`` survivors.
    """

    chunk: int = 4096

    def evaluate(self, overrides: Mapping[str, Any]) -> SearchResult:
        raise NotImplementedError

    def exact_cost(self, assignment: Mapping[str, float]) -> float | None:
        """Exact re-cost of one assignment, ``None`` when the backend has no
        exact path.  May raise :class:`ExactCostUnavailable` for a candidate
        whose exact cost is undefined (callers in this package catch it)."""
        return None

    def report(self, overrides: Mapping[str, Any]) -> CostReport | None:
        """Typed per-phase :class:`repro_torch.spec.CostReport` for these rows, or
        ``None`` for backends without a phase decomposition."""
        return None

    @property
    def param_space(self) -> ParamSpace | None:
        """Declarative description of this backend's searchable axes
        (:class:`repro_torch.spec.ParamSpace`), or ``None`` if undeclared."""
        return None

    def grad_objective(self):
        """Differentiable objective, for gradient strategies.

        Returns ``fn({key: tensor}) -> (cost, valid)`` where ``cost`` is
        the *raw* (unmasked) model cost — differentiable w.r.t. every float
        override under autograd — and ``valid`` the model's validity flag
        (0/1, no useful gradient).  The overrides may be 0-d or share one
        length B (rows of one batched call: the model is row-wise, so the
        gradient of the summed cost is each row's own), on the evaluator's
        ``device`` in its ``dtype``, which a backend with an objective
        declares.  Backends whose cost is not a differentiable function of
        the knobs raise :class:`NotDifferentiableError` instead; callers
        must catch it and fall back loudly.
        """
        raise NotDifferentiableError(
            f"{type(self).__name__} does not expose a differentiable "
            "objective; use a zeroth-order strategy (grid/random/descent)"
        )

    def chunk_topk(self, overrides: Mapping[str, np.ndarray], k: int) -> "BlockTopK":
        """Top-k of one block: the k cheapest valid configs and the k
        cheapest invalid configs (ranked by raw model cost), on the host
        over :meth:`evaluate`'s outputs — the default for backends without
        a device reduction (the cluster and cloud planners)."""
        from repro_torch.spec.report import invalid_reason_counts

        res = self.evaluate(overrides)
        valid = res.outputs["valid"] > 0
        raw = sanitize_costs(res.outputs[self.cost_key])
        cost = np.where(valid, raw, np.inf)
        inv = np.where(~valid, raw, np.inf)
        kk = min(k, cost.size)
        idx = np.argsort(cost, kind="stable")[:kk]
        inv_idx = np.argsort(inv, kind="stable")[:kk]
        # merged cfg gates reduce-side constraints off for map-only rows,
        # matching ChunkedEvaluator.chunk_topk's on-device counts
        cfg = {**getattr(self, "base_cfg", {}), **overrides}
        return BlockTopK(cost[idx], idx, inv[inv_idx], inv_idx, int(valid.sum()),
                         invalid_reason_counts(res.outputs, cfg or None))

    @property
    def cost_key(self) -> str:
        return "j_totalCost"


def split_overrides(
    base_cfg: Mapping[str, torch.Tensor], overrides: Mapping[str, Any]
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor], int]:
    """Validate + cast an override mapping against ``base_cfg``: 1-D values
    become batched ``(n,)`` columns sharing one length, scalars are merged
    onto the base as statics.  Each override takes ``base_cfg``'s dtype and
    device for its key (``torch.as_tensor``), so service-normalized rows and
    direct calls see bit-identical inputs."""
    static = dict(base_cfg)
    batched: dict[str, torch.Tensor] = {}
    n = None
    for k, v in overrides.items():
        if k not in base_cfg:
            raise KeyError(f"unknown config key: {k!r}")
        ref = base_cfg[k]
        arr = torch.as_tensor(np.asarray(v), dtype=ref.dtype, device=ref.device)
        if arr.dim() > 1:
            raise ValueError(f"override {k!r} must be scalar or 1-D")
        if arr.dim() == 1:
            if n is None:
                n = arr.shape[0]
            elif arr.shape[0] != n:
                raise ValueError("all batched overrides must share a length")
            batched[k] = arr
        else:
            static[k] = arr
    if n is None:
        raise ValueError("at least one override must be batched")
    if n == 0:
        raise ValueError("batched overrides are empty (0-length grid)")
    return batched, static, n


def pad_block(
    batched: Mapping[str, torch.Tensor], start: int, stop: int, chunk: int
) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """One ``(chunk,)``-padded slice ``[start, stop)``: edge-replicated
    values + liveness mask, on the columns' device."""
    n = stop - start
    pad = chunk - n
    cols = {}
    for k, v in batched.items():
        sl = v[start:stop]
        cols[k] = torch.cat([sl, sl[-1:].expand(pad)]) if pad else sl
    mask = torch.zeros(chunk, dtype=torch.bool, device=next(iter(cols.values())).device)
    mask[:n] = True
    return cols, mask


def _run_model(model_fn, static, batched, n: int) -> dict[str, torch.Tensor]:
    """``model_fn`` over ``n`` rows; outputs that depend on no batched
    column come back 0-d and are broadcast to ``(n,)``."""
    out = model_fn({**static, **batched})
    return {k: v.expand(n) if v.dim() == 0 else v for k, v in out.items()}


def _host(out: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in out.items()}


def evaluate_unchunked(
    base_cfg: dict,
    overrides: Mapping[str, Any],
    model_fn: Callable[[dict], dict] = job_model_torch,
) -> dict:
    """Every row in one batched model call — the path the chunked
    evaluator is held to, bit-for-bit (tests)."""
    batched, static, n = split_overrides(base_cfg, overrides)
    return _host(_run_model(model_fn, static, batched, n))


class ChunkedEvaluator(Evaluator):
    """Streaming chunked evaluator over the Hadoop job model.

    Parameters
    ----------
    p, s, c : the base configuration (any field may be overridden per-row).
    chunk   : rows per model call; every call is padded to this length
              (rounded up to a multiple of the device count).
    device  : where the model runs (default CUDA, see
              :func:`repro_torch.compat.resolve_device`).
    devices : split each chunk's rows over these devices
              (:func:`repro_torch.compat.search_devices`; the first one
              holds the base config and runs the top-k reduction).  Default:
              ``[device]``, the unsplit path.
    dtype   : float type of the packed config, default float64.
    model_fn: batched model, flat cfg dict -> flat outputs dict; must emit
              ``j_totalCost`` and ``valid``.
    """

    def __init__(
        self,
        p: HadoopParams,
        s: ProfileStats,
        c: CostFactors,
        *,
        chunk: int = 1 << 13,
        device=None,
        devices=None,
        dtype: torch.dtype = torch.float64,
        model_fn: Callable[[dict], dict] = job_model_torch,
    ):
        self._psc = (p, s, c)
        #: typed view of the base configuration (repro_torch.spec.JobSpec)
        self.spec = JobSpec(p, s, c)
        if devices is None:
            self.devices = (resolve_device(device),)
        else:
            self.devices = tuple(search_devices(devices))
            if device is not None and resolve_device(device) != self.devices[0]:
                raise ValueError("device must be the first of devices")
        self.device = self.devices[0]
        self.num_devices = len(self.devices)
        self.dtype = dtype
        #: packed base config (flat key -> 0-d tensor on ``device``); public
        #: so callers can drive evaluate_unchunked against the same base
        self.base_cfg = pack_config(p, s, c, dtype=dtype, device=self.device)
        self._model_fn = model_fn
        self.chunk = -(-max(chunk, 1) // self.num_devices) * self.num_devices

    @classmethod
    def from_spec(cls, spec: JobSpec, **kw) -> "ChunkedEvaluator":
        """Construct from a typed :class:`repro_torch.spec.JobSpec` — the
        typed spelling of ``ChunkedEvaluator(p, s, c)``."""
        return cls(spec.params, spec.stats, spec.costs, **kw)

    @property
    def param_space(self) -> ParamSpace:
        """The paper's Tables-1-3 axes (:func:`repro_torch.spec.hadoop_space`)."""
        return hadoop_space()

    def _split(self, overrides: Mapping[str, Any]):
        return split_overrides(self.base_cfg, overrides)

    def _run(self, static, cols) -> dict[str, torch.Tensor]:
        """The model over one padded chunk: on one device as is, else one
        contiguous block of rows per device, joined on the first."""
        if self.num_devices == 1:
            return _run_model(self._model_fn, static, cols, self.chunk)

        def block(part, dev):
            st = {k: v.to(dev) for k, v in static.items()}
            return _run_model(self._model_fn, st, part, self.chunk // self.num_devices)

        return split_rows(block, cols, self.devices)

    # ---------------- public API ----------------

    def evaluate(self, overrides: Mapping[str, Any]) -> SearchResult:
        """Full outputs for every row, streamed through fixed-size chunks.

        Bit-for-bit identical to :func:`evaluate_unchunked` on the same
        overrides (padding rows are computed but dropped here).
        """
        batched, static, n = self._split(overrides)
        ob = _obs_current()
        t0 = time.perf_counter() if ob.enabled else 0.0
        out_blocks: dict[str, list[torch.Tensor]] = {}
        with ob.tracer.span("evaluator.evaluate", rows=n):
            for start in range(0, n, self.chunk):
                stop = min(start + self.chunk, n)
                cols, _ = pad_block(batched, start, stop, self.chunk)
                out = self._run(static, cols)
                if ob.enabled:
                    ob.registry.counter("evaluator.chunks").inc()
                for k, v in out.items():
                    out_blocks.setdefault(k, []).append(v[: stop - start])
            outputs = _host({k: torch.cat(v) for k, v in out_blocks.items()})
        if ob.enabled:
            self._note_evaluate(ob, n, time.perf_counter() - t0)
        total = masked_total(outputs, self.cost_key)
        return SearchResult(overrides=_host(batched), outputs=outputs,
                            total_cost=total)

    def _note_evaluate(self, ob, n: int, elapsed: float) -> None:
        n_chunks = -(-n // self.chunk)
        padded = n_chunks * self.chunk - n
        reg = ob.registry
        reg.counter("evaluator.rows").inc(n)
        reg.counter("evaluator.rows_padded").inc(padded)
        reg.histogram("evaluator.evaluate_s").record(elapsed)
        if elapsed > 0:
            ob.tracer.counter(
                "evaluator",
                configs_per_s=n / elapsed,
                padding_waste=padded / (n + padded) if n + padded else 0.0,
            )

    def report(self, overrides: Mapping[str, Any]) -> CostReport:
        """Typed per-phase report for these rows; ``total_cost`` and
        ``valid`` are the dict path's arrays by reference."""
        res = self.evaluate(overrides)
        cfg = _host(self.base_cfg)
        for k, v in overrides.items():
            cfg[k] = np.asarray(v, dtype=cfg[k].dtype)
        return CostReport.from_outputs(res.outputs, cfg)

    def chunk_topk(self, overrides: Mapping[str, np.ndarray], k: int) -> BlockTopK:
        """On-device top-k of one block (k cheapest valid / invalid rows);
        only 2k scalars + indices and the counts come back to the host.

        Ties resolve to the lower row index (a stable sort over the chunk),
        the order the reference's ``jax.lax.top_k`` gives, so the set and
        order of the top k match the reference on grids with exact ties.
        """
        batched, static, n = self._split(overrides)
        if n > self.chunk:
            raise ValueError(f"block of {n} rows exceeds chunk={self.chunk}")
        cols, live = pad_block(batched, 0, n, self.chunk)
        kk = min(k, self.chunk)
        ob = _obs_current()
        with ob.tracer.span("evaluator.chunk_topk", rows=n, k=kk):
            out = self._run(static, cols)
            raw = sanitize_costs(out[self.cost_key], xp=torch)
            ok = out["valid"] > 0
            cost = torch.where(ok & live, raw, torch.inf)
            inv = torch.where(~ok & live, raw, torch.inf)
            idx = torch.sort(cost, stable=True).indices[:kk]
            inv_idx = torch.sort(inv, stable=True).indices[:kk]
            # per-constraint invalidity counts ride the same device pass, so
            # the escape-hatch log can say WHICH closed-form domain failed;
            # reduce-side flags are zeroed by the model for map-only rows
            has_red = cols.get("pNumReducers", static["pNumReducers"]) > 0
            names, counts = [], [torch.sum(ok & live)]
            for name, (key, reduce_side, _) in VALIDITY_CONSTRAINTS.items():
                if key not in out:
                    continue
                failed = (out[key] == 0) & live
                if reduce_side:
                    failed = failed & has_red
                names.append(name)
                counts.append(torch.sum(failed))
            counts = torch.stack(counts).tolist()
            host = _host({"c": cost[idx], "i": idx, "ic": inv[inv_idx],
                          "ii": inv_idx})
        if ob.enabled:
            reg = ob.registry
            reg.counter("evaluator.topk_blocks").inc()
            reg.counter("evaluator.rows").inc(n)
            reg.counter("evaluator.rows_padded").inc(self.chunk - n)
        return BlockTopK(
            host["c"], host["i"], host["ic"], host["ii"], int(counts[0]),
            {name: int(c) for name, c in zip(names, counts[1:]) if c},
        )

    def grad_objective(self):
        """The job model as a differentiable objective: the branch-free
        equations with straight-through round counts, on the base config
        plus the given overrides (tensors on this evaluator's device, in
        its dtype).  Same ``model_fn`` as the chunked path, so the value at
        any point agrees with :meth:`evaluate`."""
        base = self.base_cfg
        model_fn = self._model_fn
        cost_key = self.cost_key

        def objective(overrides: Mapping[str, torch.Tensor]):
            out = model_fn({**base, **overrides})
            return out[cost_key], out["valid"]

        return objective

    def exact_cost(self, assignment: Mapping[str, float]) -> float:
        """Escape hatch for ``valid == 0``: exact task-scheduler simulation
        (paper §5 way (i)); its per-task merge accounting uses the exact
        merge simulation, so it has no closed-form domain restriction."""
        p2, s2, c2 = apply_assignment(*self._psc, assignment)
        return float(simulate_job(p2, s2, c2, SimConfig()).makespan)


# The parameter dataclasses are frozen (hashable), so repeated calls through
# the whatif/tuner/api paths with the same base config, device and dtype
# reuse one evaluator.
@functools.lru_cache(maxsize=16)
def cached_evaluator(
    p: HadoopParams,
    s: ProfileStats,
    c: CostFactors,
    chunk: int | None = None,
    device=None,
    dtype: torch.dtype = torch.float64,
) -> ChunkedEvaluator:
    kw = {} if chunk is None else {"chunk": chunk}
    return ChunkedEvaluator(p, s, c, device=device, dtype=dtype, **kw)
