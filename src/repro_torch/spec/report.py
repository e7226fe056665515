"""Structured per-phase cost reports: :class:`PhaseBreakdown` + :class:`CostReport`.

The paper's output is not one number — it is a *decomposition*: per-phase
costs on the map side (read+map, collect/spill, merge, write) and the
reduce side (shuffle, sort/merge, reduce+write), plus the network transfer,
composed into job-level totals (Eqs. 92-98).  The batched model
(:func:`repro_torch.core.hadoop.model.job_model_torch`) emits all of it, but
as a flat ``m_*``/``r_*``/``j_*``-prefixed dict; this module lifts that dict
into typed dataclasses whose fields carry the paper equation numbers in
their metadata:

* :class:`PhaseBreakdown` — the eight job-level phase costs, in seconds.
  They **sum to Eq. 98's total** (property-tested): each map phase is
  scaled by ``pNumMappers / map slots`` (Eqs. 92-93), each reduce phase by
  ``pNumReducers / reduce slots`` (Eqs. 94-95).
* :class:`CostReport` — the phase breakdown plus the job-level aggregates
  (Eqs. 96-98) and the *disaggregated* validity flags: where the flat path
  collapses ``mergeValid * step2Valid * step3Valid`` into one ``valid``
  float, a report says which closed-form constraint actually failed
  (:meth:`CostReport.invalid_reasons`).

Leaves are numpy arrays or torch tensors, whichever the outputs were; a
batched report is a report whose leaves are ``(B,)`` columns.
``total_cost`` is the model's ``j_totalCost`` *by reference* — the typed
path is bit-for-bit the dict path.

:class:`CalibrationReport` decomposes one model *fit*
(:func:`repro_torch.calib.calibrate`), :class:`ProvisioningReport` one
priced-fleet evaluation (:class:`repro_torch.cloud.CloudEvaluator`) and
:class:`DagReport` the critical path of a simulated multi-stage workload
(:func:`repro_torch.cluster.workload.dag_report`).
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Mapping

import numpy as np
import torch

__all__ = [
    "PhaseBreakdown",
    "CostReport",
    "CalibrationReport",
    "PHASES",
    "VALIDITY_CONSTRAINTS",
    "invalid_reason_counts",
    "invalid_reasons",
]


class _TorchXp:
    """The few array functions :meth:`CostReport.from_outputs` needs, on torch."""

    @staticmethod
    def asarray(x, like=None):
        return torch.as_tensor(x, device=like.device if like is not None else None)

    ones_like = staticmethod(torch.ones_like)
    where = staticmethod(torch.where)


def _xp(*arrays):
    """numpy for numpy inputs, torch for tensors."""
    return _TorchXp if any(isinstance(a, torch.Tensor) for a in arrays) else np


def _np(x) -> np.ndarray:
    """A host numpy view of an array or a (possibly CUDA) tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _phase(eq: str, side: str, doc: str):
    return field(metadata={"eq": eq, "side": side, "doc": doc})


@dataclass(frozen=True)
class PhaseBreakdown:
    """Job-level per-phase costs in seconds (fields sum to Eq. 98).

    Field metadata carries the paper provenance:
    ``PhaseBreakdown.eq("shuffle") -> "Eqs. 35-61"``.
    """

    map_read: object = _phase(
        "Eqs. 2-4", "map", "read + decompress the split, run the map function")
    map_spill: object = _phase(
        "Eqs. 11-19", "map", "collect, serialize, sort, combine and spill")
    map_merge: object = _phase(
        "Eqs. 20-32", "map", "merge spill files into the final map output")
    map_write: object = _phase(
        "Eqs. 5-7", "map", "write map output to HDFS (map-only jobs)")
    shuffle: object = _phase(
        "Eqs. 35-61", "reduce", "fetch, buffer and shuffle-merge map segments")
    reduce_merge: object = _phase(
        "Eqs. 62-80", "reduce", "multi-step sort/merge of shuffled segments")
    reduce_write: object = _phase(
        "Eqs. 81-87", "reduce", "run the reduce function, write to HDFS")
    network: object = _phase(
        "Eqs. 90-91", "job", "cross-node shuffle transfer")

    @classmethod
    def names(cls) -> tuple[str, ...]:
        return tuple(f.name for f in fields(cls))

    @classmethod
    def eq(cls, name: str) -> str:
        return cls.__dataclass_fields__[name].metadata["eq"]

    @classmethod
    def describe(cls, name: str) -> str:
        m = cls.__dataclass_fields__[name].metadata
        return f"{m['doc']} ({m['eq']})"

    def total(self):
        """Sum of all phases == ``j_totalCost`` (Eqs. 96-98; tested)."""
        vals = [getattr(self, f.name) for f in fields(self)]
        out = vals[0]
        for v in vals[1:]:
            out = out + v
        return out

    def __getitem__(self, name: str):
        if name not in self.__dataclass_fields__:
            raise KeyError(
                f"unknown phase: {name!r} (phases: {list(self.names())})")
        return getattr(self, name)


PHASES: tuple[str, ...] = PhaseBreakdown.names()

#: constraint name -> (model output key, reduce-side?, human explanation).
#: These are the three §2.3 closed-form merge domains that the flat path
#: multiplies into a single ``valid`` float.
VALIDITY_CONSTRAINTS: dict[str, tuple[str, bool, str]] = {
    "mapMerge": (
        "m_mergeValid", False,
        "map-side spill merge out of the closed-form domain: "
        "numSpills > pSortFactor**2 (§2.3, Eqs. 20-26)",
    ),
    "shuffleMerge": (
        "r_step2Valid", True,
        "reduce-side disk merge (step 2) out of the closed-form domain: "
        "filesToMergeStep2 > pSortFactor**2 (Eq. 69)",
    ),
    "finalMerge": (
        "r_step3Valid", True,
        "reduce-side final merge (step 3) out of the closed-form domain: "
        "filesToMergeStep3 > pSortFactor**2 (Eq. 74)",
    ),
}


@dataclass(frozen=True)
class CostReport:
    """Typed view of one (or a batch of) job-model evaluation(s).

    Every leaf is an array; a batched report has ``(B,)`` columns.  The
    aggregate fields are the model's own outputs by reference (bit-for-bit
    with the ``j_*`` dict keys); ``phases`` re-scales the per-task phase
    costs to job level so they sum to ``total_cost``.
    """

    phases: PhaseBreakdown
    io_cost: object                 # Eq. 96  (j_ioJobCost)
    cpu_cost: object                # Eq. 97  (j_cpuJobCost)
    net_cost: object                # Eq. 91  (j_netCost)
    total_cost: object              # Eq. 98  (j_totalCost)
    valid: object                   # product of the three constraints below
    merge_valid: object             # §2.3 map-side domain (m_mergeValid)
    shuffle_valid: object           # Eq. 69 domain (r_step2Valid; 1 if map-only)
    sort_valid: object              # Eq. 74 domain (r_step3Valid; 1 if map-only)

    @classmethod
    def from_outputs(
        cls, outputs: Mapping[str, object], cfg: Mapping[str, object]
    ) -> "CostReport":
        """Build a report from flat model outputs + the (merged) config.

        ``outputs`` is a :func:`job_model_torch` output dict (scalar or
        batched); ``cfg`` must resolve the five structural knobs the
        job-level scaling needs (``pNumMappers``, ``pNumReducers``,
        ``pNumNodes``, ``pMaxMapsPerNode``, ``pMaxRedPerNode``) — base
        config values with any swept columns merged over them.
        """
        total = outputs["j_totalCost"]
        xp = _xp(total)
        like = {} if xp is np else {"like": total}
        n_map = xp.asarray(cfg["pNumMappers"], **like)
        n_red = xp.asarray(cfg["pNumReducers"], **like)
        nodes = xp.asarray(cfg["pNumNodes"], **like)
        m_scale = n_map / (nodes * xp.asarray(cfg["pMaxMapsPerNode"], **like))
        r_scale = n_red / (nodes * xp.asarray(cfg["pMaxRedPerNode"], **like))
        has_red = n_red > 0

        def mphase(io_key, cpu_key):
            return (outputs[io_key] + outputs[cpu_key]) * m_scale

        def rphase(io_key, cpu_key):
            return (outputs[io_key] + outputs[cpu_key]) * r_scale

        phases = PhaseBreakdown(
            map_read=mphase("m_ioReadCost", "m_cpuReadCost"),
            map_spill=mphase("m_ioSpillCost", "m_cpuSpillCost"),
            map_merge=mphase("m_ioMergeCost", "m_cpuMergeCost"),
            map_write=mphase("m_ioMapWriteCost", "m_cpuMapWriteCost"),
            shuffle=rphase("r_ioShuffleCost", "r_cpuShuffleCost"),
            reduce_merge=rphase("r_ioSortCost", "r_cpuSortCost"),
            reduce_write=rphase("r_ioWriteCost", "r_cpuWriteCost"),
            network=outputs["j_netCost"],
        )
        one = xp.ones_like(outputs["valid"])
        return cls(
            phases=phases,
            io_cost=outputs["j_ioJobCost"],
            cpu_cost=outputs["j_cpuJobCost"],
            net_cost=outputs["j_netCost"],
            total_cost=outputs["j_totalCost"],
            valid=outputs["valid"],
            merge_valid=outputs["m_mergeValid"],
            # the model zeroes ALL r_* outputs for map-only jobs, including
            # the flags; a constraint that cannot apply did not fail
            shuffle_valid=xp.where(has_red, outputs["r_step2Valid"], one),
            sort_valid=xp.where(has_red, outputs["r_step3Valid"], one),
        )

    # ---------------- validity introspection ----------------

    def invalid_reasons(self, i: int | None = None) -> list[str]:
        """Which closed-form constraints failed (for row ``i`` if batched)."""
        flags = {
            "mapMerge": self.merge_valid,
            "shuffleMerge": self.shuffle_valid,
            "finalMerge": self.sort_valid,
        }
        out = []
        for name, flag in flags.items():
            v = _np(flag)
            failed = (v[i] if i is not None else v) == 0
            if np.any(failed):
                out.append(f"{name}: {VALIDITY_CONSTRAINTS[name][2]}")
        return out

    def best(self) -> int:
        """Index of the cheapest valid row (raises if none is valid)."""
        from repro_torch.search.evaluator import InvalidGridError  # no import cycle at module load

        cost = np.where(_np(self.valid) > 0, _np(self.total_cost), np.inf)
        if cost.size == 0 or not np.isfinite(cost).any():
            raise InvalidGridError(
                "no valid configuration in this report; reasons: "
                + "; ".join(self.invalid_reasons())
            )
        return int(np.argmin(cost))


@dataclass(frozen=True)
class ProvisioningReport:
    """Typed view of one (or a batch of) priced-fleet evaluation(s).

    The :class:`CostReport` of the economic layer
    (:class:`repro_torch.cloud.CloudEvaluator`): dollars and SLO attainment
    instead of per-phase seconds.  Leaves are numpy arrays or tensors, as
    the outputs were; a batched report has ``(B,)`` columns.
    """

    dollars_per_job: object      # workload bill / jobs served ($/job)
    dollar_makespan: object      # the whole workload's bill ($)
    slo_attainment: object       # fraction of jobs with latency <= sloLatency
    mean_latency: object         # seconds (submit -> finish)
    p95_latency: object          # seconds (latency_quantile(95) rule)
    utilization: object          # busy slot-seconds / online slot-seconds
    valid: object                # axis mask & simulator convergence

    @classmethod
    def from_outputs(cls, outputs: Mapping[str, object]
                     ) -> "ProvisioningReport":
        """Lift a :meth:`repro_torch.cloud.CloudEvaluator.evaluate` output
        dict (the ``c_*`` columns) into the typed view, leaves by reference."""
        return cls(
            dollars_per_job=outputs["c_dollarsPerJob"],
            dollar_makespan=outputs["c_dollarMakespan"],
            slo_attainment=outputs["c_sloAttain"],
            mean_latency=outputs["c_meanLat"],
            p95_latency=outputs["c_p95Lat"],
            utilization=outputs["c_util"],
            valid=outputs["valid"],
        )


@dataclass(frozen=True)
class DagReport:
    """Critical-path decomposition of a measured multi-stage (DAG) run.

    Built from the cluster DES's per-stage times
    (:func:`repro_torch.cluster.workload.dag_report`); numpy leaves.
    ``critical_path_s <= makespan_s`` always: the path chains *measured*
    stage service times through the dependency edges, so
    scheduling/queueing slack can only add on top of it — equality means a
    serial (width-1) DAG ran back-to-back, and ``slack_s`` is the headroom
    a better schedule (or more slots) could recover.
    """

    critical_path_s: object    # longest dependency-respecting work chain (s)
    makespan_s: object         # first submit -> last stage finish (s)
    slack_s: object            # makespan - critical path
    stage_runtime_s: object    # (n,) measured per-stage service time
    stage_finish_s: object     # (n,) absolute per-stage finish time
    critical_stage: object     # index of the stage the critical path ends in

    @classmethod
    def from_times(cls, submit, first_launch, map_finish, finish, edges
                   ) -> "DagReport":
        """Build from measured per-stage times plus dependency edges.

        ``submit`` is each stage's *release* time (the DES overwrites a DAG
        child's submit with it), ``edges`` is ``(child, parent, kind)``
        triples with kind ``"barrier"`` or ``"slowstart"``.  The recurrence
        anchors each stage's measured runtime ``finish - first_launch`` at
        the latest of its release and its parents' path ends — a slowstart
        parent hands off at its path end minus its own post-map tail
        (``finish - map_finish``), since the child only needed the map
        phase.  Each anchor is <= the stage's actual first launch, which is
        what makes ``critical_path_s <= makespan_s`` an invariant rather
        than a tendency.
        """
        submit = np.asarray(submit, dtype=np.float64)
        first_launch = np.asarray(first_launch, dtype=np.float64)
        map_finish = np.asarray(map_finish, dtype=np.float64)
        finish = np.asarray(finish, dtype=np.float64)
        n = submit.shape[0]
        run = finish - first_launch
        parents: dict[int, list[tuple[int, str]]] = {}
        children: dict[int, list[int]] = {}
        indeg = [0] * n
        for child, parent, kind in edges:
            parents.setdefault(int(child), []).append((int(parent), kind))
            children.setdefault(int(parent), []).append(int(child))
            indeg[int(child)] += 1
        order = [i for i in range(n) if indeg[i] == 0]
        for i in order:                       # Kahn: parents precede children
            for ch in children.get(i, ()):
                indeg[ch] -= 1
                if indeg[ch] == 0:
                    order.append(ch)
        if len(order) != n:
            raise ValueError("dependency edges contain a cycle")
        cp_end = np.zeros(n, dtype=np.float64)
        for i in order:
            anchor = submit[i]
            for parent, kind in parents.get(i, ()):
                hand = cp_end[parent]
                if kind == "slowstart":
                    hand = hand - (finish[parent] - map_finish[parent])
                anchor = max(anchor, hand)
            cp_end[i] = anchor + run[i]
        t0 = submit.min() if n else 0.0
        span = finish.max() - t0 if n else 0.0
        cp = cp_end.max() - t0 if n else 0.0
        if n and not np.isfinite(finish).all():
            cp = span = float("inf")
        return cls(
            critical_path_s=np.asarray(cp),
            makespan_s=np.asarray(span),
            slack_s=np.asarray(span - cp if np.isfinite(span) else 0.0),
            stage_runtime_s=run,
            stage_finish_s=finish,
            critical_stage=np.asarray(int(np.argmax(cp_end)) if n else 0),
        )


@dataclass(frozen=True)
class CalibrationReport:
    """Result of one gradient-calibration run (:mod:`repro_torch.calib`).

    The calibration counterpart of :class:`CostReport`: where a cost report
    decomposes one model *evaluation*, a calibration report decomposes one
    model *fit* — which parameters moved, from where to where, and how much
    of the observation error the fit removed.  Host-side values (plain
    floats): a report is what a fit returns, not what flows through the
    model.
    """

    fitted: dict[str, float]          # parameter name -> fitted value
    initial: dict[str, float]         # parameter name -> starting value
    loss: float                       # final loss (mean squared rel. error)
    initial_loss: float               # loss at the starting point
    steps: int                        # optimizer steps taken
    n_observations: int               # (JobSpec, cost) pairs fitted against
    loss_history: tuple[float, ...] = ()   # sampled loss trace
    #: grad-norm trace sampled at the same cadence as ``loss_history``
    #: (without the initial-point entry loss_history leads with)
    grad_norm_history: tuple[float, ...] = ()
    #: model evaluations the fit spent (loss/grad calls, incl. endpoints)
    n_model_evals: int = 0

    @property
    def param_names(self) -> tuple[str, ...]:
        return tuple(self.fitted)

    def improvement(self) -> float:
        """Fraction of the initial loss removed by the fit (0..1)."""
        if self.initial_loss <= 0.0:
            return 0.0
        return 1.0 - self.loss / self.initial_loss

    def delta(self, name: str) -> float:
        """Relative movement of one parameter from its starting value."""
        init = self.initial[name]
        if init == 0.0:
            return float("inf") if self.fitted[name] != 0.0 else 0.0
        return self.fitted[name] / init - 1.0

    def summary(self, top: int = 5) -> str:
        """A short human-readable fit digest (for logs and benchmarks)."""
        moved = sorted(
            self.fitted, key=lambda k: abs(self.delta(k)), reverse=True)
        lines = [
            f"calibrated {len(self.fitted)} parameter(s) over "
            f"{self.n_observations} observation(s) in {self.steps} steps: "
            f"loss {self.initial_loss:.3e} -> {self.loss:.3e} "
            f"({100.0 * self.improvement():.1f}% improvement)"
        ]
        for k in moved[:top]:
            lines.append(
                f"  {k}: {self.initial[k]:.4g} -> {self.fitted[k]:.4g}")
        return "\n".join(lines)


def invalid_reason_counts(
    outputs: Mapping[str, np.ndarray],
    cfg: Mapping[str, object] | None = None,
) -> dict[str, int]:
    """Per-constraint failure counts for a flat model-output batch.

    Used by the ``valid == 0`` exact-fallback log lines.  When ``cfg`` is
    given, reduce-side constraints are not counted for map-only rows
    (the model zeroes their flags there).  Returns only constraints whose
    output keys exist, so non-Hadoop evaluators yield ``{}``.
    """
    counts: dict[str, int] = {}
    for name, (key, reduce_side, _) in VALIDITY_CONSTRAINTS.items():
        if key not in outputs:
            continue
        failed = _np(outputs[key]) == 0
        if reduce_side and cfg is not None and "pNumReducers" in cfg:
            failed = failed & (_np(cfg["pNumReducers"]) > 0)
        n = int(np.sum(failed))
        if n:
            counts[name] = n
    return counts


def invalid_reasons(
    outputs: Mapping[str, np.ndarray],
    i: int,
    cfg: Mapping[str, object] | None = None,
) -> list[str]:
    """Human-readable failed constraints for row ``i`` of a flat batch."""
    out = []
    for name, (key, reduce_side, doc) in VALIDITY_CONSTRAINTS.items():
        if key not in outputs:
            continue
        if _np(outputs[key]).ravel()[i] != 0:
            continue
        if reduce_side and cfg is not None and "pNumReducers" in cfg:
            n_red = _np(cfg["pNumReducers"])
            if float(n_red.ravel()[i] if n_red.ndim else n_red) <= 0:
                continue
        out.append(f"{name}: {doc}")
    return out
