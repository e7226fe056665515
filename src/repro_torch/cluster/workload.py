"""Multi-job workloads over the canonical MapReduce job profiles.

The paper costs a *single* job; a production cluster serves a stream of
them.  This module describes that stream:

* :class:`JobClass` — a job template: Table-1 parameters (mappers, reducers,
  sort buffer, ...) plus Table-2/3 profile statistics and cost factors for
  one of the :data:`repro_torch.mapreduce.jobs.JOBS` profiles.  Per-task costs
  come from the paper's job model (:func:`task_costs`), exactly as in the
  single-job simulator.
* :class:`WorkloadTrace` — a sorted sequence of :class:`JobArrival` events.
* Trace generators — :func:`poisson_trace` (open-loop Poisson arrivals),
  :func:`bursty_trace` (on/off bursts), :func:`replayed_trace` (explicit
  submit times, e.g. replayed from a production log).

Traces are generated at a *unit* arrival rate and rescaled with
:func:`rescale`, so "arrival rate" can be a searched axis of the capacity
planner without regenerating (or re-uploading) the trace.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np

from repro_torch.cluster.network import per_reducer_shuffle
from repro_torch.core.hadoop.params import CostFactors, HadoopParams, MiB, ProfileStats
from repro_torch.core.hadoop.ref import job_model
from repro_torch.mapreduce.jobs import JOBS

__all__ = [
    "JobClass",
    "JobArrival",
    "WorkloadTrace",
    "StageEdge",
    "StageDag",
    "task_costs",
    "shuffle_full",
    "stage_output_bytes",
    "default_job_classes",
    "dag_from_templates",
    "dag_trace",
    "dag_report",
    "poisson_trace",
    "bursty_trace",
    "replayed_trace",
    "rescale",
]


@dataclass(frozen=True)
class JobClass:
    """A job template: one row of a workload mix.

    ``params`` carries the job-shaped Table-1 knobs (``pNumMappers``,
    ``pNumReducers``, ``pSortMB``...); cluster-shaped knobs (nodes, slots,
    slowstart) are supplied by the scheduler configuration at simulation
    time, so one class can be costed on any candidate cluster.
    """

    name: str
    params: HadoopParams
    stats: ProfileStats
    costs: CostFactors
    weight: float = 1.0      # relative arrival frequency in generated traces

    @property
    def n_maps(self) -> int:
        return self.params.pNumMappers

    @property
    def n_reduces(self) -> int:
        return self.params.pNumReducers


@functools.lru_cache(maxsize=1024)
def _job_model_cached(params: HadoopParams, stats: ProfileStats,
                      costs: CostFactors):
    """One :func:`job_model` evaluation per distinct (params, stats, costs).

    A workload trace repeats a handful of :class:`JobClass` templates over
    thousands of arrivals; the parameter dataclasses are frozen (hashable),
    so per-arrival callers (``pack_trace``, the DES's per-job setup) hit
    this cache and a 10k-job trace costs ~one model call per class instead
    of one per arrival.
    """
    return job_model(params, stats, costs)


def task_costs(jc: JobClass, *, num_nodes: int | None = None
               ) -> tuple[float, float, float]:
    """(map task cost, reduce task cost, per-reducer shuffle seconds).

    The same composition the single-job simulator uses: per-task I/O + CPU
    from the §2-§4 models, plus each reducer's serialized share of the
    network transfer (Eqs. 90-91).  ``num_nodes`` is the *cluster's* node
    count — it sets the remote fraction ``(n-1)/n`` of the shuffle, which is
    a capacity-planning knob, not a property of the job.  Memoized per
    (class, node count) via :func:`_job_model_cached`.
    """
    p = jc.params
    if num_nodes is not None:
        p = p.replace(pNumNodes=num_nodes)
    jm = _job_model_cached(p, jc.stats, jc.costs)
    map_cost = jm.map.ioCost + jm.map.cpuCost
    red_cost = jm.reduce.ioCost + jm.reduce.cpuCost if p.pNumReducers else 0.0
    shuffle = per_reducer_shuffle(jm.netCost, p.pNumReducers)
    return map_cost, red_cost, shuffle


def shuffle_full(jc: JobClass) -> float:
    """Per-reducer shuffle seconds in the all-remote limit ((n-1)/n -> 1).

    The vectorized simulator stores this node-independent constant per job
    and applies the remote fraction of each candidate cluster on device.
    Memoized per class via :func:`_job_model_cached`.
    """
    if jc.params.pNumReducers == 0:
        return 0.0
    jm = _job_model_cached(jc.params, jc.stats, jc.costs)
    size = jm.map.intermDataSize * jc.params.pNumMappers         # Eq. 90, frac=1
    return size * jc.costs.cNetworkCost / jc.params.pNumReducers


@dataclass(frozen=True)
class JobArrival:
    job_id: int
    klass: JobClass
    submit_time: float
    #: DAG edges gating this arrival: ``(parent_job_id, edge_kind)`` pairs,
    #: ``edge_kind`` in ``{"barrier", "slowstart"}``.  The job is held until
    #: every parent releases it — at the parent's finish (barrier) or at its
    #: map-phase completion (slowstart, overlapping the parent's reduce
    #: wave) — and then arrives at ``max(submit_time, release time)``.
    deps: tuple[tuple[int, str], ...] = ()


@dataclass(frozen=True)
class WorkloadTrace:
    """Arrivals sorted by (submit_time, job_id) — the FIFO service order."""

    arrivals: tuple[JobArrival, ...]

    def __post_init__(self):
        object.__setattr__(
            self, "arrivals",
            tuple(sorted(self.arrivals, key=lambda a: (a.submit_time, a.job_id))),
        )

    @property
    def n_jobs(self) -> int:
        return len(self.arrivals)

    @property
    def submit_times(self) -> np.ndarray:
        return np.asarray([a.submit_time for a in self.arrivals])


def rescale(trace: WorkloadTrace, rate: float) -> WorkloadTrace:
    """Speed a unit-rate trace up (rate > 1) or down: times scale by 1/rate."""
    if rate <= 0:
        raise ValueError(f"arrival rate must be positive, got {rate}")
    return WorkloadTrace(tuple(
        JobArrival(a.job_id, a.klass, a.submit_time / rate, a.deps)
        for a in trace.arrivals
    ))


# --------------------------------------------------------------------------
# the default workload mix
# --------------------------------------------------------------------------

# Table-2-style profiles for the canonical jobs of repro_torch.mapreduce.jobs,
# derived from the map/reduce functions' semantics (see that module): each
# wordcount record emits 4 twelve-byte pairs, filter keeps an exact 20%,
# aggregate's combiner collapses the key space to 256 hot keys, sort moves
# every byte through unchanged.
_PROFILES: dict[str, dict] = {
    "wordcount": dict(
        stats=ProfileStats(sInputPairWidth=400.0, sMapPairsSel=4.0,
                           sMapSizeSel=4 * 12.0 / 400.0,
                           sCombinePairsSel=0.3, sCombineSizeSel=0.3),
        params=dict(pUseCombine=True, pNumMappers=16, pNumReducers=4),
        weight=4.0,
    ),
    "sort": dict(
        stats=ProfileStats(sInputPairWidth=100.0),
        params=dict(pNumMappers=32, pNumReducers=8),
        weight=1.0,
    ),
    "filter": dict(
        stats=ProfileStats(sInputPairWidth=200.0, sMapPairsSel=0.2,
                           sMapSizeSel=0.2),
        params=dict(pNumMappers=16, pNumReducers=2),
        weight=3.0,
    ),
    "aggregate": dict(
        stats=ProfileStats(sInputPairWidth=64.0, sMapSizeSel=16.0 / 64.0,
                           sCombinePairsSel=0.05, sCombineSizeSel=0.05),
        params=dict(pUseCombine=True, pNumMappers=16, pNumReducers=2),
        weight=2.0,
    ),
}


def default_job_classes(
    *,
    split_size: float = 64 * MiB,
    costs: CostFactors | None = None,
    names: Sequence[str] | None = None,
) -> list[JobClass]:
    """The standard 4-class mix over :data:`repro_torch.mapreduce.jobs.JOBS`."""
    c = costs if costs is not None else CostFactors()
    out = []
    for name in (names if names is not None else _PROFILES):
        if name not in JOBS:
            raise KeyError(f"unknown job profile: {name!r}")
        prof = _PROFILES[name]
        p = HadoopParams(pSplitSize=split_size, **prof["params"])
        out.append(JobClass(name=name, params=p, stats=prof["stats"],
                            costs=c, weight=prof["weight"]))
    return out


# --------------------------------------------------------------------------
# DAG workloads: multi-stage jobs where stage outputs feed stage inputs
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class StageEdge:
    """A dependency between two stages of a :class:`StageDag`.

    ``kind="barrier"`` releases the destination stage when the source stage
    fully finishes (Hive/Pig-style stage boundaries); ``kind="slowstart"``
    releases it when the source's *map phase* completes, overlapping the
    destination with the source's reduce wave — the DAG analogue of the
    paper's ``pSlowstartThreshold`` intra-job overlap.
    """

    src: int
    dst: int
    kind: str = "barrier"


@dataclass(frozen=True)
class StageDag:
    """A multi-stage job: stages (each a :class:`JobClass`) plus edges.

    Validated on construction: edge endpoints in range, no self-edges, no
    duplicate edges, acyclic (Kahn).  ``topo_order`` lists stage indices
    with every stage after all of its parents; ``is_serial`` is True for a
    width-1 chain — the case where the critical path *is* the makespan.
    """

    name: str
    stages: tuple[JobClass, ...]
    edges: tuple[StageEdge, ...] = ()

    def __post_init__(self):
        n = len(self.stages)
        if n == 0:
            raise ValueError("a StageDag needs at least one stage")
        seen = set()
        for e in self.edges:
            if e.kind not in ("barrier", "slowstart"):
                raise ValueError(f"unknown edge kind: {e.kind!r}")
            if not (0 <= e.src < n and 0 <= e.dst < n):
                raise ValueError(f"edge ({e.src}->{e.dst}) out of range for "
                                 f"{n} stages")
            if e.src == e.dst:
                raise ValueError(f"self-edge on stage {e.src}")
            if (e.src, e.dst) in seen:
                raise ValueError(f"duplicate edge ({e.src}->{e.dst})")
            seen.add((e.src, e.dst))
        self.topo_order          # raises on cycles

    @property
    def topo_order(self) -> tuple[int, ...]:
        n = len(self.stages)
        indeg = [0] * n
        children: dict[int, list[int]] = {}
        for e in self.edges:
            indeg[e.dst] += 1
            children.setdefault(e.src, []).append(e.dst)
        order = [i for i in range(n) if indeg[i] == 0]
        for i in order:
            for ch in children.get(i, ()):
                indeg[ch] -= 1
                if indeg[ch] == 0:
                    order.append(ch)
        if len(order) != n:
            raise ValueError(f"StageDag {self.name!r} has a cycle")
        return tuple(order)

    @property
    def is_serial(self) -> bool:
        """True for a width-1 chain: n-1 edges, every degree <= 1."""
        n = len(self.stages)
        if len(self.edges) != n - 1:
            return False
        outd = [0] * n
        ind = [0] * n
        for e in self.edges:
            outd[e.src] += 1
            ind[e.dst] += 1
        return max(outd, default=0) <= 1 and max(ind, default=0) <= 1

    def parents_of(self, stage: int) -> tuple[StageEdge, ...]:
        return tuple(e for e in self.edges if e.dst == stage)


def stage_output_bytes(jc: JobClass) -> float:
    """Final output bytes a stage writes — the next stage's input.

    The Table-1 dataflow identities, job-wide: with reduces the job writes
    ``outReduceSize * sOutCompressRatio`` per reducer (Eqs. 83 + 86), with
    a map-only job ``outMapSize * sOutCompressRatio`` per mapper (Eq. 8's
    compressed write).  Memoized per class via :func:`_job_model_cached`.
    """
    p = jc.params
    jm = _job_model_cached(p, jc.stats, jc.costs)
    if p.pNumReducers:
        return float(jm.reduce.outReduceSize * jc.stats.sOutCompressRatio
                     * p.pNumReducers)
    return float(jm.map.outMapSize * jc.stats.sOutCompressRatio
                 * p.pNumMappers)


def dag_from_templates(
    name: str,
    templates: Sequence[JobClass],
    edges: Sequence[StageEdge | tuple],
    *,
    split_size: float = 64 * MiB,
) -> StageDag:
    """Build a :class:`StageDag` whose dataflow is *derived*, not declared.

    Each non-root stage's input is the sum of its parents' final output
    bytes (:func:`stage_output_bytes`), so its mapper count is rewired to
    ``max(1, ceil(input_bytes / split_size))`` — exactly how Hadoop sizes a
    downstream job reading the upstream job's HDFS output.  Stages are
    processed in topological order so a rewired parent's output feeds its
    children's sizing.
    """
    norm_edges = tuple(e if isinstance(e, StageEdge) else StageEdge(*e)
                       for e in edges)
    dag = StageDag(name=name, stages=tuple(templates), edges=norm_edges)
    stages = list(dag.stages)
    for i in dag.topo_order:
        parent_edges = dag.parents_of(i)
        if not parent_edges:
            continue
        in_bytes = sum(stage_output_bytes(stages[e.src]) for e in parent_edges)
        n_maps = max(1, int(np.ceil(in_bytes / split_size)))
        jc = stages[i]
        stages[i] = JobClass(
            name=jc.name, stats=jc.stats, costs=jc.costs, weight=jc.weight,
            params=jc.params.replace(pNumMappers=n_maps,
                                     pSplitSize=split_size),
        )
    return StageDag(name=name, stages=tuple(stages), edges=norm_edges)


def dag_trace(
    dag: StageDag,
    *,
    n_instances: int = 1,
    inter_arrival: float = 0.0,
    submit_time: float = 0.0,
    job_id_base: int = 0,
) -> WorkloadTrace:
    """Expand a :class:`StageDag` into a dependency-carrying trace.

    Each instance contributes ``len(dag.stages)`` arrivals sharing one
    submit time; non-root stages carry ``deps`` edges so the DES (and,
    single-parent, the wave model) holds them until their parents release.
    Stage job-ids follow topological order, so every parent id is lower
    than its children's — the order :func:`pack_trace` requires.
    """
    if n_instances < 1:
        raise ValueError(f"n_instances must be >= 1, got {n_instances}")
    order = dag.topo_order
    arrivals = []
    jid = job_id_base
    for inst in range(n_instances):
        t0 = submit_time + inst * inter_arrival
        jid_of = {}
        for stage in order:
            jid_of[stage] = jid
            deps = tuple((jid_of[e.src], e.kind)
                         for e in dag.parents_of(stage))
            arrivals.append(JobArrival(jid, dag.stages[stage], t0, deps))
            jid += 1
    return WorkloadTrace(tuple(arrivals))


def dag_report(trace: WorkloadTrace, result):
    """Critical-path analysis of a simulated DAG trace.

    Pairs the trace's dependency edges with the DES's measured per-stage
    times and returns a typed :class:`repro_torch.spec.DagReport`.  Defined here
    (not in ``repro_torch.spec``) so the spec layer stays free of cluster
    imports; the report itself is a spec dataclass.
    """
    from repro_torch.spec import DagReport

    jobs = sorted(result.jobs, key=lambda js: js.job_id)
    idx = {js.job_id: k for k, js in enumerate(jobs)}
    edges = []
    for a in trace.arrivals:
        for parent, kind in a.deps:
            edges.append((idx[a.job_id], idx[parent], kind))
    return DagReport.from_times(
        submit=[js.submit_time for js in jobs],
        first_launch=[js.first_launch for js in jobs],
        map_finish=[js.map_finish for js in jobs],
        finish=[js.finish for js in jobs],
        edges=edges,
    )


# --------------------------------------------------------------------------
# trace generators (all unit-rate; compose with rescale())
# --------------------------------------------------------------------------


def _pick_classes(classes: Sequence[JobClass], n: int,
                  rng: np.random.Generator) -> list[JobClass]:
    w = np.asarray([jc.weight for jc in classes], dtype=np.float64)
    idx = rng.choice(len(classes), size=n, p=w / w.sum())
    return [classes[i] for i in idx]


def poisson_trace(classes: Sequence[JobClass], n_jobs: int, *,
                  rate: float = 1.0, seed: int = 0) -> WorkloadTrace:
    """Open-loop Poisson arrivals: exponential gaps of mean ``1/rate``."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n_jobs)
    times = np.cumsum(gaps) - gaps[0]          # first job arrives at t=0
    picks = _pick_classes(classes, n_jobs, rng)
    return WorkloadTrace(tuple(
        JobArrival(i, jc, float(t)) for i, (jc, t) in enumerate(zip(picks, times))
    ))


def bursty_trace(classes: Sequence[JobClass], n_bursts: int, burst_size: int, *,
                 burst_gap: float = 60.0, intra_gap: float = 0.5,
                 seed: int = 0) -> WorkloadTrace:
    """On/off arrivals: ``n_bursts`` bursts of ``burst_size`` near-simultaneous
    jobs, ``burst_gap`` apart — the worst case for FIFO tail latency."""
    rng = np.random.default_rng(seed)
    picks = _pick_classes(classes, n_bursts * burst_size, rng)
    arrivals = []
    jid = 0
    for b in range(n_bursts):
        for k in range(burst_size):
            arrivals.append(JobArrival(jid, picks[jid],
                                       b * burst_gap + k * intra_gap))
            jid += 1
    return WorkloadTrace(tuple(arrivals))


def replayed_trace(times: Sequence[float],
                   classes: Sequence[JobClass] | Mapping[int, JobClass],
                   *, seed: int = 0) -> WorkloadTrace:
    """Replay explicit submit times (e.g. from a production log).

    ``classes`` is either a per-job mapping (job index -> class) or a pool
    to sample from by weight.
    """
    n = len(times)
    if isinstance(classes, Mapping):
        picks = [classes[i] for i in range(n)]
    else:
        picks = _pick_classes(list(classes), n, np.random.default_rng(seed))
    return WorkloadTrace(tuple(
        JobArrival(i, jc, float(t)) for i, (t, jc) in enumerate(zip(times, picks))
    ))
