"""Multi-job discrete-event cluster simulator (FIFO / fair / preemptive).

Extends the single-job Task Scheduler Simulator (paper §5(i),
:mod:`repro_torch.core.hadoop.simulator`) to a *shared* virtual cluster: a
workload trace of jobs (:mod:`repro_torch.cluster.workload`) contends for one
pool of map slots and one pool of reduce slots across the fleet's nodes.
Per-task costs still come from the paper's §2-§4 models, and the per-job
mechanics are the single-job simulator's, job-tagged:

* two-phase reduces — the shuffle overlaps the job's own map fleet; the
  sort/reduce/write work only runs once ALL of that job's map outputs
  exist;
* slowstart — a job's reducers launch once ``reduce_slowstart`` of its
  maps are done (a cluster-level knob here, so the planner can search it);
* stragglers / speculative execution / node failures — identical seeded
  mechanics (a node failure kills tasks of *every* job on the node and
  re-executes lost map outputs of unfinished jobs).

Heterogeneous fleets: ``ClusterConfig.node_classes`` describes a mixed
fleet (e.g. ``4 x fast + 8 x slow``) as :class:`NodeClass` entries.  A
node's *compute* durations (map work, reduce sort/reduce/write work) are
divided by its class ``speedup``; the shuffle is network-bound and is not
scaled.  The free-slot picker prefers faster nodes, so on an uncontended
fleet the fast class fills first — the same rule the vectorized wave model
uses, which is what keeps the two in agreement on contention-free cases.

Scheduling policies:

* ``fifo``  — free slots go to the earliest-submitted job with pending
  tasks of that kind (Hadoop's default JobQueueTaskScheduler).
* ``fair``  — free slots go to the job with the fewest running tasks of
  that kind: equal per-job shares, a slot-granular max-min approximation
  of the Hadoop Fair Scheduler without preemption.  ``JobClass.weight``
  is arrival frequency in generated traces, *not* a scheduling share —
  the vectorized model splits the same way, so ``evaluate`` and
  ``exact_cost`` agree on what "fair" means.
* ``fair_preempt`` — fair-share with preemption: when a demanding job has
  been held below the floor fair share for ``preempt_timeout`` seconds
  while another job runs above it, the scheduler kills the most-over-share
  job's newest task (speculative copies first) and requeues it — Hadoop
  Fair Scheduler ``minSharePreemptionTimeout`` semantics at job
  granularity.  Killed tasks re-run from scratch.
* ``capacity`` — per-job-class queues with guaranteed capacities
  (``ClusterConfig.capacities``: relative weights per class name,
  normalized over the classes present; default equal).  Free slots go
  first to the queue furthest below its guarantee (FIFO within a queue);
  a queue held below its guaranteed slot count for ``preempt_timeout``
  seconds reclaims slots by killing the newest task of the most
  over-guarantee queue.

Determinism: one seeded RNG drives every duration draw; event ties break on
a monotone sequence number, so runs are bit-identical given a seed.  With
one job the simulation reproduces
:func:`repro_torch.core.hadoop.simulator.simulate_job` RNG-draw-for-RNG-draw
(tested, including jitter/straggler/speculation noise).  The mechanics are
deliberately *re-implemented* rather than imported: ``repro_torch.core`` cannot
depend on ``repro_torch.cluster``, so ``simulate_job`` cannot be a wrapper over
this engine without inverting the layering — the bit-for-bit equivalence
test is the drift guard that pins the two copies together.
"""

from __future__ import annotations

import heapq
import random
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Mapping

import numpy as np

from repro_torch.core.hadoop.simulator import SimConfig, _duration
from repro_torch.core.hadoop.params import HadoopParams
from repro_torch.obs import current as _obs_current
from repro_torch.obs import percentile_interp

from .network import Topology, flow_rates
from .workload import WorkloadTrace, task_costs

__all__ = [
    "NodeClass",
    "ClusterConfig",
    "ClusterTaskRecord",
    "JobStats",
    "WorkloadResult",
    "simulate_workload",
]

_INF = float("inf")
_EPS = 1e-9
_MAX_EVENTS = 5_000_000    # reclaim-storm bail-out (see the event loop)

_SCHEDULERS = ("fifo", "fair", "fair_preempt", "capacity")


@dataclass(frozen=True)
class NodeClass:
    """One hardware class of a mixed fleet: ``count`` nodes whose compute
    runs ``speedup`` times faster than the baseline (network is shared).

    ``hourly_price`` and ``spot`` are the :mod:`repro_torch.cloud` pricing
    dimension: a node's capacity costs ``hourly_price`` dollars per online
    hour, and ``spot`` marks reclaimable (interruptible) capacity — a spot
    node is periodically reclaimed by the provider (exponential inter-
    reclaim times at the elastic fleet's ``reclaim_rate``) and replaced
    after the provisioning latency.  Both default to the pre-cloud
    behaviour: free, never reclaimed."""

    count: int
    speedup: float = 1.0
    hourly_price: float = 0.0
    spot: bool = False

    def __post_init__(self):
        if self.count < 0:
            raise ValueError(f"node class count must be >= 0, got {self.count}")
        if self.speedup <= 0:
            raise ValueError(f"node speedup must be positive, got {self.speedup}")
        if self.hourly_price < 0:
            raise ValueError(
                f"node hourly_price must be >= 0, got {self.hourly_price}")


@dataclass(frozen=True)
class ClusterConfig:
    """The capacity-planner's knobs: the shared cluster's shape + policy.

    ``node_classes`` describes a heterogeneous fleet; when empty the fleet
    is ``num_nodes`` baseline (speedup 1.0) nodes.  When given,
    ``num_nodes`` is derived from the class counts, so the rest of the
    code has a single source for the fleet size.
    """

    num_nodes: int = 4
    map_slots_per_node: int = 2
    reduce_slots_per_node: int = 2
    scheduler: str = "fifo"              # "fifo"|"fair"|"fair_preempt"|"capacity"
    reduce_slowstart: float = 0.05       # pReduceSlowstart, cluster-wide
    node_classes: tuple[NodeClass, ...] = ()
    preempt_timeout: float = 0.0         # grace s before an over-share kill
    capacities: tuple[tuple[str, float], ...] = ()   # class name -> rel. weight
    #: rack-structured network (:class:`repro_torch.cluster.network.Topology`).
    #: ``None`` or :meth:`Topology.flat` is the paper's flat pipe: shuffle
    #: transfers run at the nominal rate with no contention, reproducing
    #: the pre-topology simulator bit-for-bit (regression-gated).  A
    #: contended topology schedules each reduce's transfer as a flow and
    #: max-min fair-shares the links on every flow start/finish.
    topology: Topology | None = None

    def __post_init__(self):
        if self.scheduler not in _SCHEDULERS:
            raise ValueError(f"unknown scheduler: {self.scheduler!r}")
        if self.preempt_timeout < 0:
            raise ValueError("preempt_timeout must be >= 0")
        if isinstance(self.capacities, Mapping):
            object.__setattr__(
                self, "capacities", tuple(sorted(self.capacities.items())))
        if self.node_classes:
            object.__setattr__(
                self, "num_nodes", sum(nc.count for nc in self.node_classes))

    @property
    def preemptive(self) -> bool:
        return self.scheduler in ("fair_preempt", "capacity")

    def node_table(self) -> list[tuple[float, bool, float, int]]:
        """Per-node ``(speedup, spot, hourly_price, class_index)`` rows,
        fastest class first — the node order :meth:`node_speeds`, the
        free-slot picker, and the wave model's class columns all share.
        Equal-speed classes keep their declared order (stable sort), which
        is how a (spot, on-demand) pair maps onto wave class columns."""
        if not self.node_classes:
            return [(1.0, False, 0.0, 0)] * max(1, self.num_nodes)
        rows: list[tuple[float, bool, float, int]] = []
        for ci, nc in enumerate(sorted(self.node_classes,
                                       key=lambda c: -c.speedup)):
            rows.extend([(nc.speedup, nc.spot, nc.hourly_price, ci)] * nc.count)
        return rows or [(1.0, False, 0.0, 0)]

    def node_speeds(self) -> list[float]:
        """Per-node compute speed factors, fastest class first (the order
        the free-slot picker and the wave model's class columns both use)."""
        return [row[0] for row in self.node_table()]

    @classmethod
    def from_params(cls, p: HadoopParams, *, scheduler: str = "fifo"
                    ) -> "ClusterConfig":
        return cls(num_nodes=p.pNumNodes,
                   map_slots_per_node=p.pMaxMapsPerNode,
                   reduce_slots_per_node=p.pMaxRedPerNode,
                   scheduler=scheduler,
                   reduce_slowstart=p.pReduceSlowstart)


@dataclass
class ClusterTaskRecord:
    job_id: int
    kind: str               # "map" | "reduce"
    index: int
    node: int
    start: float
    end: float
    speculative: bool = False
    killed: bool = False
    #: reduces only: when the task's own work began — the later of its
    #: network transfer finishing and its job's maps finishing.  The trace
    #: renderer (repro_torch.obs.destrace) draws [start, shuffle_end] as the
    #: overlapped "network" phase.  0.0 for maps and killed tasks.
    shuffle_end: float = 0.0
    #: why a killed record died:
    #: "preempt" | "failure" | "superseded" | "reclaim" (spot reclamation —
    #: unlike "failure" the node returns after the provisioning latency).
    kill_reason: str = ""


@dataclass
class JobStats:
    """Per-job service accounting on the shared cluster."""

    job_id: int
    name: str
    submit_time: float
    first_launch: float = _INF   # first task launch (queueing delay ends)
    map_finish: float = _INF
    finish: float = _INF
    n_maps: int = 0
    n_reduces: int = 0

    @property
    def queueing_delay(self) -> float:
        return self.first_launch - self.submit_time

    @property
    def latency(self) -> float:
        """Submit -> last task done (the planner's per-job cost)."""
        return self.finish - self.submit_time

    @property
    def makespan(self) -> float:
        """First launch -> last task done (the single-job notion)."""
        return self.finish - self.first_launch


@dataclass
class WorkloadResult:
    jobs: list[JobStats]
    makespan: float                       # absolute time of the last finish
    node_busy_s: list[float] = field(default_factory=list)
    slot_utilization: float = 0.0
    num_speculative_launched: int = 0
    num_speculative_won: int = 0
    num_failure_reruns: int = 0
    num_preempted: int = 0
    #: tasks killed + completed map outputs lost to spot reclamations
    #: (the elastic-fleet sibling of ``num_failure_reruns``)
    num_reclaimed: int = 0
    #: jobs whose ``finish`` is still inf when the event queue drained (e.g.
    #: every node failed) — latency aggregates are inf then, and this count
    #: is the explicit signal consumers must check instead of discovering
    #: the inf downstream.
    n_unfinished: int = 0
    records: list[ClusterTaskRecord] = field(default_factory=list)
    #: per-node ``[(online_from, online_to), ...]`` capacity episodes: base
    #: nodes open at t=0; failure/reclaim/autoscaler-teardown closes an
    #: episode, replacement/provisioning opens a new one.  This is the
    #: billing input (:func:`repro_torch.cloud.bill_workload`) and the slot-
    #: utilization denominator.
    node_online: list[list[tuple[float, float]]] = field(default_factory=list)

    def latencies(self) -> np.ndarray:
        return np.asarray([j.latency for j in self.jobs])

    @property
    def mean_latency(self) -> float:
        return float(self.latencies().mean()) if self.jobs else 0.0

    def latency_quantile(self, q: float) -> float:
        """Linear-interpolated latency quantile (``q`` in [0, 100]) — the
        repo's single percentile rule (:func:`repro_torch.obs.percentile_interp`),
        shared with the wave model's ``latency_quantile``.  inf when any
        job never finished: interpolating between infs would yield nan, so
        the unfinished workload is reported as an explicit inf instead."""
        if not self.jobs:
            return 0.0
        lat = self.latencies()
        if not np.isfinite(lat).all():
            return _INF
        return float(percentile_interp(np.sort(lat).tolist(), q))

    @property
    def p95_latency(self) -> float:
        return self.latency_quantile(95.0)


class _Job:
    """Mutable per-job scheduler state (single-job simulator state, tagged)."""

    __slots__ = (
        "jid", "name", "submit", "n_maps", "n_reds", "map_cost", "red_cost",
        "shuffle", "arrived", "pending_maps", "pending_reduces",
        "completed_maps", "completed_reduces", "map_output_node",
        "map_copies", "red_copies", "finished_map_durs", "finished_red_durs",
        "reducers_launched", "running_maps", "running_reds", "stats",
    )

    def __init__(self, jid: int, arrival, num_nodes: int):
        jc = arrival.klass
        self.jid = jid
        self.name = jc.name
        self.submit = arrival.submit_time
        self.n_maps = jc.n_maps
        self.n_reds = jc.n_reduces
        self.map_cost, self.red_cost, self.shuffle = task_costs(
            jc, num_nodes=num_nodes)
        self.arrived = False
        self.pending_maps = deque(range(self.n_maps))
        self.pending_reduces = deque(range(self.n_reds))
        self.completed_maps: set[int] = set()
        self.completed_reduces: set[int] = set()
        self.map_output_node: dict[int, int] = {}
        self.map_copies: dict[int, list[int]] = {}
        self.red_copies: dict[int, list[int]] = {}
        self.finished_map_durs: list[float] = []
        self.finished_red_durs: list[float] = []
        self.reducers_launched = self.n_maps == 0   # no maps -> no slowstart
        self.running_maps = 0
        self.running_reds = 0
        self.stats = JobStats(jid, self.name, self.submit,
                              n_maps=self.n_maps, n_reduces=self.n_reds)

    def maps_done(self) -> bool:
        return len(self.completed_maps) == self.n_maps

    def done(self) -> bool:
        return (self.maps_done()
                and len(self.completed_reduces) == self.n_reds)

    def running(self, kind: str) -> int:
        return self.running_maps if kind == "map" else self.running_reds

    def pending(self, kind: str) -> deque:
        return self.pending_maps if kind == "map" else self.pending_reduces

    def demands(self, kind: str) -> bool:
        """Arrived and holds or wants a ``kind`` slot (the share divisor)."""
        if not self.arrived:
            return False
        if kind == "map":
            return bool(self.pending_maps) or self.running_maps > 0
        return ((self.reducers_launched and bool(self.pending_reduces))
                or self.running_reds > 0)


def simulate_workload(
    trace: WorkloadTrace,
    cluster: ClusterConfig = ClusterConfig(),
    sim: SimConfig = SimConfig(),
    elastic=None,
) -> WorkloadResult:
    """Run a workload trace on a shared virtual cluster.

    ``elastic`` adds the :mod:`repro_torch.cloud` provisioning lifecycle.  It is
    duck-typed (``repro_torch.cluster`` must not depend on ``repro_torch.cloud``):
    anything with the :class:`repro_torch.cloud.ElasticFleet` attributes —
    ``policy_code`` (0 off / 1 queue-depth / 2 predicted-load),
    ``max_extra_nodes``, ``high_water``, ``provision_latency``,
    ``reclaim_rate`` (spot reclaims per node-second) and ``seed`` — works.
    Spot nodes (``NodeClass.spot``) are reclaimed at exponential intervals
    (kill + requeue with ``kill_reason="reclaim"``, lost map outputs
    re-executed, exactly the failure machinery) and replaced after the
    provisioning latency; autoscaled extra nodes clone the baseline
    (slowest) class and come online/offline as the policy demands.  The
    per-node capacity episodes land in ``WorkloadResult.node_online``.
    """
    _t_wall = time.perf_counter()
    rng = random.Random(sim.seed)

    # elastic-fleet knobs (absent -> the fixed-fleet fast path: no extra
    # nodes, no reclaim events, and the reclaim RNG stream is never drawn,
    # keeping fixed-fleet runs bit-identical to the pre-cloud simulator)
    el_policy = int(getattr(elastic, "policy_code", 0)) if elastic else 0
    el_extra = (int(getattr(elastic, "max_extra_nodes", 0))
                if elastic is not None and el_policy > 0 else 0)
    el_high = float(getattr(elastic, "high_water", 0.0)) if elastic else 0.0
    el_lat = (float(getattr(elastic, "provision_latency", 0.0))
              if elastic is not None else 0.0)
    el_rate = (float(getattr(elastic, "reclaim_rate", 0.0))
               if elastic is not None else 0.0)
    el_seed = int(getattr(elastic, "seed", 0)) if elastic else 0

    n_base = max(1, cluster.num_nodes)
    n_nodes = n_base + el_extra
    table = cluster.node_table()
    if len(table) != n_base:       # num_nodes floor for degenerate configs
        table = (table + [(1.0, False, 0.0, 0)] * n_base)[:n_base]
    # autoscaled nodes clone the baseline (slowest) class's speed and bill
    # as on-demand capacity: elastic top-up is never reclaimable
    base_speed, _, _, base_cls = table[-1]
    table = table + [(base_speed, False, 0.0, base_cls)] * el_extra
    speed = [row[0] for row in table]
    spot = [row[1] for row in table]
    cls_idx = [row[3] for row in table]
    is_extra = [nd >= n_base for nd in range(n_nodes)]

    map_slots = [cluster.map_slots_per_node] * n_base + [0] * el_extra
    red_slots = [cluster.reduce_slots_per_node] * n_base + [0] * el_extra
    # configured capacity per node (map_slots/red_slots are *free* counts);
    # zeroed when a node fails, so shares and utilization see live capacity
    cap_map = list(map_slots)
    cap_red = list(red_slots)
    fail_time = [_INF] * n_nodes
    # capacity episodes: base nodes online from t=0, extras offline until
    # provisioned.  Closed on failure/reclaim/teardown, reopened on
    # replacement/provisioning; the summary closes live episodes at span.
    online_from: list[float | None] = [0.0] * n_base + [None] * el_extra
    node_online: list[list[tuple[float, float]]] = [[] for _ in range(n_nodes)]
    # reclaim draws come from their own stream so a priced-but-stable fleet
    # replays the exact task-duration draw sequence of the fixed fleet
    rng_reclaim = random.Random((el_seed + 1) * 1_000_003 + sim.seed * 7919)
    reclaiming = el_rate > 0 and any(spot)
    scaling = el_policy > 0 and el_extra > 0
    policy = cluster.scheduler
    fair = policy in ("fair", "fair_preempt")
    capacity = policy == "capacity"

    jobs = [_Job(a.job_id, a, n_nodes) for a in trace.arrivals]
    by_id = {j.jid: j for j in jobs}
    res = WorkloadResult(jobs=[j.stats for j in jobs], makespan=0.0)

    # ---- DAG dependencies: a job with deps is held until released ----
    # dep edges ((parent_job_id, "barrier"|"slowstart") on JobArrival.deps)
    # gate a job's arrival: "barrier" releases when the parent finishes,
    # "slowstart" when the parent's map phase completes (its reduce wave —
    # the child's input producer in a pipelined Hive/Pig plan — is already
    # launched then, mirroring reduce_slowstart's map/shuffle overlap one
    # level up).  The released job re-arrives at the release time, which
    # becomes its submit time for queueing/latency accounting.
    dep_children: dict[int, list[tuple[int, str]]] = {}
    dep_count: dict[int, int] = {}
    for a in trace.arrivals:
        for parent_id, edge_kind in getattr(a, "deps", ()):
            if edge_kind not in ("barrier", "slowstart"):
                raise ValueError(f"unknown DAG edge kind: {edge_kind!r}")
            if parent_id not in by_id or parent_id == a.job_id:
                raise ValueError(
                    f"job {a.job_id} depends on unknown job {parent_id}")
            dep_children.setdefault(parent_id, []).append((a.job_id, edge_kind))
            dep_count[a.job_id] = dep_count.get(a.job_id, 0) + 1
    fired_edges: set[tuple[int, int, str]] = set()

    def release_children(parent_jid: int, now: float, edge_kind: str) -> None:
        for child_jid, k in dep_children.get(parent_jid, ()):
            if k != edge_kind or (parent_jid, child_jid, k) in fired_edges:
                continue
            fired_edges.add((parent_jid, child_jid, k))
            dep_count[child_jid] -= 1
            if dep_count[child_jid] == 0:
                child = by_id[child_jid]
                t_rel = max(child.submit, now)
                child.submit = t_rel
                child.stats.submit_time = t_rel
                push(t_rel, 1, "arrive", child_jid)

    # ---- topology-aware shuffle (contended racks only) ----
    # With a contended ClusterConfig.topology every reduce's transfer is a
    # flow: `flows[uid] = [remaining nominal seconds, dst node, rate]`, and
    # rates are recomputed as the max-min fair share on every flow start /
    # finish / kill.  Completion events are invalidated by comparing the
    # popped time against flow_end (the same lazy-invalidation trick the
    # rescheduled-reduce guard uses).  Flat/absent topologies never touch
    # any of this, keeping the seed code paths (and results) bit-for-bit.
    topo = cluster.topology
    contended = topo is not None and not topo.is_flat
    flows: dict[int, list] = {}
    flow_end: dict[int, float] = {}   # uid -> currently scheduled finish
    flow_done: dict[int, float] = {}  # uid -> actual transfer finish time
    flows_at = 0.0                    # clock of the last rate update

    def update_flows(now: float) -> None:
        nonlocal flows_at
        dt = now - flows_at
        if dt > 0.0:
            for f in flows.values():
                f[0] = max(f[0] - f[2] * dt, 0.0)
        flows_at = now

    def reassign_flows(now: float) -> None:
        rates = flow_rates(topo, [f[1] for f in flows.values()], n_nodes)
        for (fuid, f), rate in zip(flows.items(), rates):
            f[2] = rate
            end = now + f[0] / rate
            flow_end[fuid] = end
            push(end, 2, "flow", fuid)

    def start_flow(uid: int, node: int, nominal: float, now: float) -> None:
        update_flows(now)
        flows[uid] = [nominal, node, 1.0]
        reassign_flows(now)

    def drop_flow(uid: int, now: float) -> None:
        """Forget a killed/finished transfer; survivors speed up."""
        flow_done.pop(uid, None)
        if uid in flows:
            update_flows(now)
            del flows[uid]
            flow_end.pop(uid, None)
            reassign_flows(now)

    # capacity queues: one per job-class name; guaranteed share = the
    # class's weight (ClusterConfig.capacities, default 1.0) normalized
    # over the classes present in this trace.
    queue_names = sorted({j.name for j in jobs})
    cap_weights = dict(cluster.capacities)
    w_total = sum(cap_weights.get(q, 1.0) for q in queue_names) or 1.0
    guarantee_frac = {q: cap_weights.get(q, 1.0) / w_total for q in queue_names}

    # running[uid] = (jid, kind, index, node, start, end, speculative)
    running: dict[int, tuple] = {}
    reduce_durs: dict[int, tuple[float, float]] = {}   # uid -> (shuffle, work)
    uid_counter = 0
    seq_counter = 0
    clock = 0.0

    # Event heap: (time, order_class, seq, tag, payload).  order_class makes
    # simultaneous events deterministic: failures first, then arrivals, then
    # task completions (matching the single-job simulator, which applies a
    # failure before any completion at the same timestamp), then preemption
    # checks (a completion at the same instant may resolve the starvation).
    events: list[tuple] = []

    def push(time: float, order_class: int, tag: str, payload: int) -> None:
        nonlocal seq_counter
        heapq.heappush(events, (time, order_class, seq_counter, tag, payload))
        seq_counter += 1

    for ftime, fnode in sorted(sim.node_failures):
        push(ftime, 0, "fail", fnode)
    for j in jobs:
        if dep_count.get(j.jid, 0) == 0:      # DAG children wait for release
            push(j.submit, 1, "arrive", j.jid)
    if reclaiming:
        for nd in range(n_base):
            if spot[nd]:
                push(rng_reclaim.expovariate(el_rate), 0, "reclaim", nd)
    # predicted-load policy: the fleet-sizing decision is made up front
    # (from the closed-form model), so the extra capacity is requested the
    # moment the workload starts and lands one provisioning latency later
    extra_online = False
    extra_pending = False
    if scaling and el_policy == 2 and jobs:
        extra_pending = True
        push(min(j.submit for j in jobs) + el_lat, 1, "provision", 0)

    def workload_done() -> bool:
        return all(j.stats.finish != _INF for j in jobs)

    def set_offline(nd: int, now: float) -> None:
        if online_from[nd] is not None:
            node_online[nd].append((online_from[nd], now))
            online_from[nd] = None

    def free_slot(slots: list[int], prefer_not: int = -1) -> int:
        # fastest class first, then base fleet before autoscaled extras
        # (extras drain first, so teardown can catch them idle), then class
        # declaration order for equal-speed classes (spot before on-demand
        # in a cloud fleet), then the homogeneous tie-break: most free
        # slots, then node index.  This is the wave model's class-ordered
        # allocation rule — what keeps the two simulators in agreement on
        # contention-free cases.
        order = sorted(range(n_nodes),
                       key=lambda nd: (nd == prefer_not, -speed[nd],
                                       is_extra[nd], cls_idx[nd], -slots[nd]))
        for nd in order:
            if slots[nd] > 0:
                return nd
        return -1

    def launch(job: _Job, kind: str, index: int, now: float, *,
               speculative: bool = False, avoid_node: int = -1) -> bool:
        nonlocal uid_counter
        slots = map_slots if kind == "map" else red_slots
        node = free_slot(slots, prefer_not=avoid_node)
        if node < 0:
            return False
        slots[node] -= 1
        uid = uid_counter
        uid_counter += 1
        job.stats.first_launch = min(job.stats.first_launch, now)
        if kind == "map":
            dur = _duration(job.map_cost, rng, sim) / speed[node]
            end = now + dur
            running[uid] = (job.jid, kind, index, node, now, end, speculative)
            job.map_copies.setdefault(index, []).append(uid)
            job.running_maps += 1
            push(end, 2, "task", uid)
        else:
            # shuffle is network-bound (not node-scaled); the sort/reduce/
            # write work runs on the node's cores and scales with its class
            sh = _duration(job.shuffle, rng, sim) if job.shuffle > 0 else 0.0
            wk = (_duration(job.red_cost, rng, sim) / speed[node]
                  if job.red_cost > 0 else 0.0)
            reduce_durs[uid] = (sh, wk)
            job.red_copies.setdefault(index, []).append(uid)
            job.running_reds += 1
            if contended and sh > 0.0:
                # the transfer is a flow on the topology: its completion
                # arrives via a "flow" event at a fair-share-dependent time
                running[uid] = (job.jid, kind, index, node, now, _INF, speculative)
                start_flow(uid, node, sh, now)
            elif job.maps_done():
                end = now + sh + wk
                running[uid] = (job.jid, kind, index, node, now, end, speculative)
                push(end, 2, "task", uid)
            else:
                # Shuffle overlaps the job's maps; completion scheduled when
                # its last map output lands.
                running[uid] = (job.jid, kind, index, node, now, _INF, speculative)
        if speculative:
            res.num_speculative_launched += 1
        return True

    def schedule_waiting_reduces(job: _Job, now: float) -> None:
        for uid, (jid, kind, index, node, start, end, spec) in list(running.items()):
            if jid == job.jid and kind == "reduce" and end == _INF:
                if uid in flows:
                    continue    # transfer still in flight; its flow event resolves
                sh, wk = reduce_durs[uid]
                sh_done = flow_done[uid] if uid in flow_done else start + sh
                new_end = max(now, sh_done) + wk
                running[uid] = (jid, kind, index, node, start, new_end, spec)
                push(new_end, 2, "task", uid)

    # ---------------- scheduling policy ----------------

    def queue_running(kind: str) -> dict[str, int]:
        out = {q: 0 for q in queue_names}
        for j in jobs:
            out[j.name] += j.running(kind)
        return out

    def kind_capacity(kind: str) -> int:
        return sum(cap_map) if kind == "map" else sum(cap_red)

    def pick_job(kind: str):
        """The job the next free ``kind`` slot goes to, or None."""
        qrun = queue_running(kind) if capacity else None
        cap = kind_capacity(kind) if capacity else 0
        best = None
        best_key = None
        for j in jobs:
            if not j.arrived:
                continue
            if kind == "map":
                if not j.pending_maps:
                    continue
                load = j.running_maps
            else:
                if not (j.reducers_launched and j.pending_reduces):
                    continue
                load = j.running_reds
            if capacity:
                # queues furthest below their guaranteed share first,
                # FIFO within a queue (Hadoop CapacityScheduler ordering)
                guar = max(guarantee_frac[j.name] * cap, _EPS)
                key = (qrun[j.name] / guar, j.submit, j.jid)
            elif fair:
                # fair = equal per-job shares of each pool (JobClass.weight
                # is arrival frequency, not a scheduling share — the vector
                # model splits the same way, so evaluate() and exact_cost()
                # agree on what "fair" means)
                key = (load, j.submit, j.jid)
            else:
                key = (j.submit, j.jid)
            if best_key is None or key < best_key:
                best, best_key = j, key
        return best

    def fill_slots(now: float) -> None:
        for kind, slots in (("map", map_slots), ("reduce", red_slots)):
            while sum(slots) > 0:
                j = pick_job(kind)
                if j is None:
                    break
                pend = j.pending_maps if kind == "map" else j.pending_reduces
                if not launch(j, kind, pend[0], now):
                    break
                pend.popleft()

    # ---------------- autoscaler (elastic fleets) ----------------

    def unmet_demand() -> int:
        """Queued tasks the cluster has no slot for right now — pending maps
        of arrived jobs plus pending reduces past slowstart (the wave
        model's trigger signal, evaluated at the same post-allocation
        points, which is what lets the two simulators agree on *when* the
        autoscaler acts)."""
        q = 0
        for j in jobs:
            if not j.arrived:
                continue
            q += len(j.pending_maps)
            if j.reducers_launched:
                q += len(j.pending_reduces)
        return q

    def autoscale_check(now: float) -> None:
        nonlocal extra_online, extra_pending
        if not scaling:
            return
        q = unmet_demand()
        if (el_policy == 1 and not extra_online and not extra_pending
                and q > el_high + _EPS):
            extra_pending = True
            push(now + el_lat, 1, "provision", 0)
        if extra_online and q == 0 and all(
                map_slots[nd] == cap_map[nd] and red_slots[nd] == cap_red[nd]
                for nd in range(n_base, n_nodes)):
            # nothing queued and every extra node idle: release the block
            # (one billing episode per provision/teardown cycle)
            for nd in range(n_base, n_nodes):
                set_offline(nd, now)
                map_slots[nd] = red_slots[nd] = 0
                cap_map[nd] = cap_red[nd] = 0
            extra_online = False

    def maybe_speculate(now: float) -> None:
        if not sim.speculative_execution:
            return
        for uid, (jid, kind, index, node, start, end, spec) in list(running.items()):
            if spec or end == _INF:
                continue
            j = by_id[jid]
            if kind == "map":
                durs, completed, copies = (j.finished_map_durs,
                                           j.completed_maps, j.map_copies)
            else:
                if not j.maps_done():    # stalled shuffle != straggler
                    continue
                durs, completed, copies = (j.finished_red_durs,
                                           j.completed_reduces, j.red_copies)
            if len(durs) < sim.speculative_min_completed:
                continue
            if index in completed or len(copies.get(index, [])) > 1:
                continue
            mean = sum(durs) / len(durs)
            # reduces measure from the job's map finish: shuffle stall is
            # waiting, not work (mirrors the single-job simulator)
            eff_start = start if kind == "map" \
                else max(start, j.stats.map_finish)
            projected = end - eff_start
            if projected > sim.speculative_slowdown_thr * mean and now > eff_start:
                launch(j, kind, index, now, speculative=True, avoid_node=node)

    # ---------------- preemption (fair_preempt / capacity) ----------------

    # starved_since[kind]: when the current starvation episode began, or
    # None.  A "preempt" event is scheduled episode-start + timeout; kills
    # only happen if the episode is still live when it fires.
    starved_since: dict[str, float | None] = {"map": None, "reduce": None}
    _KIND_ID = {"map": 0, "reduce": 1}
    _ID_KIND = {0: "map", 1: "reduce"}

    def fair_floor(kind: str) -> int:
        n_demand = sum(1 for j in jobs if j.demands(kind))
        return kind_capacity(kind) // n_demand if n_demand else 0

    def starved_entities(kind: str) -> bool:
        """Is any demanding entity below its floor share with work queued?"""
        if capacity:
            qrun = queue_running(kind)
            cap = kind_capacity(kind)
            for q in queue_names:
                floor_q = int(guarantee_frac[q] * cap)
                if qrun[q] >= floor_q:
                    continue
                for j in jobs:
                    if j.name == q and j.arrived and j.pending(kind) and (
                            kind == "map" or j.reducers_launched):
                        return True
            return False
        floor = fair_floor(kind)
        for j in jobs:
            if not (j.arrived and j.pending(kind)):
                continue
            if kind == "reduce" and not j.reducers_launched:
                continue
            if j.running(kind) < floor:
                return True
        return False

    def pick_victim(kind: str) -> int | None:
        """The uid to kill: newest task (speculative copies first) of the
        entity furthest over its floor share / guarantee."""
        if capacity:
            qrun = queue_running(kind)
            cap = kind_capacity(kind)
            over = {q: qrun[q] - int(guarantee_frac[q] * cap)
                    for q in queue_names}
            victim_q = max((q for q in queue_names if over[q] > 0),
                           key=lambda q: (over[q], q), default=None)
            if victim_q is None:
                return None
            member = lambda jid: by_id[jid].name == victim_q
        else:
            floor = fair_floor(kind)
            over_jobs = [j for j in jobs if j.running(kind) > floor]
            if not over_jobs:
                return None
            victim_j = max(over_jobs,
                           key=lambda j: (j.running(kind) - floor, -j.jid))
            member = lambda jid: jid == victim_j.jid
        best_uid, best_key = None, None
        for uid, (jid, k, index, node, start, end, spec) in running.items():
            if k != kind or not member(jid):
                continue
            key = (spec, start, uid)     # speculative first, then newest
            if best_key is None or key > best_key:
                best_uid, best_key = uid, key
        return best_uid

    def kill_task(uid: int, now: float) -> None:
        jid, kind, index, node, start, end, spec = running.pop(uid)
        j = by_id[jid]
        (map_slots if kind == "map" else red_slots)[node] += 1
        copies = j.map_copies if kind == "map" else j.red_copies
        if uid in copies.get(index, []):
            copies[index].remove(uid)
        if kind == "map":
            j.running_maps -= 1
            completed, pending = j.completed_maps, j.pending_maps
        else:
            j.running_reds -= 1
            completed, pending = j.completed_reduces, j.pending_reduces
            reduce_durs.pop(uid, None)
            drop_flow(uid, now)
        res.records.append(
            ClusterTaskRecord(jid, kind, index, node, start, now, spec,
                              killed=True, kill_reason="preempt"))
        alive_copies = any(c in running for c in copies.get(index, []))
        if index not in completed and index not in pending and not alive_copies:
            pending.append(index)

    def do_preempt(kind: str, now: float) -> None:
        while starved_entities(kind):
            uid = pick_victim(kind)
            if uid is None:
                break
            kill_task(uid, now)
            res.num_preempted += 1
            fill_slots(now)       # pick_job hands the slot to the starved job

    def check_preempt(now: float) -> None:
        if not cluster.preemptive:
            return
        for kind in ("map", "reduce"):
            if starved_entities(kind) and pick_victim(kind) is not None:
                if starved_since[kind] is None:
                    starved_since[kind] = now
                    push(now + cluster.preempt_timeout, 3, "preempt",
                         _KIND_ID[kind])
            else:
                starved_since[kind] = None

    # ---------------- failures / spot reclamations ----------------

    def evict_node(enode: int, etime: float, reason: str) -> int:
        """Take a node out of service: kill its running tasks (requeued,
        recorded with ``kill_reason=reason``), resurrect completed map
        outputs unfinished jobs still need, zero its capacity and close its
        online episode.  Returns the number of tasks + outputs affected."""
        n_lost = 0
        for uid, (jid, kind, index, node, start, end, spec) in list(running.items()):
            if node != enode:
                continue
            del running[uid]
            j = by_id[jid]
            copies = j.map_copies if kind == "map" else j.red_copies
            if uid in copies.get(index, []):
                copies[index].remove(uid)
            if kind == "map":
                j.running_maps -= 1
                if index not in j.completed_maps and index not in j.pending_maps:
                    j.pending_maps.append(index)
            else:
                j.running_reds -= 1
                reduce_durs.pop(uid, None)      # killed copy: drop its draws
                drop_flow(uid, etime)
                if (index not in j.completed_reduces
                        and index not in j.pending_reduces):
                    j.pending_reduces.append(index)
            res.records.append(
                ClusterTaskRecord(jid, kind, index, node, start, etime,
                                  spec, killed=True, kill_reason=reason))
            n_lost += 1
        # Completed map outputs on the evicted node are lost for every job
        # whose reducers still need them.
        for j in jobs:
            if len(j.completed_reduces) >= j.n_reds:
                continue
            for midx, mnode in list(j.map_output_node.items()):
                if mnode == enode and midx in j.completed_maps:
                    j.completed_maps.discard(midx)
                    del j.map_output_node[midx]
                    if midx not in j.pending_maps:
                        j.pending_maps.append(midx)
                    n_lost += 1
        map_slots[enode] = 0
        red_slots[enode] = 0
        cap_map[enode] = 0
        cap_red[enode] = 0
        set_offline(enode, etime)
        return n_lost

    def fail_node(fnode: int, ftime: float) -> None:
        res.num_failure_reruns += evict_node(fnode, ftime, "failure")
        fail_time[fnode] = min(fail_time[fnode], ftime)

    def finish_job(job: _Job, now: float) -> None:
        if job.done() and not job.pending_maps and not job.pending_reduces:
            job.stats.finish = now
            # slowstart edges release here too (idempotent) so a parent that
            # never reports a map-phase transition still frees its children
            release_children(job.jid, now, "slowstart")
            release_children(job.jid, now, "barrier")

    # ---------------- event loop ----------------

    n_popped = 0
    while events:
        if n_popped >= _MAX_EVENTS:
            # pathological elastic configs (a reclaim rate so high tasks
            # never survive an online window) would cycle reclaim/replace
            # events forever — bail and let n_unfinished flag the run
            break
        n_popped += 1
        t, oc, _seq, tag, payload = heapq.heappop(events)
        clock = max(clock, t)

        if tag == "fail":
            fail_node(payload, t)
            fill_slots(clock)
            check_preempt(clock)
            autoscale_check(clock)
            continue

        if tag == "arrive":
            by_id[payload].arrived = True
            fill_slots(clock)
            check_preempt(clock)
            autoscale_check(clock)
            continue

        if tag == "reclaim":
            nd = payload
            if (workload_done() or online_from[nd] is None
                    or fail_time[nd] != _INF):
                continue                 # node already gone, or nothing left
            res.num_reclaimed += evict_node(nd, t, "reclaim")
            push(t + el_lat, 1, "replace", nd)
            fill_slots(clock)
            check_preempt(clock)
            autoscale_check(clock)
            continue

        if tag == "replace":
            nd = payload
            if workload_done() or fail_time[nd] != _INF:
                continue                 # nobody pays for capacity after
            map_slots[nd] = cap_map[nd] = cluster.map_slots_per_node
            red_slots[nd] = cap_red[nd] = cluster.reduce_slots_per_node
            online_from[nd] = t
            push(t + rng_reclaim.expovariate(el_rate), 0, "reclaim", nd)
            fill_slots(clock)
            check_preempt(clock)
            autoscale_check(clock)
            continue

        if tag == "provision":
            extra_pending = False
            if workload_done():
                continue
            extra_online = True
            for nd in range(n_base, n_nodes):
                map_slots[nd] = cap_map[nd] = cluster.map_slots_per_node
                red_slots[nd] = cap_red[nd] = cluster.reduce_slots_per_node
                online_from[nd] = t
            fill_slots(clock)
            check_preempt(clock)
            autoscale_check(clock)
            continue

        if tag == "preempt":
            kind = _ID_KIND[payload]
            since = starved_since[kind]
            if since is not None and t >= since + cluster.preempt_timeout - _EPS:
                do_preempt(kind, clock)
                starved_since[kind] = None
                check_preempt(clock)     # re-arm if still starved
            continue

        if tag == "flow":
            uid = payload
            if uid not in flows or flow_end.get(uid) != t:
                continue                 # flow killed or rates rescheduled it
            update_flows(t)
            del flows[uid]
            flow_end.pop(uid, None)
            flow_done[uid] = t
            reassign_flows(clock)        # survivors speed up
            jid, kind, index, node, start, end, spec = running[uid]
            job = by_id[jid]
            if job.maps_done():
                wk = reduce_durs[uid][1]
                new_end = t + wk
                running[uid] = (jid, kind, index, node, start, new_end, spec)
                push(new_end, 2, "task", uid)
            # else: still stalled on the map fleet; schedule_waiting_reduces
            # picks the task up (from flow_done) when the maps land
            continue

        uid = payload
        if uid not in running:
            continue                     # killed or superseded copy
        if running[uid][5] != t:
            continue                     # reduce end was rescheduled
        jid, kind, index, node, start, end, spec = running[uid]
        job = by_id[jid]
        if kind == "reduce" and not job.maps_done():
            # A failure resurrected map work; stall until it lands again.
            running[uid] = (jid, kind, index, node, start, _INF, spec)
            continue
        del running[uid]
        sh_end = 0.0
        if kind == "reduce":
            # end = work-start + wk, so end - wk is when the overlapped
            # network transfer stopped gating the task
            sh_end = end - reduce_durs.get(uid, (0.0, 0.0))[1]
        res.records.append(
            ClusterTaskRecord(jid, kind, index, node, start, end, spec,
                              shuffle_end=sh_end))

        if kind == "map":
            map_slots[node] += 1
            job.running_maps -= 1
            if index not in job.completed_maps:
                job.completed_maps.add(index)
                job.map_output_node[index] = node
                job.finished_map_durs.append(end - start)
                if spec:
                    res.num_speculative_won += 1
                for sib in job.map_copies.get(index, []):
                    if sib != uid and sib in running:
                        _, k2, i2, n2, s2, e2, sp2 = running.pop(sib)
                        map_slots[n2] += 1
                        job.running_maps -= 1
                        res.records.append(ClusterTaskRecord(
                            jid, k2, i2, n2, s2, clock, sp2, killed=True,
                            kill_reason="superseded"))
                job.map_copies[index] = []
            job.stats.map_finish = (clock if job.maps_done()
                                    else job.stats.map_finish)
            if (not job.reducers_launched and job.n_maps > 0
                    and len(job.completed_maps)
                    >= cluster.reduce_slowstart * job.n_maps):
                job.reducers_launched = True
            fill_slots(clock)
            if job.maps_done() and not job.pending_maps:
                schedule_waiting_reduces(job, clock)
                release_children(job.jid, clock, "slowstart")
            maybe_speculate(clock)
            if job.n_reds == 0:
                finish_job(job, clock)
        else:
            red_slots[node] += 1
            job.running_reds -= 1
            reduce_durs.pop(uid, None)
            flow_done.pop(uid, None)
            if index not in job.completed_reduces:
                job.completed_reduces.add(index)
                # stall-free duration (see maybe_speculate)
                job.finished_red_durs.append(
                    end - max(start, job.stats.map_finish))
                if spec:
                    res.num_speculative_won += 1
                for sib in job.red_copies.get(index, []):
                    if sib != uid and sib in running:
                        _, k2, i2, n2, s2, e2, sp2 = running.pop(sib)
                        red_slots[n2] += 1
                        job.running_reds -= 1
                        reduce_durs.pop(sib, None)
                        drop_flow(sib, clock)
                        res.records.append(ClusterTaskRecord(
                            jid, k2, i2, n2, s2, clock, sp2, killed=True,
                            kill_reason="superseded"))
                job.red_copies[index] = []
            fill_slots(clock)
            maybe_speculate(clock)
            finish_job(job, clock)

        check_preempt(clock)
        autoscale_check(clock)
        res.makespan = max(res.makespan, clock)

    # ---------------- completion / slot-occupancy summary ----------------
    # drift guard for the reduce_durs bookkeeping: an entry must not outlive
    # its running task (entries used to leak for the life of the simulation
    # on every failure-kill and speculative-sibling kill)
    assert set(reduce_durs) == {
        u for u, v in running.items() if v[1] == "reduce"
    }, "reduce_durs leaked entries for dead tasks"
    # flows are reduce transfers in flight: they must not outlive their task
    assert set(flows) <= set(reduce_durs), "flows leaked entries for dead tasks"
    res.n_unfinished = sum(1 for j in jobs if not np.isfinite(j.stats.finish))
    res.node_busy_s = [0.0] * n_nodes
    for rec in res.records:
        res.node_busy_s[rec.node] += rec.end - rec.start
    span = res.makespan
    for nd in range(n_nodes):        # close live capacity episodes at span
        set_offline(nd, span)
    res.node_online = node_online
    # capacity integrated over online time: a failed node only contributes
    # slot-seconds up to its failure, a reclaimed/autoscaled node only over
    # its online episodes (for a fixed fleet this reduces to the previous
    # min(span, fail_time) denominator exactly)
    per_node = cluster.map_slots_per_node + cluster.reduce_slots_per_node
    slot_seconds = sum(
        per_node * sum(max(0.0, min(e, span) - max(s, 0.0))
                       for s, e in node_online[nd])
        for nd in range(n_nodes))
    if slot_seconds > 0:
        res.slot_utilization = sum(res.node_busy_s) / slot_seconds
    ob = _obs_current()
    if ob.enabled:
        reg = ob.registry
        reg.counter("des.runs").inc()
        reg.counter("des.jobs").inc(len(jobs))
        reg.counter("des.tasks").inc(len(res.records))
        reg.counter("des.preempted").inc(res.num_preempted)
        reg.counter("des.failure_reruns").inc(res.num_failure_reruns)
        reg.counter("des.reclaimed").inc(res.num_reclaimed)
        reg.counter("des.speculative_launched").inc(
            res.num_speculative_launched)
        reg.histogram("des.makespan_s").record(res.makespan)
        el_us = (time.perf_counter() - _t_wall) * 1e6
        ob.tracer.complete("des.simulate", ob.tracer.now_us() - el_us, el_us,
                           jobs=len(jobs), scheduler=policy)
    return res
