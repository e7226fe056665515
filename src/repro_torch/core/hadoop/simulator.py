"""Task Scheduler Simulator (paper §5, approach (i)).

The paper offers two ways to compose task-level costs into a job-level cost:
the analytic wave formulas (Eqs. 92-98) and "simulat[ing] the task execution
using a Task Scheduler Simulator ... scheduling and simulating the execution
of individual tasks on a virtual cluster.  The cost for each task is
calculated using the proposed performance models."

This module is that simulator: a discrete-event scheduler over a virtual
cluster of ``pNumNodes`` nodes with ``pMaxMapsPerNode`` map slots and
``pMaxRedPerNode`` reduce slots per node.  Beyond the paper it also models
the mechanisms a production scheduler needs at scale — the same mechanisms
the reference package's runtime mirrors (``repro.runtime.stragglers``):

* **slowstart**      — reducers launch once ``pReduceSlowstart`` of maps done;
* **stragglers**     — per-task multiplicative slowdowns (seeded RNG);
* **speculative execution** — Hadoop-style backup tasks for outlier maps
  *and* reduces (backup reduces are only considered once every map output
  exists, so a shuffle stalled on the map fleet is not mistaken for a
  straggler);
* **node failures**  — at a failure time, running tasks are re-queued and
  *completed map outputs on the failed node are re-executed* (Hadoop
  semantics: map output lives on local disk of the mapper).

Determinism: all randomness comes from a seeded ``random.Random``; repeated
runs with the same seed are bit-identical (tested).

The multi-job cluster simulator (:mod:`repro_torch.cluster.sched`) extends
the same mechanics to a shared cluster of concurrent jobs.
"""

from __future__ import annotations

import heapq
import random
from collections import deque
from dataclasses import dataclass, field

from .params import CostFactors, HadoopParams, ProfileStats
from .ref import job_model

__all__ = ["SimConfig", "SimResult", "TaskRecord", "simulate_job"]


@dataclass(frozen=True)
class SimConfig:
    """Knobs of the virtual cluster beyond the paper's parameters."""

    seed: int = 0
    straggler_prob: float = 0.0          # P(task is a straggler)
    straggler_slowdown: float = 3.0      # straggler duration multiplier
    speculative_execution: bool = True
    speculative_slowdown_thr: float = 1.5  # backup if projected > thr x mean
    speculative_min_completed: int = 3   # need this many finished tasks first
    node_failures: tuple[tuple[float, int], ...] = ()  # (time_s, node_id)
    task_time_jitter: float = 0.0        # +/- uniform fraction on durations


@dataclass
class TaskRecord:
    kind: str               # "map" | "reduce"
    index: int
    node: int
    start: float
    end: float
    speculative: bool = False
    killed: bool = False


@dataclass
class SimResult:
    makespan: float
    map_finish_time: float
    records: list[TaskRecord] = field(default_factory=list)
    num_speculative_launched: int = 0
    num_speculative_won: int = 0
    num_failure_reruns: int = 0
    map_task_cost: float = 0.0
    reduce_task_cost: float = 0.0
    shuffle_time_per_reducer: float = 0.0
    # Per-node seconds a slot was occupied by a task (including killed and
    # speculative copies — the slot was held either way), and the fraction
    # of nominal slot-seconds (makespan x all configured slots) that was
    # busy.  Failed nodes keep their nominal capacity in the denominator.
    node_busy_s: list[float] = field(default_factory=list)
    slot_utilization: float = 0.0


def _duration(base: float, rng: random.Random, sc: SimConfig) -> float:
    d = base
    if sc.task_time_jitter > 0.0:
        d *= 1.0 + rng.uniform(-sc.task_time_jitter, sc.task_time_jitter)
    if sc.straggler_prob > 0.0 and rng.random() < sc.straggler_prob:
        d *= sc.straggler_slowdown
    return max(d, 1e-9)


def simulate_job(
    p: HadoopParams,
    s: ProfileStats,
    c: CostFactors,
    sim: SimConfig = SimConfig(),
) -> SimResult:
    """Simulate one MapReduce job; task costs come from the §2-§4 models."""
    jm = job_model(p, s, c)
    map_cost = jm.map.ioCost + jm.map.cpuCost
    red_cost = jm.reduce.ioCost + jm.reduce.cpuCost if p.pNumReducers else 0.0
    # Per-reducer share of the network transfer (Eqs. 90-91), serialized per
    # reducer: each reducer pulls its partition across the network.  The
    # import is deferred: repro_torch.core cannot depend on
    # repro_torch.cluster at module scope (repro_torch.cluster.sched imports
    # this module), but repro_torch.cluster.network sits below both packages.
    from repro_torch.cluster.network import per_reducer_shuffle

    shuffle_net = per_reducer_shuffle(jm.netCost, p.pNumReducers)

    rng = random.Random(sim.seed)
    res = SimResult(
        makespan=0.0,
        map_finish_time=0.0,
        map_task_cost=map_cost,
        reduce_task_cost=red_cost,
        shuffle_time_per_reducer=shuffle_net,
    )

    n_nodes = max(1, p.pNumNodes)
    map_slots = [p.pMaxMapsPerNode] * n_nodes
    red_slots = [p.pMaxRedPerNode] * n_nodes

    # --- state ---
    # deques: the multi-thousand-task workloads of the cluster layer made
    # the old list-head pops an O(n^2) hotspot
    pending_maps = deque(range(p.pNumMappers))
    completed_maps: set[int] = set()
    map_output_node: dict[int, int] = {}
    running: dict[int, tuple[str, int, int, float, float, bool]] = {}
    # running[task_uid] = (kind, index, node, start, end, speculative)
    # Reduce tasks are two-phase: the shuffle overlaps the map fleet, but
    # sort/reduce/write can only run once ALL map outputs exist.  A reducer
    # launched before the maps finish carries end=+inf until the last map
    # completes, at which point its completion event is scheduled as
    #   end = max(last_map_time, start + shuffle) + work.
    reduce_durs: dict[int, tuple[float, float]] = {}  # uid -> (shuffle, work)
    uid_counter = 0
    # task index -> list of running uids (primary + speculative copies)
    map_copies: dict[int, list[int]] = {}
    red_copies: dict[int, list[int]] = {}
    finished_map_durations: list[float] = []
    finished_red_durations: list[float] = []

    pending_reduces = deque(range(p.pNumReducers))
    reducers_launched = False
    completed_reduces: set[int] = set()

    failures = sorted(sim.node_failures)
    fail_idx = 0

    events: list[tuple[float, int, str, int]] = []  # (time, uid, kind, index)
    clock = 0.0

    def free_slot(slots: list[int], prefer_not: int = -1) -> int:
        order = sorted(range(n_nodes), key=lambda nd: (nd == prefer_not, -slots[nd]))
        for nd in order:
            if slots[nd] > 0:
                return nd
        return -1

    def all_maps_done() -> bool:
        return len(completed_maps) == p.pNumMappers

    def launch(kind: str, index: int, now: float, *, speculative: bool = False,
               avoid_node: int = -1) -> bool:
        nonlocal uid_counter
        slots = map_slots if kind == "map" else red_slots
        node = free_slot(slots, prefer_not=avoid_node)
        if node < 0:
            return False
        slots[node] -= 1
        uid = uid_counter
        uid_counter += 1
        if kind == "map":
            dur = _duration(map_cost, rng, sim)
            end = now + dur
            running[uid] = (kind, index, node, now, end, speculative)
            map_copies.setdefault(index, []).append(uid)
            heapq.heappush(events, (end, uid, kind, index))
        else:
            sh = _duration(shuffle_net, rng, sim) if shuffle_net > 0 else 0.0
            wk = _duration(red_cost, rng, sim) if red_cost > 0 else 0.0
            reduce_durs[uid] = (sh, wk)
            red_copies.setdefault(index, []).append(uid)
            if all_maps_done():
                end = now + sh + wk
                running[uid] = (kind, index, node, now, end, speculative)
                heapq.heappush(events, (end, uid, kind, index))
            else:
                # Shuffle overlaps the maps; completion scheduled later.
                running[uid] = (kind, index, node, now, float("inf"), speculative)
        if speculative:
            res.num_speculative_launched += 1
        return True

    def schedule_waiting_reduces(now: float) -> None:
        """Last map output just landed: schedule stalled reduce completions."""
        for uid, (kind, index, node, start, end, spec) in list(running.items()):
            if kind == "reduce" and end == float("inf"):
                sh, wk = reduce_durs[uid]
                new_end = max(now, start + sh) + wk
                running[uid] = (kind, index, node, start, new_end, spec)
                heapq.heappush(events, (new_end, uid, kind, index))

    def fill_map_slots(now: float) -> None:
        while pending_maps and launch("map", pending_maps[0], now):
            pending_maps.popleft()

    def fill_reduce_slots(now: float) -> None:
        while pending_reduces and launch("reduce", pending_reduces[0], now):
            pending_reduces.popleft()

    def maybe_speculate(now: float) -> None:
        """Hadoop-style backup tasks for outliers, maps and reduces alike.

        Reduce tasks are only candidates once every map output exists: a
        first-wave reducer stalled on the map fleet looks slow without being
        a straggler, and its backup would stall the same way.
        """
        if not sim.speculative_execution:
            return

        def scan(kind, durations, completed, copies):
            if len(durations) < sim.speculative_min_completed:
                return
            mean = sum(durations) / len(durations)
            for uid, (k, index, node, start, end, spec) in list(running.items()):
                if k != kind or spec or end == float("inf"):
                    continue
                if index in completed or len(copies.get(index, [])) > 1:
                    continue
                # Measure reduces from the map-fleet finish, not their
                # launch: a first-wave reducer's shuffle stall is waiting,
                # not work, and would miscalibrate the straggler baseline.
                eff_start = start if kind == "map" \
                    else max(start, res.map_finish_time)
                projected = end - eff_start
                if projected > sim.speculative_slowdown_thr * mean and now > eff_start:
                    launch(kind, index, now, speculative=True, avoid_node=node)

        scan("map", finished_map_durations, completed_maps, map_copies)
        if all_maps_done():
            scan("reduce", finished_red_durations, completed_reduces, red_copies)

    fill_map_slots(0.0)

    while events:
        # Apply any node failure that occurs before the next event.
        next_time = events[0][0]
        if fail_idx < len(failures) and failures[fail_idx][0] <= next_time:
            ftime, fnode = failures[fail_idx]
            fail_idx += 1
            clock = max(clock, ftime)
            # Kill running tasks on the failed node; re-queue them.
            for uid, (kind, index, node, start, end, spec) in list(running.items()):
                if node != fnode:
                    continue
                del running[uid]
                reduce_durs.pop(uid, None)   # killed copy: drop its draws
                copies = map_copies if kind == "map" else red_copies
                if uid in copies.get(index, []):
                    copies[index].remove(uid)
                res.records.append(
                    TaskRecord(kind, index, node, start, ftime, spec, killed=True)
                )
                if kind == "map":
                    if index not in completed_maps and index not in pending_maps:
                        pending_maps.append(index)
                else:
                    if index not in completed_reduces and index not in pending_reduces:
                        pending_reduces.append(index)
                res.num_failure_reruns += 1
            # Completed map outputs on the failed node are lost -> re-run
            # (only matters while reducers still need them).
            if len(completed_reduces) < p.pNumReducers:
                for midx, mnode in list(map_output_node.items()):
                    if mnode == fnode and midx in completed_maps:
                        completed_maps.discard(midx)
                        del map_output_node[midx]
                        if midx not in pending_maps:
                            pending_maps.append(midx)
                        res.num_failure_reruns += 1
            # Slots on a failed node stay unusable.
            map_slots[fnode] = 0
            red_slots[fnode] = 0
            fill_map_slots(clock)
            if reducers_launched:   # a failure must not bypass slowstart
                fill_reduce_slots(clock)
            continue

        t, uid, kind, index = heapq.heappop(events)
        if uid not in running:
            continue  # stale event (task killed by failure or lost the race)
        if running[uid][4] != t:
            continue  # superseded event (reduce end was rescheduled)
        clock = t
        if kind == "reduce" and not all_maps_done():
            # A failure resurrected map work after this reduce was scheduled;
            # stall until the re-executed maps land.
            k2, i2, n2, s2, _e2, sp2 = running[uid]
            running[uid] = (k2, i2, n2, s2, float("inf"), sp2)
            continue
        kind, index, node, start, end, spec = running.pop(uid)
        res.records.append(TaskRecord(kind, index, node, start, end, spec))

        if kind == "map":
            map_slots[node] += 1
            # First copy to finish wins; kill the sibling copies.
            if index not in completed_maps:
                completed_maps.add(index)
                map_output_node[index] = node
                finished_map_durations.append(end - start)
                if spec:
                    res.num_speculative_won += 1
                for sib in map_copies.get(index, []):
                    if sib != uid and sib in running:
                        k2, i2, n2, s2, e2, sp2 = running.pop(sib)
                        map_slots[n2] += 1
                        res.records.append(
                            TaskRecord(k2, i2, n2, s2, clock, sp2, killed=True)
                        )
                map_copies[index] = []
            res.map_finish_time = max(res.map_finish_time, clock)
            if (
                not reducers_launched
                and p.pNumMappers > 0
                and len(completed_maps) >= p.pReduceSlowstart * p.pNumMappers
            ):
                reducers_launched = True
            fill_map_slots(clock)
            if reducers_launched:
                fill_reduce_slots(clock)
            if all_maps_done() and not pending_maps:
                schedule_waiting_reduces(clock)
            maybe_speculate(clock)
        else:
            red_slots[node] += 1
            reduce_durs.pop(uid, None)
            # First copy to finish wins; kill the sibling backups.
            if index not in completed_reduces:
                completed_reduces.add(index)
                # stall-free duration (see maybe_speculate)
                finished_red_durations.append(
                    end - max(start, res.map_finish_time))
                if spec:
                    res.num_speculative_won += 1
                for sib in red_copies.get(index, []):
                    if sib != uid and sib in running:
                        k2, i2, n2, s2, e2, sp2 = running.pop(sib)
                        reduce_durs.pop(sib, None)
                        red_slots[n2] += 1
                        res.records.append(
                            TaskRecord(k2, i2, n2, s2, clock, sp2, killed=True)
                        )
                red_copies[index] = []
            fill_reduce_slots(clock)
            maybe_speculate(clock)

        res.makespan = max(res.makespan, clock)

    # drift guard for the reduce_durs bookkeeping: an entry must not outlive
    # its running task (entries used to leak for the life of the simulation
    # on every failure-kill and speculative-sibling kill)
    assert set(reduce_durs) == {
        u for u, v in running.items() if v[0] == "reduce"
    }, "reduce_durs leaked entries for dead tasks"

    # --- slot-occupancy summary (consumed by the cluster layer) ---
    res.node_busy_s = [0.0] * n_nodes
    for rec in res.records:
        res.node_busy_s[rec.node] += rec.end - rec.start
    slot_seconds = res.makespan * n_nodes * (p.pMaxMapsPerNode + p.pMaxRedPerNode)
    if slot_seconds > 0:
        res.slot_utilization = sum(res.node_busy_s) / slot_seconds

    return res
