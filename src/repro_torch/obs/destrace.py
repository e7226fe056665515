"""Turn a cluster DES result into a Perfetto swimlane trace.

:func:`workload_trace` renders a :class:`~repro_torch.cluster.sched.WorkloadResult`
as Chrome trace events on a **virtual-time** clock (1 simulated second =
1e6 trace µs, so Perfetto's ruler reads directly in simulated seconds):

* one process per node, one thread ("m0", "m1", ... / "r0", ...) per
  occupied slot lane — tasks pack into lanes exactly as they occupied
  slots, so the view is the cluster's Gantt chart;
* every task is an ``X`` span; *inside* it, sub-spans carve the task into
  the paper's phase vocabulary (:class:`repro_torch.spec.report.PhaseBreakdown`):
  maps split into ``map_read / map_spill / map_merge / map_write``
  proportional to the job class's §2-§3 per-phase costs; reduces show the
  recorded ``network`` shuffle transfer (overlapping the job's maps) then
  ``shuffle / reduce_merge / reduce_write`` carved from the §4 costs;
* kills are instants (``preempt`` / ``failure`` / ``superseded`` /
  ``reclaim``) at the kill time — a spot reclamation renders under its
  own name, distinct from a scheduler preemption or a node failure;
  speculative copies are flagged in the span args;
* a "jobs" process holds one lane per job (``queued`` then ``running``),
  and a ``cluster`` counter track plots running maps/reduces over time;
* elastic/priced fleets (:mod:`repro_torch.cloud`) add per-node
  ``provisioned`` / ``offline`` instants at capacity-episode boundaries
  plus ``fleet`` (online nodes) and ``spend`` (cumulative dollars)
  counter tracks swept from ``WorkloadResult.node_online``;
* DAG traces draw Perfetto flow arrows (``ph: s``/``f``) from each
  parent's stage boundary (``stage done`` / ``map done`` instant) to the
  child's ``released`` instant on the jobs lanes — barrier and slowstart
  edges are labeled by kind;
* non-flat topologies (``cluster.topology``) add a ``rack uplink util``
  counter track: per-rack cross-link utilization swept from the reduce
  records' shuffle spans against the rack's uplink capacity.

Pure host-side post-processing: reads the result's records, touches no device code.
"""

from __future__ import annotations

import functools

from repro_torch.obs.trace import Tracer

__all__ = ["workload_trace", "SIM_SECOND_US"]

#: virtual-time scale: one simulated second rendered as this many trace µs.
SIM_SECOND_US = 1e6

_PID_JOBS = 2
_PID_NODE0 = 10          # node k -> pid _PID_NODE0 + k
_TID_REDUCE0 = 1000      # reduce lane k -> tid _TID_REDUCE0 + k


@functools.lru_cache(maxsize=256)
def _phase_fracs(jc) -> tuple[tuple[tuple[str, float], ...],
                              tuple[tuple[str, float], ...]]:
    """((map phase, fraction), ...), ((reduce phase, fraction), ...) for a
    :class:`~repro_torch.cluster.workload.JobClass` — §2-§4 per-phase costs
    normalized within the task, the split the DES's scalar task costs hide."""
    from repro_torch.core.hadoop.ref import job_model

    jm = job_model(jc.params, jc.stats, jc.costs)
    m = jm.map
    map_parts = (
        ("map_read", m.ioReadCost + m.cpuReadCost),
        ("map_spill", m.ioSpillCost + m.cpuSpillCost),
        ("map_merge", m.ioMergeCost + m.cpuMergeCost),
        ("map_write", m.ioMapWriteCost + m.cpuMapWriteCost),
    )
    r = jm.reduce
    red_parts = (
        ("shuffle", r.ioShuffleCost + r.cpuShuffleCost),
        ("reduce_merge", r.ioSortCost + r.cpuSortCost),
        ("reduce_write", r.ioWriteCost + r.cpuWriteCost),
    )

    def norm(parts):
        total = sum(v for _, v in parts)
        if total <= 0:
            return ()
        return tuple((k, v / total) for k, v in parts if v > 0)

    return norm(map_parts), norm(red_parts)


def _carve(tracer: Tracer, pid: int, tid: int, t0: float, t1: float,
           fracs) -> None:
    """Emit sub-spans splitting [t0, t1] (virtual s) by (name, frac) pairs."""
    span = t1 - t0
    if span <= 0 or not fracs:
        return
    at = t0
    for i, (name, frac) in enumerate(fracs):
        dur = span * frac if i < len(fracs) - 1 else t1 - at
        tracer.complete(name, at * SIM_SECOND_US, dur * SIM_SECOND_US,
                        pid=pid, tid=tid)
        at += dur


def workload_trace(trace, result, cluster, *, tracer: Tracer | None = None
                   ) -> Tracer:
    """Emit ``result`` (from :func:`repro_torch.cluster.sched.simulate_workload`
    of ``trace`` on ``cluster``) as a virtual-time Perfetto swimlane.

    ``tracer`` defaults to the ambient one (:func:`repro_torch.obs.current`); a
    fresh :class:`Tracer` is created when the ambient is the null tracer,
    so ``workload_trace(...).write(path)`` works standalone.  Returns the
    tracer written to.
    """
    if tracer is None:
        from repro_torch.obs import current

        tracer = current().tracer
        if not tracer.enabled:
            tracer = Tracer()

    klass_of = {a.job_id: a.klass for a in trace.arrivals}
    # autoscaled extras live past cluster.num_nodes in node_online order
    n_nodes = max(1, cluster.num_nodes, len(result.node_online))
    for nd in range(n_nodes):
        tracer.process_name(_PID_NODE0 + nd, f"node {nd}")
    tracer.process_name(_PID_JOBS, "jobs")

    # ---- slot-lane packing: records reoccupy lanes as they did slots ----
    recs = sorted(result.records, key=lambda r: (r.start, r.end))
    lane_busy: dict[tuple[int, str], list[float]] = {}
    lanes_used: dict[tuple[int, str], int] = {}

    def lane_for(rec) -> int:
        key = (rec.node, rec.kind)
        ends = lane_busy.setdefault(key, [])
        for i, e in enumerate(ends):
            if e <= rec.start + 1e-12:
                ends[i] = rec.end
                return i
        ends.append(rec.end)
        lanes_used[key] = len(ends)
        return len(ends) - 1

    for rec in recs:
        lane = lane_for(rec)
        pid = _PID_NODE0 + rec.node
        tid = lane if rec.kind == "map" else _TID_REDUCE0 + lane
        jc = klass_of.get(rec.job_id)
        name = f"{jc.name if jc else 'job'}#{rec.job_id} {rec.kind}[{rec.index}]"
        args = {"job": rec.job_id, "index": rec.index}
        if rec.speculative:
            args["speculative"] = 1
        if rec.killed:
            args["killed"] = rec.kill_reason or "killed"
        tracer.complete(name, rec.start * SIM_SECOND_US,
                        (rec.end - rec.start) * SIM_SECOND_US,
                        pid=pid, tid=tid, **args)
        if rec.killed:
            tracer.instant(rec.kill_reason or "killed",
                           ts=rec.end * SIM_SECOND_US, pid=pid, tid=tid,
                           job=rec.job_id, index=rec.index)
            continue
        if jc is None:
            continue
        map_fracs, red_fracs = _phase_fracs(jc)
        if rec.kind == "map":
            _carve(tracer, pid, tid, rec.start, rec.end, map_fracs)
        else:
            # the recorded network transfer overlaps the job's maps; the
            # §4 shuffle/merge/write work fills the rest of the span
            work_start = rec.start
            if rec.shuffle_end > rec.start + 1e-12:
                tracer.complete("network", rec.start * SIM_SECOND_US,
                                (rec.shuffle_end - rec.start) * SIM_SECOND_US,
                                pid=pid, tid=tid)
                work_start = rec.shuffle_end
            _carve(tracer, pid, tid, work_start, rec.end, red_fracs)

    for (node, kind), n in sorted(lanes_used.items()):
        for lane in range(n):
            tid = lane if kind == "map" else _TID_REDUCE0 + lane
            tracer.thread_name(_PID_NODE0 + node, tid,
                               f"{kind[0]}{lane}",
                               sort_index=tid)

    # ---- per-job lanes: queued then running ----
    for js in result.jobs:
        tid = js.job_id
        tracer.thread_name(_PID_JOBS, tid, f"job {js.job_id} {js.name}",
                           sort_index=tid)
        if js.first_launch != float("inf"):
            tracer.complete("queued", js.submit_time * SIM_SECOND_US,
                            (js.first_launch - js.submit_time) * SIM_SECOND_US,
                            pid=_PID_JOBS, tid=tid)
            if js.finish != float("inf"):
                tracer.complete(
                    "running", js.first_launch * SIM_SECOND_US,
                    (js.finish - js.first_launch) * SIM_SECOND_US,
                    pid=_PID_JOBS, tid=tid,
                    n_maps=js.n_maps, n_reduces=js.n_reduces)

    # ---- DAG edges: flow arrows between stage-boundary instants ----
    stats_of = {js.job_id: js for js in result.jobs}
    flow_id = 0
    for a in trace.arrivals:
        child = stats_of.get(a.job_id)
        if child is None or child.first_launch == float("inf"):
            continue
        for parent_id, kind in a.deps:
            parent = stats_of.get(parent_id)
            if parent is None:
                continue
            t_rel = parent.map_finish if kind == "slowstart" else parent.finish
            if t_rel == float("inf"):
                continue
            boundary = "map done" if kind == "slowstart" else "stage done"
            tracer.instant(boundary, ts=t_rel * SIM_SECOND_US,
                           pid=_PID_JOBS, tid=parent_id,
                           job=parent_id, edge=kind)
            tracer.instant("released", ts=child.submit_time * SIM_SECOND_US,
                           pid=_PID_JOBS, tid=a.job_id,
                           job=a.job_id, parent=parent_id, edge=kind)
            flow_id += 1
            # raw Perfetto flow pair: the arrow from the parent's stage
            # boundary to the child's release on the jobs lanes
            tracer.event({"ph": "s", "id": flow_id, "cat": "dag",
                          "name": kind, "pid": _PID_JOBS, "tid": parent_id,
                          "ts": t_rel * SIM_SECOND_US})
            tracer.event({"ph": "f", "bp": "e", "id": flow_id, "cat": "dag",
                          "name": kind, "pid": _PID_JOBS, "tid": a.job_id,
                          "ts": child.submit_time * SIM_SECOND_US})

    # ---- per-rack cross-link utilization (topology-aware shuffles) ----
    topo = getattr(cluster, "topology", None)
    if topo is not None and not topo.is_flat:
        # each reduce's [start, shuffle_end] span is a cross-rack flow into
        # its rack; utilization = fair-share demand / uplink capacity
        rack_deltas: dict[float, list[float]] = {}
        for rec in recs:
            if rec.kind != "reduce" or rec.shuffle_end <= rec.start + 1e-12:
                continue
            rack = topo.rack_of(rec.node)
            d0 = rack_deltas.setdefault(rec.start, [0.0] * topo.num_racks)
            d1 = rack_deltas.setdefault(rec.shuffle_end,
                                        [0.0] * topo.num_racks)
            d0[rack] += 1.0
            d1[rack] -= 1.0
        live = [0.0] * topo.num_racks
        cap = topo.rack_capacity
        xr = topo.cross_frac
        for t in sorted(rack_deltas):
            live = [a + b for a, b in zip(live, rack_deltas[t])]
            util = {
                f"rack{r}": (min(1.0, xr * live[r] / cap) if cap > 0
                             and cap != float("inf") else 0.0)
                for r in range(topo.num_racks)
            }
            tracer.counter("rack uplink util", ts=t * SIM_SECOND_US,
                           pid=_PID_JOBS, **util)

    # ---- running-task counter track (event sweep over live records) ----
    deltas: dict[float, list[int]] = {}
    for rec in recs:
        d0 = deltas.setdefault(rec.start, [0, 0])
        d1 = deltas.setdefault(rec.end, [0, 0])
        k = 0 if rec.kind == "map" else 1
        d0[k] += 1
        d1[k] -= 1
    m = r = 0
    for t in sorted(deltas):
        dm, dr = deltas[t]
        m += dm
        r += dr
        tracer.counter("cluster running", ts=t * SIM_SECOND_US,
                       pid=_PID_JOBS, maps=m, reduces=r)

    # ---- elastic fleet: capacity episodes, fleet-size + spend tracks ----
    episodes = result.node_online
    table = cluster.node_table()
    priced = any(row[2] > 0 for row in table)
    elastic = (len(episodes) > len(table)
               or any(len(eps) != 1 for eps in episodes)
               or any(s > 0 for eps in episodes for s, _ in eps))
    if episodes and (priced or elastic):
        span = result.makespan
        # extras (nodes past the base table) clone the slowest class
        extra_price = table[-1][2] if table else 0.0
        events: list[tuple[float, int, float]] = []
        for nd, eps in enumerate(episodes):
            price = table[nd][2] if nd < len(table) else extra_price
            is_extra = nd >= len(table)
            for s0, e0 in eps:
                events.append((s0, 1, price))
                events.append((e0, -1, price))
                if s0 > 0:     # replacement or autoscale provision
                    tracer.instant("provisioned", ts=s0 * SIM_SECOND_US,
                                   pid=_PID_NODE0 + nd, tid=0, node=nd,
                                   extra=int(is_extra))
                if e0 < span - 1e-9:   # reclaim/failure/teardown, not EOS
                    tracer.instant("offline", ts=e0 * SIM_SECOND_US,
                                   pid=_PID_NODE0 + nd, tid=0, node=nd,
                                   extra=int(is_extra))
        events.sort()
        online, rate, spent = 0, 0.0, 0.0
        t_prev = 0.0
        for t, d, price in events:
            spent += rate * max(t - t_prev, 0.0)
            online += d
            rate += d * price / 3600.0
            t_prev = t
            tracer.counter("fleet", ts=t * SIM_SECOND_US, pid=_PID_JOBS,
                           online_nodes=online)
            if priced:
                tracer.counter("spend", ts=t * SIM_SECOND_US, pid=_PID_JOBS,
                               dollars=spent)
    return tracer
