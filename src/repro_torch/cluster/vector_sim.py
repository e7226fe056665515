"""Batched wave-level cluster simulator (thousands of scenarios per call).

The Python DES (:mod:`repro_torch.cluster.sched`) costs ONE (workload,
cluster) scenario per call — fine for a probe, hopeless for a
capacity-planning grid.  This module rolls out the same wave mechanics as
one batched torch program over explicit ``(B, J, C)`` tensors (B =
scenarios, J = jobs, C = node classes): a host loop over *scheduling
rounds* (global event times), every op batched over the scenarios, float64
on the device, the scenarios split over :func:`repro_torch.compat.
search_devices` (:func:`repro_torch.compat.split_rows`).

The loop keeps the semantics of the reference's vmapped ``while_loop``:
each round computes ``active = cont(state)`` per scenario and then
``state = where(active, step(state), state)``, so a finished scenario is
frozen, not stepped.  The host reads the any-active flag only every
``check_every`` rounds (default 8) so that it does not stall the device
queue each round; the extra rounds are no-ops on frozen rows, so results
do not depend on how often the flag is read (tested).  The loop stops when
no row is active or after ``n_steps`` rounds.

Model (wave-discrete, deterministic):

* a job's launched tasks form *wave buckets* that complete together after
  one task duration — launches at an event join (and extend) the bucket;
* **heterogeneous fleets**: slots live in per-class columns (``C`` node
  classes, fastest first); a task launched into class ``c`` runs its
  compute ``speedup[c]`` times faster (the shuffle is network-bound and
  unscaled), so each job carries one wave bucket *per class* and free
  slots fill fast classes first — the DES's free-slot order;
* FIFO hands free slots to jobs in arrival order (prefix-sum allocation);
  fair-share water-fills the pool (integer max-min shares);
* **preemptive policies** reallocate at wave boundaries: at every event
  the scheduler recomputes each job's *target* allocation over the total
  capacity — fair water-fill (``fair_preempt``) or per-queue guaranteed
  capacities with FIFO spill (``capacity``) — kills running slots above
  the target (requeued to the todo pool, slowest class first; killed work
  is lost, as in the DES's kill-and-requeue) and launches up to it.  The
  DES's ``preempt_timeout`` grace is below wave resolution: the wave
  model preempts immediately at event boundaries, which the agreement
  tolerance for preemptive scenarios absorbs;
* reduces honor slowstart and the two-phase semantics: waves launched
  before the job's maps finish stall, then complete at
  ``max(map_finish, start + shuffle) + work`` — the DES rule verbatim.

Fidelity: on **contention-free FIFO** scenarios (every job's wave gets its
full slot demand the moment it asks — serialized jobs, or an unsaturated
cluster) wave buckets coincide with the DES's task waves and the rollout
reproduces per-job finish times *exactly* (float rounding aside; the
agreement test asserts rtol 1e-3) — including heterogeneous fleets, where
both models fill the fast class first and each class's sub-wave completes
at its own scaled duration.  Under slot contention partial waves merge
into one bucket per (job, class), a work-conserving approximation the
capacity planner accepts in exchange for ~3 orders of magnitude more
scenarios/s; ``ClusterEvaluator.exact_cost`` routes final candidates back
through the DES.

Scenario batches are dicts of arrays (B = scenarios, J = jobs, C = node
classes, Q = capacity queues):

  arrival (B, J)    n_maps (B, J)     n_reds (B, J)     map_cost (B, J)
  red_work (B, J)   shuffle (B, J)    queue (B, J)
  map_slots (B, C)  red_slots (B, C)  speedup (B, C)
  policy (B,)       slowstart (B,)    queue_frac (B, Q)

**DAG workloads** add ``dep`` / ``dep_kind`` (B, J) columns (default -1 /
0): job ``j`` arrives once job ``dep[j]`` finishes (kind 0, barrier) or
finishes its map phase (kind 1, slowstart) — single-parent chains/trees
only; multi-parent joins go through the DES.  **Topology-aware shuffle**
adds ``topo_racks`` / ``topo_cross_bw`` / ``topo_oversub`` (B,) columns
(default 1 / inf / 1): each reduce wave's shuffle term is divided by the
rack-incast effective bandwidth
(:func:`repro_torch.cluster.network.effective_bandwidth`) at its launch-time
concurrent-transfer count.  The bucket keeps its launch-time bandwidth —
the DES re-fair-shares continuously and is the exact reference, so
contended-incast agreement is gated at p95 (flat/uncontended rows stay
rtol-exact, the standard contract).

``policy`` is 0 = fifo, 1 = fair, 2 = fair_preempt, 3 = capacity (the
:data:`POLICIES` order).  :func:`simulate_batch` normalizes legacy inputs:
a ``fair`` (B,) column is accepted as ``policy``, 1-D ``map_slots`` /
``red_slots`` become one baseline class, ``speedup`` defaults to ones
(classes are re-sorted fastest-first), ``queue`` / ``queue_frac`` default
to a single queue.

**Elastic fleets** (:mod:`repro_torch.cloud`) add optional columns, all
defaulting to the fixed-fleet zero:

  autoscale (B,)          0 = off, 1 = queue-depth, 2 = predicted-load
  high_water (B,)         unmet-task trigger threshold (queue policy)
  provision_latency (B,)  request -> schedulable seconds
  extra_map_slots (B,)    autoscaled capacity block (joins the LAST class)
  extra_red_slots (B,)
  billing_quantum (B,)    minimum billed seconds per capacity episode
  reclaim_rate (B, C)     spot reclaims per node-second, per class

Fleet size becomes a per-round dynamic column: the extra block turns on
one provisioning latency after its trigger and turns off at the first
event where nothing is queued and the block is idle; its billed seconds
(episodes rounded up to the billing quantum) come back as
``extra_billed_s``.  Spot reclamation enters in expectation: a class with
reclaim rate λ runs its task of length d in ``(e^{λd} - 1)/λ`` expected
seconds (restart-from-scratch under a Poisson reclaim process) — the DES
realizes actual reclaim draws and is the exact reference, so agreement on
reclaiming workloads is gated at the p95 level, not per-job (the standard
contract: contention-free autoscaled cases stay rtol-exact).

Use :func:`pack_trace` to turn a :class:`~repro_torch.cluster.workload.
WorkloadTrace` into per-job columns, and :func:`estimate_steps` to bound
the round count (truncated scenarios report ``converged == 0``, which the
evaluator maps to ``valid == 0`` — the exact-simulator escape hatch, never
a silent wrong number).
"""

from __future__ import annotations

import time
from typing import Callable, Mapping, NamedTuple

import numpy as np
import torch

from repro_torch.compat import search_devices, split_rows
from repro_torch.obs import current as _obs_current

from .network import effective_bandwidth
from .workload import WorkloadTrace, shuffle_full, task_costs

__all__ = ["POLICIES", "RolloutProgram", "estimate_steps", "frozen_round",
           "latency_quantile", "pack_trace", "rollout_program", "simulate_batch"]

_EPS = 1e-3          # event-time / task-count slack (durations are >= ~0.1 s)
_INF = float("inf")

#: scheduler-policy encoding of the ``policy`` scenario column — index into
#: this tuple; matches ``ClusterConfig.scheduler`` names.
POLICIES = ("fifo", "fair", "fair_preempt", "capacity")


def pack_trace(trace: WorkloadTrace) -> dict[str, np.ndarray]:
    """Per-job columns (J,) for one trace.  ``shuffle`` is the all-remote
    limit (:func:`~repro.cluster.workload.shuffle_full`); multiply by the
    candidate cluster's remote fraction ``(n-1)/n`` before simulating.
    ``queue`` is the job's capacity-scheduler queue: the index of its job
    class name in sorted order (the DES's queue enumeration)."""
    cols = {k: [] for k in ("arrival", "n_maps", "n_reds", "map_cost",
                            "red_work", "shuffle", "queue", "dep", "dep_kind")}
    qidx = {name: i for i, name in
            enumerate(sorted({a.klass.name for a in trace.arrivals}))}
    pos = {a.job_id: i for i, a in enumerate(trace.arrivals)}
    for a in trace.arrivals:
        mc, rc, _ = task_costs(a.klass)
        cols["arrival"].append(a.submit_time)
        cols["n_maps"].append(a.klass.n_maps)
        cols["n_reds"].append(a.klass.n_reduces)
        cols["map_cost"].append(mc)
        cols["red_work"].append(rc)
        cols["shuffle"].append(shuffle_full(a.klass))
        cols["queue"].append(qidx[a.klass.name])
        # DAG edge columns: index of the (single) parent, or -1; kind 0 =
        # barrier, 1 = slowstart.  The wave rollout gates arrival on the
        # parent's finish / map-finish column, which only expresses one
        # parent per job — joins stay DES territory.
        deps = a.deps
        if len(deps) > 1:
            raise ValueError(
                "the wave model supports single-parent DAG jobs; route "
                f"multi-parent job {a.job_id} through the DES")
        cols["dep"].append(pos[deps[0][0]] if deps else -1)
        cols["dep_kind"].append(
            1.0 if deps and deps[0][1] == "slowstart" else 0.0)
    return {k: np.asarray(v, dtype=np.float64) for k, v in cols.items()}


def estimate_steps(scen: Mapping[str, np.ndarray], *, margin: float = 2.0
                   ) -> int:
    """Step *cap* covering every wave event, rounded up to a power of two
    (the reference's rule, kept so both give the same cap).  The rollout is
    a loop that stops at the batch's last event, so a generous cap costs
    nothing; ``margin`` absorbs wave fragmentation under contention
    (doubled when preemptive rows are present — kills re-fragment waves),
    and truncation at the cap is detected, not silent (``converged``)."""
    def total(key):
        a = np.asarray(scen[key], dtype=np.float64)
        return np.maximum(a.sum(axis=-1) if a.ndim == 2 else a, 1.0)
    ms, rs = total("map_slots"), total("red_slots")
    waves = (np.ceil(scen["n_maps"] / ms[:, None]).sum(axis=1)
             + np.ceil(scen["n_reds"] / rs[:, None]).sum(axis=1))
    pol = np.asarray(scen.get("policy", scen.get("fair", 0.0)))
    if np.any(pol >= 2):
        margin = margin * 2.0
    n_jobs = scen["arrival"].shape[-1]
    est = int(np.max(waves) * margin) + n_jobs + 8
    if np.any(np.asarray(scen.get("dep", -1.0)) >= 0):
        # each DAG release costs one zero-advance step (the child arrives
        # one step after its parent's milestone lands)
        est += n_jobs
    if (np.any(np.asarray(scen.get("autoscale", 0.0)) > 0.5)
            or np.any(np.asarray(scen.get("extra_map_slots", 0.0)) > 0)):
        # elastic rows add provision/teardown events (the queue policy can
        # cycle once per burst) — waves above were counted on base slots
        # only, so this is the only extra headroom needed
        est += n_jobs + 8
    return 1 << (est - 1).bit_length()


# --------------------------------------------------------------------------
# allocation primitives (batched: a leading scenario axis B on every operand;
# the cumsum / sum / min run along the job and class axes, per row)
# --------------------------------------------------------------------------


def _clip(x, lo, hi):
    """``jnp.clip``: ``min(max(x, lo), hi)``, so ``hi < lo`` returns ``hi``."""
    return torch.minimum(torch.clamp(x, min=lo), hi)


def _prefix(demand, cap):
    """FIFO: prefix allocation in arrival order (jobs are arrival-sorted).
    ``demand`` (B, J), ``cap`` (B,)."""
    cum = torch.cumsum(demand, -1) - demand
    return _clip(cap[:, None] - cum, 0.0, demand)


def _waterfill(demand, cap):
    """Fair: integer equal shares, leftover spilled FIFO (a one-pass
    max-min approximation; the DES is the slot-exact reference).  Whole
    slots throughout, matching the DES's slot granularity — fractional
    shares would extend wave buckets by a full task duration for an
    epsilon of work and never converge."""
    act = demand > _EPS
    n_act = torch.clamp(act.sum(-1), min=1).to(demand.dtype)
    share = torch.floor(cap / n_act + _EPS)
    a = torch.minimum(demand, share[:, None])
    need = demand - a
    cum2 = torch.cumsum(need, -1) - need
    left = torch.floor(cap - a.sum(-1) + _EPS)
    return a + _clip(left[:, None] - cum2, 0.0, need)


def _capacity_fill(demand, cap, onehot, queue_frac):
    """Capacity scheduler target: pass 1 fills each queue up to its
    guaranteed slot count (``floor(frac * cap)``, FIFO within the queue);
    pass 2 spills the leftover capacity FIFO over the remaining demand.
    ``onehot`` (B, J, Q), ``queue_frac`` (B, Q)."""
    # sum(floor(frac * cap)) <= cap because fracs sum to <= 1 (normalized
    # by _normalize), so pass 1 never over-allocates the pool
    qcap = torch.floor(queue_frac * cap[:, None] + _EPS)            # (B, Q)
    d_q = demand[:, :, None] * onehot                               # (B, J, Q)
    prev_q = ((torch.cumsum(d_q, 1) - d_q) * onehot).sum(-1)
    budget = (onehot * qcap[:, None, :]).sum(-1)                    # (B, J)
    a1 = _clip(budget - prev_q, 0.0, demand)
    return a1 + _prefix(demand - a1, cap - a1.sum(-1))


def _by_class(alloc, free_c):
    """Distribute per-job allocations (B, J) over per-class free slots
    (B, C), fastest class first: job j's slots occupy the interval
    ``[cumsum(alloc)_{j-1}, cumsum(alloc)_j)`` of the concatenated
    class-ordered slot space — the order the DES's free-slot picker
    produces when it launches tasks one at a time."""
    if free_c.shape[-1] == 1:      # homogeneous: keep the lean path
        return alloc[:, :, None]
    off_hi = torch.cumsum(free_c, -1)
    off_lo = off_hi - free_c
    start = (torch.cumsum(alloc, -1) - alloc)[:, :, None]
    stop = start + alloc[:, :, None]
    return torch.clamp(torch.minimum(stop, off_hi[:, None, :])
                       - torch.maximum(start, off_lo[:, None, :]), min=0.0)


def _take_rev(amount, buckets):
    """Take ``amount[b, j]`` slots out of ``buckets[b, j, :]`` starting from
    the LAST class (slowest) — preemption victims lose slow slots first, the
    class-ordered analogue of the DES killing the newest launch."""
    rev = torch.flip(buckets, (-1,))
    cum = torch.cumsum(rev, -1) - rev
    take = _clip(amount[:, :, None] - cum, 0.0, rev)
    return torch.flip(take, (-1,))


def _quantize(dur, quantum):
    """Round a billing episode up to the minimum billing granularity
    (0 = per-second billing).  Double-where so quantum 0 never divides."""
    q_safe = torch.where(quantum > 0, quantum, 1.0)
    return torch.where(quantum > 0, torch.ceil(dur / q_safe) * q_safe, dur)


def latency_quantile(values, q: float):
    """Linear-interpolated quantile along the last axis — the torch twin of
    :func:`repro_torch.obs.percentile_interp`, the repo's one percentile
    rule, with the same small-sample semantics: empty -> 0, one sample ->
    that sample for every ``q``, integral ranks return the order statistic
    exactly, and equal neighbours (both inf included) return the common
    value.  ``WorkloadResult.latency_quantile`` is the DES-side twin.
    A 1-D input gives a 0-d result; a (B, J) input one quantile per row."""
    v = torch.as_tensor(values)
    if not v.is_floating_point():
        v = v.to(torch.float64)
    if v.dim() == 0:
        v = v.reshape(1)
    v = torch.sort(v, dim=-1).values
    n = v.shape[-1]
    if n == 0:
        return torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    if n == 1:
        return v[..., 0]
    rank = min(max(float(q), 0.0), 100.0) / 100.0 * (n - 1)
    lo = int(np.floor(rank))
    hi = min(lo + 1, n - 1)
    frac = rank - float(lo)
    a, b = v[..., lo], v[..., hi]
    # double-where (the inf guard): when the neighbours agree or the rank
    # is integral the answer is ``a`` — never compute ``b - a`` there,
    # because with infinite neighbours that difference is inf - inf = nan
    same = (a == b) | (frac <= 0.0)
    delta = torch.where(same, 0.0, b - a)
    return torch.where(same, a, a + delta * frac)


# --------------------------------------------------------------------------
# core rollout (a batch of scenarios on one device)
# --------------------------------------------------------------------------


class RolloutProgram(NamedTuple):
    """The wave rollout of one block of scenarios as pure functions of the
    round state (a dict of tensors): ``state0`` the state before the first
    round, ``step(state)`` the next round's state, ``cont(state)`` which
    rows are still active (B,), ``finish(state)`` the per-scenario outputs.
    :func:`frozen_round` is one round of the loop; the host loop in
    :func:`simulate_batch` and the analyzer's loop fixpoint
    (``repro_torch.analysis.targets``) both iterate it."""

    state0: dict
    step: Callable[[dict], dict]
    cont: Callable[[dict], torch.Tensor]
    finish: Callable[[dict], dict]


def frozen_round(prog: RolloutProgram, st: dict) -> dict:
    """One round: ``step`` on the active rows, finished rows frozen (the
    reference's vmapped ``while_loop`` body)."""
    active = prog.cont(st)
    nxt = prog.step(st)
    return {k: torch.where(active.view((-1,) + (1,) * (v.dim() - 1)), nxt[k], v)
            for k, v in st.items()}


def rollout_program(s: dict, *, with_fair: bool, with_preempt: bool,
                    with_capacity: bool, with_cloud: bool, with_dag: bool,
                    with_topo: bool) -> RolloutProgram:
    """The rollout of one block of scenarios (float64 tensors on one
    device) with the named policy branches compiled in."""
    arrival = s["arrival"]                                          # (B, J)
    n_maps = s["n_maps"]
    n_reds = s["n_reds"]
    map_cost = torch.clamp(s["map_cost"], min=1e-9)
    map_slots = s["map_slots"]          # (B, C) per-class, fastest first
    red_slots = s["red_slots"]
    speedup = torch.clamp(s["speedup"], min=1e-9)
    policy = s["policy"]                                            # (B,)
    slowstart = s["slowstart"]
    B, J = arrival.shape
    C = map_slots.shape[1]
    dt, dev = arrival.dtype, arrival.device
    cap_m = map_slots.sum(-1)
    cap_r = red_slots.sum(-1)
    # per-class task durations: compute scales with the class, network not
    map_dur = map_cost[:, :, None] / speedup[:, None, :]            # (B, J, C)
    red_work_c = s["red_work"][:, :, None] / speedup[:, None, :]
    red_dur = s["shuffle"][:, :, None] + red_work_c
    arrival_min = arrival.min(-1).values
    if with_cloud:
        # spot reclamation in expectation: restart-from-scratch under a
        # Poisson(λ) reclaim process makes a length-d task take
        # (e^{λd} - 1)/λ expected seconds (-> d as λ -> 0); stalled-reduce
        # resolution keeps the uninflated work term — reclaim rates sane
        # enough to converge make that correction second-order.  Double-
        # where so λ = 0 classes never divide by zero.
        rate = torch.clamp(s["reclaim_rate"], min=0.0)[:, None, :]  # (B, 1, C)
        rate_safe = torch.where(rate > 0, rate, 1.0)

        def inflate(d):
            return torch.where(rate > 0, torch.expm1(rate_safe * d) / rate_safe, d)

        map_dur = inflate(map_dur)
        red_dur = inflate(red_dur)
        x_policy = s["autoscale"]
        high_water = s["high_water"]
        x_lat = s["provision_latency"]
        x_m = s["extra_map_slots"]
        x_r = s["extra_red_slots"]
        x_quant = s["billing_quantum"]
        have_extra = (x_m + x_r) > _EPS
        # the autoscaled block joins the LAST class column: extra capacity
        # clones the baseline (slowest) class, the DES's rule
        onehot_last = (torch.arange(C, device=dev) == C - 1).to(dt)
    if with_capacity:
        qf = s["queue_frac"]                                        # (B, Q)
        onehot = (torch.round(s["queue"])[:, :, None]
                  == torch.arange(qf.shape[1], device=dev)).to(dt)  # (B, J, Q)
    if with_dag:
        # single-parent DAG edges: job j's arrival is gated on dep[j]'s
        # finish (barrier) or map-finish (slowstart) column, gathered per row
        dep = torch.round(s["dep"]).to(torch.int64)
        dep_slow = s["dep_kind"] > 0.5
        pidx = torch.clamp(dep, 0, J - 1)

        def eligible_at(map_fin_col, fin_col):
            parent_t = torch.where(dep_slow, torch.gather(map_fin_col, 1, pidx),
                                   torch.gather(fin_col, 1, pidx))
            return torch.maximum(arrival, torch.where(dep >= 0, parent_t, -_INF))
    if with_topo:
        def shuffle_eff(n_flows):
            # per-rack incast contention: concurrent transfers share the
            # aggregation downlinks; bw floor keeps the division benign on
            # degenerate zero-capacity rows (evaluators sanitize earlier)
            bw = effective_bandwidth(s["topo_racks"], s["topo_cross_bw"],
                                     s["topo_oversub"], n_flows)
            return s["shuffle"] / torch.clamp(bw, min=1e-9)[:, None]

    def alloc_free(demand, free_c):
        """Non-preemptive policies: hand the free slots to demand."""
        a = _prefix(demand, free_c.sum(-1))
        if with_fair:
            a = torch.where(policy[:, None] > 0.5,
                            _waterfill(demand, free_c.sum(-1)), a)
        return a

    def target_alloc(demand_tot, cap):
        """Preemptive policies: the ideal allocation over TOTAL capacity."""
        tgt = _waterfill(demand_tot, cap)
        if with_capacity:
            tgt = torch.where(policy[:, None] > 2.5,
                              _capacity_fill(demand_tot, cap, onehot, qf), tgt)
        return tgt

    zeros3 = torch.zeros((B, J, C), dtype=dt, device=dev)
    inf3 = torch.full((B, J, C), _INF, dtype=dt, device=dev)
    inf2 = torch.full_like(arrival, _INF)
    state0 = dict(
        t=arrival_min,
        m_todo=n_maps * 1.0, m_run=zeros3, m_end=inf3,
        r_todo=n_reds * 1.0, r_run=zeros3, r_end=inf3,
        r_pre=zeros3, r_pre_start=inf3,
        red_launch=inf2, map_fin=inf2, fin=inf2,
    )
    if with_cloud:
        # predicted-load provisions up front: extra capacity is requested
        # the moment the workload starts (x_at = first arrival + latency);
        # the queue policy arms x_at when the trigger fires mid-run
        state0.update(
            x_on=torch.zeros_like(arrival_min),
            x_at=torch.where((x_policy > 1.5) & have_extra,
                             arrival_min + x_lat, _INF),
            x_t_on=torch.full_like(arrival_min, _INF),
            x_billed=torch.zeros_like(arrival_min),
        )

    def step(st):
        t = st["t"]
        te = t + _EPS
        te2, t2, t3 = te[:, None], t[:, None], t[:, None, None]
        if with_dag:
            # releases land on the previous state's milestones, so a child
            # released at this instant arrives one (zero-advance) step later
            eligible = eligible_at(st["map_fin"], st["fin"])
        else:
            eligible = arrival
        arrived = eligible <= te2

        if with_cloud:
            # pending provisioning lands: the block comes online for this
            # round's allocation, one episode (x_t_on) starts billing
            turn_on = (st["x_at"] <= te) & (st["x_on"] < 0.5)
            x_on = torch.where(turn_on, 1.0, st["x_on"])
            x_at = torch.where(turn_on, _INF, st["x_at"])
            x_t_on = torch.where(turn_on, t, st["x_t_on"])
            x_billed = st["x_billed"]
            map_slots_t = map_slots + (x_on * x_m)[:, None] * onehot_last
            red_slots_t = red_slots + (x_on * x_r)[:, None] * onehot_last
            cap_m_t = cap_m + x_on * x_m
            cap_r_t = cap_r + x_on * x_r
        else:
            map_slots_t, red_slots_t = map_slots, red_slots
            cap_m_t, cap_r_t = cap_m, cap_r

        # (a) wave buckets due now complete (per job x class)
        te3 = te[:, None, None]
        m_done_now = (st["m_run"] > _EPS) & (st["m_end"] <= te3)
        m_run = torch.where(m_done_now, 0.0, st["m_run"])
        m_end = torch.where(m_done_now, _INF, st["m_end"])
        r_done_now = (st["r_run"] > _EPS) & (st["r_end"] <= te3)
        r_run = torch.where(r_done_now, 0.0, st["r_run"])
        r_end = torch.where(r_done_now, _INF, st["r_end"])
        m_todo, r_todo = st["m_todo"], st["r_todo"]
        r_pre, r_pre_start = st["r_pre"], st["r_pre_start"]

        # (b) milestones: map fleet done, slowstart crossed, job finished
        m_run_j = m_run.sum(-1)
        maps_done = arrived & (m_todo <= _EPS) & (m_run_j <= _EPS)
        just_mf = torch.isinf(st["map_fin"]) & maps_done
        map_fin = torch.where(just_mf, t2, st["map_fin"])

        done_cnt = n_maps - m_todo - m_run_j
        slow_ok = arrived & (done_cnt >= slowstart[:, None] * n_maps - _EPS)
        red_launch = torch.where(torch.isinf(st["red_launch"]) & slow_ok, t2,
                                 st["red_launch"])

        # stalled pre-map-finish reduce wave resolves (the DES rule)
        resolve = just_mf[:, :, None] & (r_pre > _EPS)
        if with_topo:
            # contention at resolve time: running + stalled transfers share
            # the racks (the DES recomputes continuously; this snapshot is
            # the wave approximation the agreement gate bounds at p95)
            shuf_res = shuffle_eff((r_run + r_pre).sum((1, 2)))
        else:
            shuf_res = s["shuffle"]
        e1 = (torch.maximum(map_fin[:, :, None],
                            r_pre_start + shuf_res[:, :, None]) + red_work_c)
        r_end = torch.where(
            resolve,
            torch.maximum(torch.where(r_run > _EPS, r_end, -_INF), e1), r_end)
        r_run = torch.where(resolve, r_run + r_pre, r_run)
        r_pre = torch.where(resolve, 0.0, r_pre)
        r_pre_start = torch.where(resolve, _INF, r_pre_start)

        reds_done = ((r_todo <= _EPS) & (r_run.sum(-1) <= _EPS)
                     & (r_pre.sum(-1) <= _EPS))
        finished = arrived & maps_done & (reds_done | ~(n_reds > 0))
        fin = torch.where(torch.isinf(st["fin"]) & finished, t2, st["fin"])

        # (c) map slots
        m_demand = torch.where(arrived & (m_todo > _EPS), m_todo, 0.0)
        if with_preempt:
            preempt = (policy > 1.5)[:, None]
            m_run_j = m_run.sum(-1)
            target = target_alloc(m_demand + m_run_j, cap_m_t)
            kill = torch.where(preempt, torch.clamp(m_run_j - target, min=0.0),
                               0.0)
            kill_c = _take_rev(kill, m_run)
            m_run = m_run - kill_c
            m_todo = m_todo + kill_c.sum(-1)     # killed work re-runs fully
            m_end = torch.where(m_run > _EPS, m_end, _INF)
            m_demand = torch.where(arrived & (m_todo > _EPS), m_todo, 0.0)
            free_m = map_slots_t - m_run.sum(1)
            alloc = torch.where(
                preempt,
                _clip(target - m_run.sum(-1), 0.0, m_demand),
                alloc_free(m_demand, free_m))
        else:
            free_m = map_slots_t - m_run.sum(1)
            alloc = alloc_free(m_demand, free_m)
        k_m = _by_class(alloc, free_m)
        launched = k_m > _EPS
        m_end = torch.where(
            launched,
            torch.maximum(torch.where(m_run > _EPS, m_end, -_INF), t3 + map_dur),
            m_end)
        m_run = m_run + k_m
        m_todo = m_todo - k_m.sum(-1)

        # (d) reduce slots (gated on slowstart; pre-map-finish waves stall)
        red_open = red_launch <= te2
        r_demand = torch.where(red_open & (r_todo > _EPS), r_todo, 0.0)
        if with_preempt:
            run_tot = r_run.sum(-1) + r_pre.sum(-1)
            target = target_alloc(r_demand + run_tot, cap_r_t)
            kill = torch.where(preempt, torch.clamp(run_tot - target, min=0.0),
                               0.0)
            take_pre = _take_rev(kill, r_pre)      # stalled buckets first
            r_pre = r_pre - take_pre
            take_run = _take_rev(kill - take_pre.sum(-1), r_run)
            r_run = r_run - take_run
            r_todo = r_todo + (take_pre + take_run).sum(-1)
            r_pre_start = torch.where(r_pre > _EPS, r_pre_start, _INF)
            r_end = torch.where(r_run > _EPS, r_end, _INF)
            r_demand = torch.where(red_open & (r_todo > _EPS), r_todo, 0.0)
            free_r = red_slots_t - r_run.sum(1) - r_pre.sum(1)
            alloc_r = torch.where(
                preempt,
                _clip(target - r_run.sum(-1) - r_pre.sum(-1), 0.0, r_demand),
                alloc_free(r_demand, free_r))
        else:
            free_r = red_slots_t - r_run.sum(1) - r_pre.sum(1)
            alloc_r = alloc_free(r_demand, free_r)
        k_r = _by_class(alloc_r, free_r)
        launched_r = k_r > _EPS
        post = launched_r & maps_done[:, :, None]
        pre = launched_r & ~maps_done[:, :, None]
        if with_topo:
            # launch-time contention (this wave's transfers included); the
            # bucket keeps its launch-time bandwidth for its whole wave
            shuf_t = shuffle_eff((r_run + r_pre).sum((1, 2)) + k_r.sum((1, 2)))
            red_dur_t = shuf_t[:, :, None] + red_work_c
            if with_cloud:
                red_dur_t = inflate(red_dur_t)
        else:
            red_dur_t = red_dur
        r_end = torch.where(
            post,
            torch.maximum(torch.where(r_run > _EPS, r_end, -_INF),
                          t3 + red_dur_t),
            r_end)
        r_run = torch.where(post, r_run + k_r, r_run)
        r_pre = torch.where(pre, r_pre + k_r, r_pre)
        r_pre_start = torch.where(pre, torch.minimum(r_pre_start, t3),
                                  r_pre_start)
        r_todo = r_todo - k_r.sum(-1)

        # (e) autoscaler trigger / teardown (post-allocation, the DES's
        # evaluation points), then advance to the next event
        if with_cloud:
            unmet = (torch.where(arrived, m_todo, 0.0).sum(-1)
                     + torch.where(red_open, r_todo, 0.0).sum(-1))
            trigger = ((x_policy > 0.5) & (x_policy < 1.5) & have_extra
                       & (unmet > high_water + _EPS)
                       & (x_on < 0.5) & torch.isinf(x_at))
            x_at = torch.where(trigger, t + x_lat, x_at)
            # teardown: nothing queued and the whole block idle (free slots
            # in its class cover it) -> close the billing episode.  The
            # queue policy re-arms on a later burst (x_at back to inf).
            free_m_now = map_slots_t - m_run.sum(1)
            free_r_now = red_slots_t - r_run.sum(1) - r_pre.sum(1)
            drop = ((x_on > 0.5) & (unmet <= _EPS)
                    & (free_m_now[:, -1] >= x_m - _EPS)
                    & (free_r_now[:, -1] >= x_r - _EPS))
            ep = t - torch.where(x_on > 0.5, x_t_on, t)   # 0 when off, no inf
            x_billed = x_billed + torch.where(drop, _quantize(ep, x_quant), 0.0)
            x_on = torch.where(drop, 0.0, x_on)
            x_t_on = torch.where(drop, _INF, x_t_on)

        if with_dag:
            # re-read eligibility off the UPDATED milestones so a future
            # release is a scheduled event, not a missed one
            elig_next = eligible_at(map_fin, fin)
        else:
            elig_next = arrival
        t_next = torch.minimum(
            torch.where(elig_next > te2, elig_next, _INF).min(-1).values,
            torch.minimum(m_end.amin((1, 2)), r_end.amin((1, 2))))
        if with_cloud:
            t_next = torch.minimum(t_next, x_at)
        t_new = torch.where(torch.isfinite(t_next), t_next, t)

        nxt = dict(t=t_new, m_todo=m_todo, m_run=m_run,
                   m_end=m_end, r_todo=r_todo, r_run=r_run, r_end=r_end,
                   r_pre=r_pre, r_pre_start=r_pre_start,
                   red_launch=red_launch, map_fin=map_fin, fin=fin)
        if with_cloud:
            nxt.update(x_on=x_on, x_at=x_at, x_t_on=x_t_on, x_billed=x_billed)
        return nxt

    def cont(st):
        # a scenario whose jobs have all finished is frozen; the round cap
        # (the reference's per-row ``k < n_steps``) is the host loop's bound
        return ~torch.isfinite(st["fin"]).all(-1)

    def finish(st):
        fin = st["fin"]
        converged = torch.isfinite(fin).all(-1)
        if with_dag:
            # a DAG child's service clock starts at its release (the DES sets
            # submit_time the same way); double-where: an unreleased child has
            # an infinite release, and inf - inf is the nan this guards against
            submit = eligible_at(st["map_fin"], fin)
            ok = torch.isfinite(submit)
            latency = torch.where(ok, fin - torch.where(ok, submit, 0.0), _INF)
        else:
            latency = fin - arrival
        # nominal busy seconds (baseline-speed work estimate over all slots)
        busy = (n_maps * map_cost + n_reds * (s["shuffle"] + s["red_work"])).sum(-1)
        fin_max = fin.max(-1).values
        span = torch.clamp(fin_max - arrival_min, min=1e-9)
        # percentile interpolates between sorted neighbours (lo + (hi-lo)*frac);
        # with >= 2 infinite latencies (unconverged scenario) that is inf - inf
        # = nan.  Double-where: the percentile only ever sees finite values, and
        # unconverged scenarios report inf — the same sentinel `finish` uses.
        lat_safe = torch.where(torch.isfinite(latency), latency, 0.0)
        out = dict(
            finish=fin,
            map_finish=st["map_fin"],
            latency=latency,
            converged=converged.to(torch.float32),
            mean_latency=latency.mean(-1),
            p95_latency=torch.where(
                converged, latency_quantile(lat_safe, 95.0), _INF),
            makespan=span,
            utilization=busy / (span * torch.clamp(cap_m + cap_r, min=1.0)),
        )
        if with_cloud:
            # close a still-open extra-capacity episode at the last finish (the
            # DES closes live online intervals at span the same way); inf for
            # unconverged rows, whose billed seconds are as unknown as their
            # finish times
            x_open = st["x_on"] > 0.5
            # double-where: an unconverged row has inf finish times (and an
            # open episode keeps x_t_on), so the subtraction only ever sees
            # finite operands; the result is overridden to inf below anyway
            end_safe = torch.where(torch.isfinite(fin_max), fin_max, 0.0)
            start_safe = torch.where(torch.isfinite(st["x_t_on"]), st["x_t_on"], 0.0)
            ep = torch.where(x_open, torch.clamp(end_safe - start_safe, min=0.0), 0.0)
            billed = st["x_billed"] + torch.where(x_open, _quantize(ep, x_quant), 0.0)
            out["extra_billed_s"] = torch.where(converged, billed, _INF)
        return out

    return RolloutProgram(state0, step, cont, finish)


def _rollout(s: dict, n_steps: int, check_every: int, **flags
             ) -> tuple[dict, int]:
    """Roll out one block of scenarios (float64 tensors on one device);
    returns the per-scenario outputs and the number of rounds run."""
    prog = rollout_program(s, **flags)
    st = prog.state0
    rounds = 0
    check_every = max(int(check_every), 1)
    while rounds < n_steps:
        for _ in range(min(check_every, n_steps - rounds)):
            st = frozen_round(prog, st)
            rounds += 1
        if not bool(prog.cont(st).any()):
            break
    return prog.finish(st), rounds


def _normalize(scen: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Canonical scenario batch: legacy aliases resolved, class columns
    2-D and sorted fastest-first, queue columns defaulted."""
    arrs = {k: np.asarray(v) for k, v in scen.items()}
    b = arrs["arrival"].shape[0]
    if "policy" not in arrs:
        arrs["policy"] = arrs.pop("fair") if "fair" in arrs \
            else np.zeros(b, dtype=np.float64)
    arrs.pop("fair", None)
    for k in ("map_slots", "red_slots"):
        if arrs[k].ndim == 1:
            arrs[k] = arrs[k][:, None]
    if "speedup" not in arrs:
        arrs["speedup"] = np.ones_like(arrs["map_slots"])
    elif arrs["speedup"].ndim == 1:
        arrs["speedup"] = arrs["speedup"][:, None]
    # elastic-fleet columns (repro.cloud): default to the fixed fleet.
    # reclaim_rate is per class and must ride the fastest-first re-sort
    # with the slot columns; a 1-D rate applies to every class.
    if "reclaim_rate" not in arrs:
        arrs["reclaim_rate"] = np.zeros(arrs["map_slots"].shape,
                                        dtype=np.float64)
    else:
        rr = np.asarray(arrs["reclaim_rate"], dtype=np.float64)
        if rr.ndim == 1:
            rr = np.repeat(rr[:, None], arrs["map_slots"].shape[1], axis=1)
        arrs["reclaim_rate"] = rr
    for k in ("autoscale", "high_water", "provision_latency",
              "extra_map_slots", "extra_red_slots", "billing_quantum"):
        if k not in arrs:
            arrs[k] = np.zeros(b, dtype=np.float64)
    order = np.argsort(-arrs["speedup"], axis=1, kind="stable")
    for k in ("speedup", "map_slots", "red_slots", "reclaim_rate"):
        arrs[k] = np.take_along_axis(arrs[k], order, axis=1)
    # DAG / topology columns: defaults are the flat no-dependency network,
    # so legacy batches take the same lean paths (flag detection below)
    if "dep" not in arrs:
        arrs["dep"] = np.full(arrs["arrival"].shape, -1.0)
    if "dep_kind" not in arrs:
        arrs["dep_kind"] = np.zeros(arrs["arrival"].shape, dtype=np.float64)
    if "topo_racks" not in arrs:
        arrs["topo_racks"] = np.ones(b, dtype=np.float64)
    if "topo_cross_bw" not in arrs:
        arrs["topo_cross_bw"] = np.full(b, np.inf)
    if "topo_oversub" not in arrs:
        arrs["topo_oversub"] = np.ones(b, dtype=np.float64)
    if "queue" not in arrs:
        arrs["queue"] = np.zeros_like(arrs["arrival"])
    if "queue_frac" not in arrs:
        # default guarantees mirror the DES: equal shares over the queues
        # PRESENT in each row's trace (a single flat 1.0 would hand queue 0
        # a 100% guarantee and starve the rest under the capacity policy)
        qcol = np.round(arrs["queue"]).astype(np.int64)
        n_q = int(qcol.max()) + 1 if qcol.size else 1
        present = (qcol[:, :, None] == np.arange(n_q)[None, None, :]).any(1)
        arrs["queue_frac"] = present / np.maximum(
            present.sum(axis=1, keepdims=True), 1)
    else:
        # guarantees are fractions of the pool: renormalize rows that
        # oversubscribe it so pass-1 capacity fills cannot over-allocate
        qf = arrs["queue_frac"].astype(np.float64)
        tot = qf.sum(axis=1, keepdims=True)
        arrs["queue_frac"] = np.where(tot > 1.0, qf / np.maximum(tot, 1e-9), qf)
    return arrs


def simulate_batch(
    scen: Mapping[str, np.ndarray],
    *,
    n_steps: int | None = None,
    devices=None,
    device=None,
    check_every: int = 8,
) -> dict[str, np.ndarray]:
    """Roll out a batch of scenarios; returns per-scenario metrics plus
    per-job ``finish`` / ``latency`` arrays (numpy, float64; ``converged``
    float32).  The batch is padded (edge-replicated) to the device count and
    split over ``devices`` (default every CUDA card,
    :func:`repro_torch.compat.search_devices`; ``device="cpu"`` is
    ``devices=["cpu"]``).  Policy mix and class count pick the code paths:
    a pure-FIFO homogeneous batch runs the lean path (callers split rows by
    policy, as the capacity-planning benchmarks do).  ``check_every`` is
    how many rounds run between the host's reads of the any-active flag;
    it does not change the result."""
    if devices is None and device is not None:
        devices = [device]
    devs = search_devices(devices)
    if n_steps is None:
        n_steps = estimate_steps(scen)
    arrs = _normalize(scen)
    b = arrs["arrival"].shape[0]
    pad = (-b) % len(devs)
    pol = arrs["policy"]
    flags = dict(
        with_fair=bool(np.any(pol > 0.5)),
        with_preempt=bool(np.any(pol > 1.5)),
        with_capacity=bool(np.any(pol > 2.5)),
        with_cloud=bool(np.any(arrs["autoscale"] > 0.5)
                        or np.any(arrs["extra_map_slots"] > 0)
                        or np.any(arrs["extra_red_slots"] > 0)
                        or np.any(arrs["reclaim_rate"] > 0)),
        with_dag=bool(np.any(arrs["dep"] >= 0)),
        with_topo=bool(np.any(
            (arrs["topo_racks"] > 1.5)
            & np.isfinite(arrs["topo_cross_bw"]
                          / np.maximum(arrs["topo_oversub"], 1.0)))),
    )
    cols = {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float64))
            for k, v in arrs.items()}
    rounds = []

    def run(block, dev):
        out, r = _rollout(block, n_steps, check_every=check_every, **flags)
        rounds.append(r)
        return out

    ob = _obs_current()
    t0 = time.perf_counter() if ob.enabled else 0.0
    with ob.tracer.span("vector_sim.simulate_batch", scenarios=b,
                        n_steps=n_steps):
        out = split_rows(run, cols, devs)
    if ob.enabled:
        reg = ob.registry
        reg.counter("vector_sim.batches").inc()
        reg.counter("vector_sim.scenarios").inc(b)
        reg.counter("vector_sim.scenarios_padded").inc(pad)
        reg.counter("vector_sim.rounds").inc(max(rounds))
        reg.histogram("vector_sim.batch_s").record(time.perf_counter() - t0)
    return {k: v.cpu().numpy() for k, v in out.items()}
