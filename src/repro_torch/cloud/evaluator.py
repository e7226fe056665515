"""Price/performance capacity planning behind the ``Evaluator`` interface.

``CloudEvaluator`` is the economic layer on top of the cluster planner:
the same workload-on-cluster rollout (wave simulator batched, DES exact),
but the objective is **dollars per job under an SLO** instead of latency
at a fixed fleet.  Because it implements :class:`repro_torch.search.Evaluator`,
every strategy (``grid_search_ev``, ``random_search_ev``,
``coordinate_descent_ev``, streaming ``search_topk``) and
:class:`repro_torch.search.WhatIfService` walk the price-performance Pareto
frontier unchanged.

Override keys (the ``base_cfg`` universe, declared in :func:`cloud_space`):

  ``pOnDemandNodes`` / ``pSpotNodes`` — the priced two-class fleet (spot
  first; both classes run at baseline speed, they differ in price and
  reclaimability), ``spotReclaimRate`` (1/s exponential reclamation of
  spot capacity), ``autoscalePolicy`` / ``autoscaleHighWater`` (the
  :data:`~repro_torch.cloud.autoscaler.AUTOSCALE_POLICIES` code and its
  scale-up trigger), ``sloLatency`` (per-job latency bound the fleet is
  bought to meet), ``pNumRacks`` / ``crossRackBw`` / ``oversubscription``
  (the :class:`repro_torch.cluster.network.Topology` the fleet is wired with —
  racks=1 or infinite bandwidth is the flat network), plus the familiar
  ``pMaxMapsPerNode``, ``pMaxRedPerNode``, ``pReduceSlowstart``,
  ``schedPolicy`` and ``arrivalRate`` cluster knobs.

Cost semantics:

* ``c_cost`` (the search objective) is mean dollars-per-job when the
  workload's SLO attainment reaches ``slo_target``, else ``inf`` — an
  SLO-infeasible fleet is never "cheap", it is not a candidate.
* ``evaluate`` prices the wave rollout: base fleet billed over the
  workload span, autoscaled extras over their ``extra_billed_s``
  episodes, spot reclamation folded into task durations in expectation
  (:func:`~repro_torch.cloud.pricing.spot_inflation` inside the simulator).
* ``exact_cost`` runs the DES with the real reclaim/provision event
  processes and bills the recorded per-node online episodes
  (:func:`~repro_torch.cloud.pricing.bill_workload`).  A workload that cannot
  finish raises ``UnfinishedWorkloadError``; a workload that finishes
  but misses the SLO raises :class:`SloUnmetError` — both subclass
  :class:`repro_torch.search.ExactCostUnavailable`, so fallback paths skip
  the candidate loudly instead of reporting a silent number.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.compat import search_devices
from repro_torch.core.hadoop.simulator import SimConfig
from repro_torch.search.evaluator import (
    Evaluator,
    ExactCostUnavailable,
    NotDifferentiableError,
    SearchResult,
    masked_total,
    pad_block,
    split_overrides,
)
from repro_torch.spec import Axis, ParamSpace, Predicate, ProvisioningReport

from repro_torch.cluster.evaluator import UnfinishedWorkloadError
from repro_torch.cluster.network import Topology
from repro_torch.cluster.sched import ClusterConfig, NodeClass, simulate_workload
from repro_torch.cluster.vector_sim import (
    POLICIES,
    estimate_steps,
    pack_trace,
    simulate_batch,
)
from repro_torch.cluster.workload import (
    JobClass,
    WorkloadTrace,
    default_job_classes,
    poisson_trace,
    rescale,
)

from .autoscaler import AUTOSCALE_POLICIES, ElasticFleet
from .pricing import bill_workload

__all__ = ["CloudEvaluator", "SloUnmetError", "cloud_space"]

_SLO_EPS = 1e-9


class SloUnmetError(ExactCostUnavailable):
    """The DES finished the workload but its SLO attainment fell short of
    the evaluator's ``slo_target`` — dollars-per-job is defined but the
    fleet is not a feasible candidate, so ``exact_cost`` raises instead of
    returning a cost the search could mistake for cheap.  Subclasses
    :class:`repro_torch.search.ExactCostUnavailable`: generic fallback paths
    (top-k, descent, service) skip the candidate with a log line."""


def _fleet_has_nodes(cols: Mapping[str, np.ndarray]) -> np.ndarray:
    """``pOnDemandNodes + pSpotNodes >= 1`` — someone must run the work;
    unconstrained when either column is absent (validity_mask accepts
    partial columns)."""
    if "pOnDemandNodes" not in cols or "pSpotNodes" not in cols:
        return np.asarray(True)
    return (np.round(cols["pOnDemandNodes"])
            + np.round(cols["pSpotNodes"])) >= 1


def _reclaim_needs_spot(cols: Mapping[str, np.ndarray]) -> np.ndarray:
    """A positive ``spotReclaimRate`` with zero spot nodes is a nonsense
    config (the reclaim process has nothing to act on) — masked instead of
    silently ignored.  Spot nodes with rate 0 stay valid: cheap capacity
    that happens never to be reclaimed."""
    if "spotReclaimRate" not in cols or "pSpotNodes" not in cols:
        return np.asarray(True)
    return (cols["spotReclaimRate"] <= 0) | (np.round(cols["pSpotNodes"]) > 0)


def _racks_fit_fleet(cols: Mapping[str, np.ndarray]) -> np.ndarray:
    """``pNumRacks <= pOnDemandNodes + pSpotNodes`` — an empty rack is a
    mis-specified topology, not a bigger fleet."""
    if ("pNumRacks" not in cols or "pOnDemandNodes" not in cols
            or "pSpotNodes" not in cols):
        return np.asarray(True)
    return cols["pNumRacks"] <= cols["pOnDemandNodes"] + cols["pSpotNodes"]


@functools.lru_cache(maxsize=None)
def cloud_space() -> ParamSpace:
    """The elastic capacity planner's searchable axes.

    The bounds ARE the feasibility rule: node counts >= 0 with at least
    one node total (a cross-axis :class:`Predicate`), slots >= 1, a
    positive offered rate, reclaim rate >= 0 (and only meaningful with
    spot capacity — the second predicate), a policy code in range for
    both the scheduler and the autoscaler, and a positive SLO bound.
    """
    return ParamSpace([
        Axis("pOnDemandNodes", kind="int", lower=0, group="cloud",
             doc="on-demand (never reclaimed) nodes in the priced fleet"),
        Axis("pSpotNodes", kind="int", lower=0, group="cloud",
             doc="spot (reclaimable, cheaper) nodes in the priced fleet"),
        Axis("pMaxMapsPerNode", kind="int", lower=1, table="Table 1",
             group="cloud", doc="map slots per node"),
        Axis("pMaxRedPerNode", kind="int", lower=1, table="Table 1",
             group="cloud", doc="reduce slots per node"),
        Axis("pReduceSlowstart", kind="float", lower=None, unit="fraction",
             table="Table 1", group="cloud",
             doc="map completion fraction before reducers launch"),
        Axis("arrivalRate", kind="float", lower=0, lower_open=True,
             unit="jobs/s", group="cloud",
             doc="offered load the unit-rate trace is rescaled to"),
        Axis("schedPolicy", kind="int", lower=0, upper=3, group="cloud",
             doc="0 fifo | 1 fair | 2 fair_preempt | 3 capacity"),
        Axis("spotReclaimRate", kind="float", lower=0, unit="1/s",
             group="cloud",
             doc="exponential reclaim rate of every spot node (0 = never)"),
        Axis("autoscalePolicy", kind="int", lower=0, upper=2, group="cloud",
             doc="0 off | 1 queue (high-water trigger) | 2 predicted "
                 "(provision up front)"),
        Axis("autoscaleHighWater", kind="float", lower=0, unit="slots",
             group="cloud",
             doc="unmet-demand slots that trigger the queue policy"),
        Axis("sloLatency", kind="float", lower=0, lower_open=True, unit="s",
             group="cloud",
             doc="per-job latency bound; attainment is the fraction of "
                 "jobs at or under it"),
        Axis("pNumRacks", kind="int", lower=1, group="cloud",
             doc="racks the fleet is striped across (1 = flat network)"),
        Axis("crossRackBw", kind="float", lower=0, lower_open=True,
             unit="x nominal", group="cloud",
             doc="aggregate core-uplink bandwidth per rack, in units of one "
                 "flow's nominal rate (inf = never the bottleneck)"),
        Axis("oversubscription", kind="float", lower=1, group="cloud",
             doc="top-of-rack oversubscription factor dividing crossRackBw"),
    ], predicates=[
        Predicate("fleet has nodes", _fleet_has_nodes,
                  doc="on-demand + spot node count must be >= 1"),
        Predicate("reclaim rate needs spot capacity", _reclaim_needs_spot,
                  doc="a positive spotReclaimRate requires spot nodes"),
        Predicate("racks within fleet", _racks_fit_fleet,
                  doc="at least one node per rack"),
    ])


class CloudEvaluator(Evaluator):
    """Batched dollars-under-SLO evaluation over candidate priced fleets.

    Parameters
    ----------
    classes / traces / n_jobs / n_seeds / trace_seed : the workload, as in
        :class:`~repro_torch.cluster.evaluator.ClusterEvaluator` — cost is
        averaged over the traces.
    base : cluster defaults for the non-priced knobs (slots, scheduler,
        slowstart).  Must be a homogeneous base (no ``node_classes``) —
        the fleet mix is what the price axes search over.
    base_rate : default offered load (jobs/s; ``arrivalRate`` override).
    on_demand_price / spot_price : $/hour per node of each class.
    elastic : provisioning lifecycle + autoscaler defaults
        (:class:`~repro_torch.cloud.autoscaler.ElasticFleet`); the
        ``autoscalePolicy`` / ``autoscaleHighWater`` / ``spotReclaimRate``
        axes override its policy, trigger and rate per candidate.  Extra
        nodes bill at ``elastic.extra_hourly_price``, default the
        on-demand price.
    slo_target : required SLO attainment fraction (default 0.95) for a
        candidate to be costed at all — below it, ``c_cost`` is inf.
    sim : DES :class:`SimConfig` for ``exact_cost``.
    chunk : rows per batched call (rounded up to the device count).
    devices : where the wave rollout runs, split row-wise
        (:func:`repro_torch.compat.search_devices`; default every CUDA card,
        raising without one).  ``device="cpu"`` is ``devices=["cpu"]``.
    """

    def __init__(
        self,
        classes: Sequence[JobClass] | None = None,
        *,
        traces: Sequence[WorkloadTrace] | None = None,
        n_jobs: int = 32,
        n_seeds: int = 2,
        trace_seed: int = 0,
        base: ClusterConfig = ClusterConfig(),
        base_rate: float = 0.1,
        on_demand_price: float = 0.40,
        spot_price: float = 0.10,
        elastic: ElasticFleet = ElasticFleet(),
        slo_target: float = 0.95,
        capacities: Mapping[str, float] | None = None,
        sim: SimConfig = SimConfig(),
        chunk: int = 256,
        devices=None,
        device=None,
    ):
        if base.node_classes:
            raise ValueError(
                "CloudEvaluator's pOnDemandNodes/pSpotNodes axes define the "
                "fleet mix; pass a homogeneous base (no node_classes) and "
                "search the mix instead"
            )
        if on_demand_price < 0 or spot_price < 0:
            raise ValueError("hourly prices must be >= 0")
        if not 0.0 <= slo_target <= 1.0:
            raise ValueError("slo_target is a fraction in [0, 1]")
        self.classes = list(classes) if classes is not None \
            else default_job_classes()
        self.traces = list(traces) if traces is not None else [
            poisson_trace(self.classes, n_jobs, rate=1.0, seed=trace_seed + s)
            for s in range(n_seeds)
        ]
        packed = [pack_trace(t) for t in self.traces]
        #: (S, J) per-job constants shared by every scenario
        self._cols = {k: np.stack([p[k] for p in packed]) for k in packed[0]}
        self._base = base
        self._sim = sim
        self.on_demand_price = float(on_demand_price)
        self.spot_price = float(spot_price)
        self.slo_target = float(slo_target)
        self.elastic = elastic if elastic.extra_hourly_price is not None \
            else dataclasses.replace(
                elastic, extra_hourly_price=float(on_demand_price))
        self.capacities = dict(capacities) if capacities else {}
        # capacity-scheduler queues, exactly the ClusterEvaluator rule:
        # one global name universe, per-trace guarantees normalized over
        # the classes PRESENT in that trace
        qnames = sorted({jc.name for jc in self.classes}
                        | {a.klass.name for t in self.traces
                           for a in t.arrivals})
        qidx = {name: i for i, name in enumerate(qnames)}
        self._queue_cols = np.stack([
            np.asarray([qidx[a.klass.name] for a in t.arrivals], np.float64)
            for t in self.traces
        ])                                                      # (S, J)
        fracs = np.zeros((len(self.traces), len(qnames)))
        for s, t in enumerate(self.traces):
            present = sorted({a.klass.name for a in t.arrivals})
            w = {q: self.capacities.get(q, 1.0) for q in present}
            tot = sum(w.values()) or 1.0
            for q in present:
                fracs[s, qidx[q]] = w[q] / tot
        self._queue_fracs = fracs                               # (S, Q)
        if devices is None and device is not None:
            devices = [device]
        self._devs = tuple(search_devices(devices))
        self.num_devices = len(self._devs)
        self.chunk = -(-max(chunk, 1) // self.num_devices) * self.num_devices
        # host-side float64 scalars: the knobs are turned into scenario
        # columns on the host; only the rollout runs on the devices
        f64 = lambda v: torch.tensor(v, dtype=torch.float64)
        self.base_cfg = {
            "pOnDemandNodes": f64(float(base.num_nodes)),
            "pSpotNodes": f64(0.0),
            "pMaxMapsPerNode": f64(float(base.map_slots_per_node)),
            "pMaxRedPerNode": f64(float(base.reduce_slots_per_node)),
            "pReduceSlowstart": f64(float(base.reduce_slowstart)),
            "arrivalRate": f64(float(base_rate)),
            "schedPolicy": f64(float(POLICIES.index(base.scheduler))),
            "spotReclaimRate": f64(float(self.elastic.reclaim_rate)),
            "autoscalePolicy": f64(float(self.elastic.policy_code)),
            "autoscaleHighWater": f64(float(self.elastic.high_water)),
            "sloLatency": f64(float("inf")),
            "pNumRacks": f64(
                float(base.topology.num_racks if base.topology else 1)),
            "crossRackBw": f64(
                float(base.topology.cross_rack_bw if base.topology
                      else float("inf"))),
            "oversubscription": f64(
                float(base.topology.oversub if base.topology else 1.0)),
        }

    # ---------------- Evaluator interface ----------------

    @property
    def cost_key(self) -> str:
        return "c_cost"

    @property
    def param_space(self) -> ParamSpace:
        """Declared cloud axes — the single source of the knob mask."""
        return cloud_space()

    def grad_objective(self):
        raise NotDifferentiableError(
            "the dollar cost rides the discrete-event workload rollout "
            "(wave counts, reclaim/provision events) — piecewise-constant "
            "in every knob; gradient strategies fall back to coordinate "
            "descent here.  The pricing arithmetic itself IS differentiable "
            "and is registered as the 'cloud-pricing' analysis target."
        )

    def evaluate(self, overrides: Mapping[str, Any]) -> SearchResult:
        batched, static, n = split_overrides(self.base_cfg, overrides)
        out_blocks: dict[str, list[np.ndarray]] = {}
        for start in range(0, n, self.chunk):
            stop = min(start + self.chunk, n)
            rows, _ = pad_block(batched, start, stop, self.chunk)
            out = self._evaluate_rows(rows, static)
            for k, v in out.items():
                out_blocks.setdefault(k, []).append(v[: stop - start])
        outputs = {k: np.concatenate(v) for k, v in out_blocks.items()}
        total = masked_total(outputs, self.cost_key)
        return SearchResult(overrides={k: v.numpy() for k, v in batched.items()},
                            outputs=outputs, total_cost=total)

    def report(self, overrides) -> ProvisioningReport:
        """Typed evaluation: an overrides mapping (the ``api.sweep``
        convention) or an already-computed :class:`SearchResult`, lifted
        into the :class:`~repro_torch.spec.ProvisioningReport` view."""
        result = overrides if isinstance(overrides, SearchResult) \
            else self.evaluate(overrides)
        return ProvisioningReport.from_outputs(result.outputs)

    def _resolve_config(
        self, cfg: Mapping[str, float]
    ) -> tuple[ClusterConfig, ElasticFleet] | None:
        """A flat assignment -> (cluster, elastic fleet), or ``None`` when
        the knobs violate the declared axis bounds / predicates."""
        od = int(round(cfg["pOnDemandNodes"]))
        sp = int(round(cfg["pSpotNodes"]))
        mpn = int(round(cfg["pMaxMapsPerNode"]))
        rpn = int(round(cfg["pMaxRedPerNode"]))
        poli = int(round(cfg["schedPolicy"]))
        rr = float(cfg["spotReclaimRate"])
        xpol = int(round(cfg["autoscalePolicy"]))
        hw = float(cfg["autoscaleHighWater"])
        slo = float(cfg["sloLatency"])
        racks = int(round(cfg["pNumRacks"]))
        xbw = float(cfg["crossRackBw"])
        osub = float(cfg["oversubscription"])
        if (od < 0 or sp < 0 or od + sp < 1 or mpn < 1 or rpn < 1
                or cfg["arrivalRate"] <= 0
                or not 0 <= poli < len(POLICIES)
                or rr < 0 or (rr > 0 and sp == 0)
                or not 0 <= xpol < len(AUTOSCALE_POLICIES)
                or hw < 0 or slo <= 0
                or racks < 1 or racks > od + sp or xbw <= 0 or osub < 1.0):
            return None
        fleet = ()
        if sp > 0:                  # spot first — the wave class-column order
            fleet += (NodeClass(sp, 1.0, self.spot_price, spot=True),)
        if od > 0:
            fleet += (NodeClass(od, 1.0, self.on_demand_price, spot=False),)
        cc = ClusterConfig(
            num_nodes=od + sp,
            map_slots_per_node=mpn, reduce_slots_per_node=rpn,
            scheduler=POLICIES[poli],
            reduce_slowstart=float(cfg["pReduceSlowstart"]),
            node_classes=fleet,
            capacities=tuple(sorted(self.capacities.items())),
            topology=Topology(num_racks=racks, cross_rack_bw=xbw,
                              oversub=osub) if racks > 1 else None,
        )
        el = dataclasses.replace(
            self.elastic, policy=AUTOSCALE_POLICIES[xpol],
            high_water=hw, reclaim_rate=rr)
        return cc, el

    def exact_cost(self, assignment: Mapping[str, float]) -> float:
        """The DES with real reclaim/provision events, billed per episode.

        The same objective as ``evaluate``: mean dollars-per-job over the
        traces.  Raises :class:`UnfinishedWorkloadError` when a trace
        cannot finish, :class:`SloUnmetError` when mean attainment misses
        ``slo_target`` — never a silent inf.
        """
        cfg = {k: float(v) for k, v in self.base_cfg.items()}
        for k, v in assignment.items():
            if k not in cfg:
                raise KeyError(f"unknown config key: {k!r}")
            cfg[k] = float(v)
        resolved = self._resolve_config(cfg)
        if resolved is None:
            return float("inf")
        cc, el = resolved
        rate, slo = cfg["arrivalRate"], cfg["sloLatency"]
        dpj, attain = [], []
        for tr in self.traces:
            res = simulate_workload(rescale(tr, rate), cc, self._sim,
                                    elastic=el)
            if res.n_unfinished:
                raise UnfinishedWorkloadError(
                    f"{res.n_unfinished}/{len(res.jobs)} jobs never finished "
                    f"on {cc} — dollars-per-job is undefined; inspect "
                    "WorkloadResult.n_unfinished"
                )
            # bill from the first submit (the wave span's origin) to the
            # last finish, so both backends price the same window
            first = min(j.submit_time for j in res.jobs)
            dollars = bill_workload(res, cc, elastic=el,
                                    window=(first, res.makespan))
            dpj.append(dollars / max(len(res.jobs), 1))
            attain.append(float((res.latencies() <= slo).mean()))
        if float(np.mean(attain)) < self.slo_target - _SLO_EPS:
            raise SloUnmetError(
                f"SLO attainment {np.mean(attain):.3f} < target "
                f"{self.slo_target} at sloLatency={slo} — this fleet is "
                "not a feasible candidate"
            )
        return float(np.mean(dpj))

    # ---------------- internals ----------------

    def _evaluate_rows(self, rows: Mapping[str, np.ndarray],
                       static: Mapping[str, float]) -> dict[str, np.ndarray]:
        """One padded chunk -> per-row metrics (row x trace scenarios)."""
        b = self.chunk
        col = lambda k: rows[k].numpy() if k in rows \
            else np.full(b, float(static[k]))
        od = np.round(col("pOnDemandNodes"))
        sp = np.round(col("pSpotNodes"))
        mpn = np.round(col("pMaxMapsPerNode"))
        rpn = np.round(col("pMaxRedPerNode"))
        slow = col("pReduceSlowstart")
        rate = col("arrivalRate")
        pol = np.round(col("schedPolicy"))
        rr = col("spotReclaimRate")
        xpol = np.round(col("autoscalePolicy"))
        hw = col("autoscaleHighWater")
        slo = col("sloLatency")
        # the declared axis bounds + predicates ARE the mask
        ok, _ = self.param_space.validity_mask(
            {k: col(k) for k in self.base_cfg})
        # invalid rows still ride the batched rollout — sanitize their knobs
        # so a zero-slot lane cannot pin the whole chunk at the step cap
        od_s = np.maximum(od, 0.0)
        sp_s = np.maximum(sp, 0.0)
        od_s = np.where(od_s + sp_s < 1.0, 1.0, od_s)
        total_s = od_s + sp_s
        mpn_s = np.maximum(mpn, 1.0)
        rpn_s = np.maximum(rpn, 1.0)
        rate_s = np.where(rate > 0, rate, 1.0)
        pol_s = np.clip(pol, 0.0, float(len(POLICIES) - 1))
        rr_s = np.where(sp_s > 0, np.maximum(rr, 0.0), 0.0)
        xpol_s = np.clip(xpol, 0.0, float(len(AUTOSCALE_POLICIES) - 1))
        hw_s = np.maximum(hw, 0.0)
        slo_s = np.where(slo > 0, slo, np.inf)
        racks_s = np.clip(np.round(col("pNumRacks")), 1.0, total_s)
        xbw = col("crossRackBw")
        xbw_s = np.where(xbw > 0, xbw, np.inf)
        osub_s = np.maximum(col("oversubscription"), 1.0)

        el = self.elastic
        extra_on = np.where(xpol_s > 0.5, float(el.max_extra_nodes), 0.0)
        cols, s = self._cols, len(self.traces)
        rep = lambda a: np.repeat(a[:, None], s, axis=1).reshape(b * s)
        rep2 = lambda a: np.repeat(a, s, axis=0)        # (b, C) -> (b*s, C)
        perjob = lambda a: np.broadcast_to(
            a[None], (b,) + a.shape).reshape(b * s, -1)
        frac = (total_s - 1.0) / total_s
        scen = {
            "arrival": perjob(cols["arrival"]) / rep(rate_s)[:, None],
            "n_maps": perjob(cols["n_maps"]),
            "n_reds": perjob(cols["n_reds"]),
            "map_cost": perjob(cols["map_cost"]),
            "red_work": perjob(cols["red_work"]),
            "shuffle": perjob(cols["shuffle"]) * rep(frac)[:, None],
            "policy": rep(pol_s),
            "slowstart": rep(slow),
            "queue": perjob(self._queue_cols),
            "queue_frac": np.tile(self._queue_fracs, (b, 1)),
            # two class columns, spot first (both baseline speed — the
            # stable fastest-first sort keeps the declared order, and
            # autoscaled extra capacity joins the LAST = on-demand column)
            "map_slots": rep2(np.stack([sp_s * mpn_s, od_s * mpn_s], 1)),
            "red_slots": rep2(np.stack([sp_s * rpn_s, od_s * rpn_s], 1)),
            "speedup": rep2(np.stack(
                [np.ones_like(sp_s), np.ones_like(od_s)], axis=1)),
            "reclaim_rate": rep2(np.stack([rr_s, np.zeros_like(rr_s)], 1)),
            "autoscale": rep(xpol_s),
            "high_water": rep(hw_s),
            "provision_latency": rep(
                np.full(b, float(el.provision_latency))),
            "extra_map_slots": rep(extra_on * mpn_s),
            "extra_red_slots": rep(extra_on * rpn_s),
            "billing_quantum": rep(np.full(b, float(el.billing_quantum))),
            "topo_racks": rep(racks_s),
            "topo_cross_bw": rep(xbw_s),
            "topo_oversub": rep(osub_s),
        }
        if "dep" in cols:
            scen["dep"] = perjob(cols["dep"])
            scen["dep_kind"] = perjob(cols["dep_kind"])
        out = simulate_batch(scen, n_steps=estimate_steps(scen),
                             devices=self._devs)
        shp = (b, s)
        lat = np.asarray(out["latency"]).reshape(b, s, -1)      # (b, S, J)
        attain = np.where(
            np.isfinite(lat), lat <= rep(slo_s).reshape(b, s, 1), 0.0
        ).mean(axis=(1, 2))
        span = np.asarray(out["makespan"]).reshape(shp)         # (b, S)
        billed = np.asarray(out.get(
            "extra_billed_s", np.zeros(b * s))).reshape(shp)
        quantum = float(el.billing_quantum)
        if quantum > 0:
            span_b = np.ceil(span / quantum) * quantum
        else:
            span_b = span
        fleet_rate = sp_s * self.spot_price + od_s * self.on_demand_price
        extra_price = float(el.extra_hourly_price or 0.0)
        dollars = (fleet_rate[:, None] * span_b
                   + extra_price * extra_on[:, None] * billed) / 3600.0
        n_jobs = lat.shape[-1]
        dpj = (dollars / n_jobs).mean(axis=1)
        conv = np.asarray(out["converged"]).reshape(shp).min(axis=1)
        feasible = attain >= self.slo_target - _SLO_EPS
        return {
            "c_dollarsPerJob": dpj.astype(np.float64),
            "c_dollarMakespan": dollars.mean(axis=1).astype(np.float64),
            "c_sloAttain": attain.astype(np.float64),
            "c_meanLat": np.asarray(out["mean_latency"]).reshape(shp)
            .mean(axis=1).astype(np.float64),
            "c_p95Lat": np.asarray(out["p95_latency"]).reshape(shp)
            .mean(axis=1).astype(np.float64),
            "c_util": np.asarray(out["utilization"]).reshape(shp)
            .mean(axis=1).astype(np.float64),
            # the objective: dollars-per-job where the SLO holds, inf where
            # it does not — an infeasible fleet is never "cheap"
            "c_cost": np.where(feasible, dpj, np.inf).astype(np.float64),
            "valid": (ok & (conv > 0)).astype(np.float64),
        }
