"""The analyzer's trace targets: the port's registered cost models and the
closures that are differentiated.

A :class:`TraceTarget` packages a builder that traces a callable into an aten
graph (:func:`repro_torch.analysis.absint.trace`, ``make_fx`` on real tensors
on the analysis device) and the per-input
:class:`~repro_torch.analysis.interval.Interval` abstraction (from
:mod:`repro_torch.spec.axes` bounds where declared).  Checkers consume the
traced graph; nothing here runs model math beyond tracing.

Targets, the reference's (``repro/analysis/targets.py``):

* ``hadoop-model``  — the branch-free job model (Eqs. 1-98),
  :func:`repro_torch.core.hadoop.model.job_model_torch`, over the physical
  domain of :func:`repro_torch.spec.hadoop_space`.
* ``hadoop-grad``   — the same graph cut to its ``j_totalCost`` output
  (``eliminate_dead_code``): the path gradient search differentiates.
* ``calib-loss``    — :func:`repro_torch.calib.fit.build_loss_fn` over two
  canonical observations, every Table-3 factor in its unconstrained space
  (grad mode).
* ``tuner-objective`` — the relaxed cost
  :func:`repro_torch.search.strategies.build_relaxed_objective` gives
  gradient search, over three axes in their unconstrained space (grad
  mode).
* ``cloud-pricing`` — the differentiable dollar path
  (:func:`repro_torch.cloud.pricing.spot_inflation` x
  :func:`~repro_torch.cloud.pricing.dollars_for`), traced with a concrete
  zero billing quantum so it stays ceil-free (grad mode).
* ``network-model`` — :func:`repro_torch.cluster.network.effective_bandwidth`,
  the incast-contention factor the job model's topology hook divides
  Eq. 91's netCost by (grad mode).
* ``cluster-rollout`` — the wave rollout
  (:func:`repro_torch.cluster.vector_sim.rollout_program`) with every
  scheduler branch compiled in (fair, preemptive, capacity), over the
  reference's scenario domain.  The rollout is a host loop over scheduling
  rounds, so it is traced as a
  :class:`~repro_torch.analysis.absint.LoopGraphs` (the state before the
  first round, one round with finished rows frozen, the outputs) and
  walked to the loop's fixpoint with widening
  (:func:`~repro_torch.analysis.absint.analyze_loop`).
* ``cloud-rollout`` — the same with the elastic-fleet branch compiled in
  (spot reclamation, autoscaling, episode billing).
* ``tpu-model``     — a pure-numpy table model, not traceable at all, as in
  the reference.
"""

from __future__ import annotations

import copy
import math
import time
from dataclasses import dataclass
from typing import Any, Callable

from .interval import BOOL, FINITE_TOP, Interval

__all__ = ["TraceTarget", "Traced", "iter_targets", "trace_target",
           "cut_to_outputs"]


@dataclass
class Traced:
    """One traced target: its graph, the input intervals (one per
    placeholder), the output names, the example arguments as they crossed
    the trace boundary, and the seconds tracing took."""

    graph: Any                      # torch.fx.GraphModule, or absint.LoopGraphs
    intervals: list[Interval]
    out_names: tuple[str, ...]
    args: tuple
    seconds: float = 0.0

    @property
    def n_nodes(self) -> int:
        """Graph nodes traced (a loop's: its three graphs together)."""
        g = self.graph
        return g.n_nodes if hasattr(g, "n_nodes") else len(g.graph.nodes)


@dataclass
class TraceTarget:
    name: str
    doc: str
    traceable: bool = True
    grad_mode: bool = False
    #: device -> (graph, intervals, out_names, args); tracing is not free
    build: Callable | None = None
    skip_reason: str = ""


def _axis_interval(ax) -> Interval:
    if ax.kind == "bool":
        return BOOL
    return Interval.bounded(ax.lower, ax.upper, getattr(ax, "lower_open", False))


def cut_to_outputs(gm, keep: list[int]):
    """A copy of ``gm`` whose outputs are the kept indices of its flat output
    list, dead code eliminated: the analyzer's way of restricting a graph to
    the differentiated path (the cost, not the validity flags)."""
    import torch

    graph = copy.deepcopy(gm.graph)
    out = next(n for n in graph.nodes if n.op == "output")
    flat = out.args[0]
    out.args = ([flat[i] for i in keep],)
    graph.eliminate_dead_code()
    return torch.fx.GraphModule(gm, graph)


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------


def _hadoop_cfg_and_intervals(device):
    from repro_torch.core.hadoop.model import pack_config
    from repro_torch.core.hadoop.params import (CostFactors, HadoopParams,
                                                ProfileStats)
    from repro_torch.spec import hadoop_space

    cfg = pack_config(HadoopParams(), ProfileStats(), CostFactors(),
                      device=device)
    space = hadoop_space()
    keys = sorted(cfg)
    intervals = [_axis_interval(space[k]) if k in space
                 else Interval(0.0, math.inf, False, True) for k in keys]
    return keys, cfg, intervals


def _build_hadoop_model(device):
    from repro_torch.core.hadoop.model import job_model_torch

    from .absint import trace

    keys, cfg, intervals = _hadoop_cfg_and_intervals(device)
    names: list[str] = []

    def fn(*xs):
        out = job_model_torch(dict(zip(keys, xs)))
        names[:] = sorted(out)
        return [out[k] for k in names]

    args = tuple(cfg[k] for k in keys)
    return trace(fn, *args), intervals, tuple(names), args


def _build_hadoop_grad(device):
    # exactly gradient search's differentiated output: the raw total cost
    gm, intervals, names, args = _build_hadoop_model(device)
    cut = cut_to_outputs(gm, [names.index("j_totalCost")])
    return cut, intervals, ("j_totalCost",), args


def _canonical_observations():
    from repro_torch.calib import Observation
    from repro_torch.spec import JobSpec

    return [Observation(spec=JobSpec(), cost=100.0 + 10.0 * i) for i in range(2)]


def _build_calib_loss(device):
    import torch

    from repro_torch.calib.fit import COST_FACTOR_NAMES, _stack_configs, build_loss_fn

    from .absint import trace

    obs = _canonical_observations()
    cols = _stack_configs(obs, dtype=torch.float64, device=device)
    y = torch.tensor([o.cost for o in obs], dtype=torch.float64, device=device)
    w = torch.tensor([o.weight for o in obs], dtype=torch.float64, device=device)
    names = list(COST_FACTOR_NAMES)
    loss = build_loss_fn(cols, names, y, w)

    def fn(*us):
        return loss(dict(zip(names, us)))

    args = tuple(torch.zeros((), dtype=torch.float64, device=device)
                 for _ in names)
    # the unconstrained optimizer space
    return trace(fn, *args), [FINITE_TOP for _ in names], ("loss",), args


def _build_tuner_objective(device):
    import torch

    from repro_torch.core.hadoop.params import (CostFactors, HadoopParams,
                                                ProfileStats)
    from repro_torch.search.evaluator import ChunkedEvaluator
    from repro_torch.search.strategies import build_relaxed_objective

    from .absint import trace

    ev = ChunkedEvaluator(HadoopParams(), ProfileStats(), CostFactors(),
                          chunk=16, device=device)
    space = {
        "pSortMB": [50.0, 100.0, 200.0],
        "pSortFactor": [5.0, 10.0, 50.0],
        "pSpillPerc": [0.5, 0.8, 0.95],
    }
    raw_cost, _axes, keys = build_relaxed_objective(ev, space)

    def fn(*us):
        return raw_cost(dict(zip(keys, us)))

    args = tuple(torch.zeros((), dtype=torch.float64, device=device)
                 for _ in keys)
    return trace(fn, *args), [FINITE_TOP for _ in keys], ("cost",), args


def _build_cloud_pricing(device):
    import torch

    from repro_torch.cloud.pricing import dollars_for, spot_inflation

    from .absint import trace

    C = 2
    f64 = dict(dtype=torch.float64, device=device)
    a = {
        "counts": torch.ones((C,), **f64),
        "prices": torch.full((C,), 0.4, **f64),
        "rate": torch.full((C,), 1e-4, **f64),
        "span": torch.tensor(3600.0, **f64),
        "task_s": torch.tensor(30.0, **f64),
    }
    ivals = {
        "counts": Interval(0.0, math.inf, False, True),
        "prices": Interval(0.0, math.inf, False, True),
        "rate": Interval(0.0, math.inf, False, True),
        "span": Interval(0.0, math.inf, False, True),
        "task_s": Interval(0.0, math.inf, True, True),
    }
    keys = sorted(a)
    eye = torch.eye(C, **f64)

    # the expected dollar cost of a spot fleet: the wall-clock span
    # inflates by the reclamation model, the fleet rate prices it.  A
    # concrete billing_quantum=0 keeps the path ceil-free — exactly the
    # differentiable surface spot_planning sensitivity studies use.
    def fn(*xs):
        arg = dict(zip(keys, xs))
        infl = spot_inflation(arg["rate"], arg["task_s"])
        # per-class: counts[c] * prices[c] * span * infl[c] / 3600
        per_class = dollars_for(
            arg["span"] * infl, arg["counts"] * eye, arg["prices"])
        return per_class.sum()

    args = tuple(a[k] for k in keys)
    return trace(fn, *args), [ivals[k] for k in keys], ("dollars",), args


def _build_network_model(device):
    import torch

    from repro_torch.cluster.network import effective_bandwidth

    from .absint import trace

    f64 = dict(dtype=torch.float64, device=device)
    a = {
        "pNumRacks": torch.tensor(4.0, **f64),
        "crossRackBw": torch.tensor(2.0, **f64),
        "oversubscription": torch.tensor(2.0, **f64),
        "nFlows": torch.tensor(8.0, **f64),
    }
    ivals = {
        "pNumRacks": Interval(1.0, math.inf, False, True),
        "crossRackBw": Interval(0.0, math.inf, True, True),
        "oversubscription": Interval(1.0, math.inf, False, True),
        "nFlows": Interval(0.0, math.inf, False, True),
    }
    keys = sorted(a)

    # the effective shuffle bandwidth dividing Eq. 91's netCost in the
    # closed-form topology hook — the surface pNumRacks / crossRackBw /
    # oversubscription gradients flow through
    def fn(*xs):
        arg = dict(zip(keys, xs))
        return effective_bandwidth(
            arg["pNumRacks"], arg["crossRackBw"],
            arg["oversubscription"], arg["nFlows"])

    args = tuple(a[k] for k in keys)
    return trace(fn, *args), [ivals[k] for k in keys], ("bandwidth",), args


def _rollout_columns(device, cloud: bool):
    """One scenario (B 1) of 3 jobs, 2 node classes and 2 capacity queues,
    and each column's domain: the reference's rollout targets."""
    import torch

    J, C, Q = 3, 2, 2
    f64 = dict(dtype=torch.float64, device=device)
    nonneg = Interval(0.0, math.inf, False, True)
    cols = {
        "arrival": (torch.zeros((1, J), **f64), nonneg),
        "n_maps": (torch.ones((1, J), **f64), nonneg),
        "n_reds": (torch.ones((1, J), **f64), nonneg),
        "map_cost": (torch.ones((1, J), **f64), nonneg),
        "red_work": (torch.ones((1, J), **f64), nonneg),
        "shuffle": (torch.ones((1, J), **f64), nonneg),
        "queue": (torch.zeros((1, J), **f64), Interval(0.0, float(Q - 1))),
        "map_slots": (torch.ones((1, C), **f64), nonneg),
        "red_slots": (torch.ones((1, C), **f64), nonneg),
        "speedup": (torch.ones((1, C), **f64), Interval(1.0, math.inf, False, True)),
        "policy": (torch.zeros((1,), **f64), Interval(0.0, 3.0)),
        "slowstart": (torch.full((1,), 0.05, **f64), Interval(0.0, 1.0)),
        "queue_frac": (torch.full((1, Q), 0.5, **f64), Interval(0.0, 1.0)),
    }
    if cloud:
        cols.update({
            "reclaim_rate": (torch.full((1, C), 1e-4, **f64), nonneg),
            "autoscale": (torch.ones((1,), **f64), Interval(0.0, 2.0)),
            "high_water": (torch.full((1,), 2.0, **f64), nonneg),
            "provision_latency": (torch.full((1,), 5.0, **f64), nonneg),
            "extra_map_slots": (torch.full((1,), 2.0, **f64), nonneg),
            "extra_red_slots": (torch.full((1,), 2.0, **f64), nonneg),
            "billing_quantum": (torch.full((1,), 60.0, **f64), nonneg),
        })
    return cols


def _build_rollout(device, *, cloud: bool):
    from repro_torch.cluster.vector_sim import frozen_round, rollout_program

    from .absint import LoopGraphs, trace

    cols = _rollout_columns(device, cloud)
    keys = sorted(cols)
    flags = dict(with_fair=True, with_preempt=True, with_capacity=True,
                 with_cloud=cloud, with_dag=False, with_topo=False)
    args = tuple(cols[k][0] for k in keys)
    state0 = rollout_program(dict(zip(keys, args)), **flags).state0
    st_keys = sorted(state0)
    # distinct tensors: make_fx maps each example tensor to one placeholder,
    # and state0 shares its zeros and infs between several state entries
    st_args = tuple(state0[k].clone() for k in st_keys)
    n = len(keys)
    names: list[str] = []

    def program(xs):
        return rollout_program(dict(zip(keys, xs)), **flags)

    def init(*xs):
        st = program(xs).state0
        return [st[k] for k in st_keys]

    def body(*a):
        nxt = frozen_round(program(a[:n]), dict(zip(st_keys, a[n:])))
        return [nxt[k] for k in st_keys]

    def finish(*a):
        out = program(a[:n]).finish(dict(zip(st_keys, a[n:])))
        names[:] = sorted(out)
        return [out[k] for k in names]

    loop = LoopGraphs(trace(init, *args), trace(body, *args, *st_args),
                      trace(finish, *args, *st_args))
    return loop, [cols[k][1] for k in keys], tuple(names), args


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def iter_targets() -> list[TraceTarget]:
    """All analyzer targets, untraced (call :func:`trace_target` per item)."""
    return [
        TraceTarget(
            name="hadoop-model",
            doc="full job model (Eqs. 1-98) over the physical axis domain",
            build=_build_hadoop_model,
        ),
        TraceTarget(
            name="hadoop-grad",
            doc="the j_totalCost path gradient search differentiates",
            build=_build_hadoop_grad,
            grad_mode=True,
        ),
        TraceTarget(
            name="calib-loss",
            doc="repro_torch.calib.build_loss_fn over canonical observations",
            build=_build_calib_loss,
            grad_mode=True,
        ),
        TraceTarget(
            name="tuner-objective",
            doc="build_relaxed_objective raw cost (gradient_descent_ev)",
            build=_build_tuner_objective,
            grad_mode=True,
        ),
        TraceTarget(
            name="cluster-rollout",
            doc="the wave simulator's rollout, all policies compiled in",
            build=lambda device: _build_rollout(device, cloud=False),
        ),
        TraceTarget(
            name="cloud-rollout",
            doc="the wave rollout with the elastic-fleet path compiled in "
                "(spot reclamation, autoscaling, episode billing)",
            build=lambda device: _build_rollout(device, cloud=True),
        ),
        TraceTarget(
            name="cloud-pricing",
            doc="the differentiable spot-pricing path (spot_inflation x "
                "dollars_for), quantum-free so grad stays clean",
            build=_build_cloud_pricing,
            grad_mode=True,
        ),
        TraceTarget(
            name="network-model",
            doc="the topology-aware effective shuffle bandwidth dividing "
                "Eq. 91's netCost (incast contention, differentiable)",
            build=_build_network_model,
            grad_mode=True,
        ),
        TraceTarget(
            name="tpu-model",
            doc="TPU step table model (registered CostModel 'tpu')",
            traceable=False,
            skip_reason=(
                "pure-numpy table model over integer mesh layouts: no graph "
                "exists to trace, as in the reference"),
        ),
    ]


def trace_target(t: TraceTarget, device) -> Traced:
    """Trace a traceable target on ``device``."""
    if not t.traceable:
        raise ValueError(f"target {t.name} is not traceable: {t.skip_reason}")
    t0 = time.perf_counter()
    gm, intervals, names, args = t.build(device)
    return Traced(gm, intervals, names, args, time.perf_counter() - t0)
