"""Search strategies over any :class:`repro_torch.search.evaluator.Evaluator`.

The paper's "find the optimal configuration" use case:

* :func:`search_topk`            — streaming exhaustive top-k over a product
  space (the primitive everything else builds on).
* :func:`grid_search_ev`         — exhaustive optimum (k=1 wrapper).
* :func:`random_search_ev`       — uniform sampling of the space.
* :func:`coordinate_descent_ev`  — per-axis sweeps to a fixpoint.
* :func:`gradient_descent_ev`    — AdamW over a continuous relaxation of
  the space, through the job model under autograd, then rounded and
  validated through the evaluator.

``grid_search`` / ``random_search`` / ``coordinate_descent`` keep the
reference's Hadoop-first signatures (re-exported by
``repro_torch.core.tuner``).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.hadoop.params import CostFactors, HadoopParams, ProfileStats
from repro_torch.obs import current as _obs_current
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.spec import Axis
from repro_torch.spec.report import invalid_reason_counts

from .evaluator import (
    Evaluator,
    ExactCostUnavailable,
    InvalidGridError,
    NotDifferentiableError,
    apply_assignment,
    cached_evaluator,
)
from .grid import iter_blocks, sample_space
from .topk import TopKAccumulator, TopKResult

__all__ = [
    "TuningResult",
    "search_topk",
    "grid_search_ev",
    "random_search_ev",
    "coordinate_descent_ev",
    "build_relaxed_objective",
    "gradient_descent_ev",
    "grid_search",
    "random_search",
    "coordinate_descent",
]

logger = logging.getLogger("repro_torch.search.strategies")


@dataclass
class TuningResult:
    best_assignment: dict[str, float]
    best_cost: float
    evaluations: int
    history: list[tuple[dict[str, float], float]] = field(default_factory=list)
    topk: TopKResult | None = None
    exact: bool = False     # best_cost came via the exact-simulator escape hatch

    def apply(self, p: HadoopParams) -> HadoopParams:
        """Materialize the winning assignment onto a HadoopParams object."""
        p2, _, _ = apply_assignment(p, ProfileStats(), CostFactors(),
                                    self.best_assignment)
        return p2


def search_topk(
    evaluator: Evaluator,
    space: Mapping[str, Sequence[float]],
    *,
    k: int = 1,
    exact_fallback: bool = True,
) -> TopKResult:
    """Stream the full Cartesian product through the evaluator in fixed-size
    blocks, reducing each block to its top-k on device and merging on host.

    Invalid (``valid == 0``) survivors of the final ranking are re-costed via
    the evaluator's exact path (simulator) rather than reported as ``inf``.
    """
    t0 = time.perf_counter()
    acc = TopKAccumulator(k)
    for start, cols in iter_blocks(space, evaluator.chunk):
        acc.update(start, cols, evaluator.chunk_topk(cols, k))
    return acc.finalize(
        evaluator,
        exact_fallback=exact_fallback,
        elapsed_s=time.perf_counter() - t0,
    )


def grid_search_ev(
    evaluator: Evaluator,
    space: Mapping[str, Sequence[float]],
    *,
    exact_fallback: bool = True,
) -> TuningResult:
    """Exhaustive optimum inside the grid (exact oracle for the others)."""
    res = search_topk(evaluator, space, k=1, exact_fallback=exact_fallback)
    best = res.best()
    return TuningResult(best.assignment, best.cost,
                        evaluations=res.n_evaluated, topk=res)


def random_search_ev(
    evaluator: Evaluator,
    space: Mapping[str, Sequence[float]],
    *,
    samples: int = 4096,
    seed: int = 0,
    exact_fallback: bool = True,
) -> TuningResult:
    """Uniform sampling; evaluated in evaluator-sized blocks like the grid."""
    t0 = time.perf_counter()
    cand = sample_space(space, samples, seed)
    acc = TopKAccumulator(1)
    for start in range(0, samples, evaluator.chunk):
        stop = min(start + evaluator.chunk, samples)
        cols = {key: v[start:stop] for key, v in cand.items()}
        acc.update(start, cols, evaluator.chunk_topk(cols, 1))
    res = acc.finalize(evaluator, exact_fallback=exact_fallback,
                       elapsed_s=time.perf_counter() - t0)
    best = res.best()
    return TuningResult(best.assignment, best.cost,
                        evaluations=samples, topk=res)


def coordinate_descent_ev(
    evaluator: Evaluator,
    space: Mapping[str, Sequence[float]],
    *,
    max_rounds: int = 8,
    exact_fallback: bool = True,
) -> TuningResult:
    """Iterate per-parameter sweeps to a fixpoint (a handful of evaluator
    calls; reaches the grid optimum when the cost model is coordinate-wise
    quasi-convex, which holds on the benchmark spaces).

    A sweep whose rows are *all* invalid (closed-form model out of domain)
    is re-costed through ``evaluator.exact_cost`` when ``exact_fallback`` is
    set, matching :func:`search_topk`.  If no finite cost is ever found the
    function raises :class:`InvalidGridError`.
    """
    keys = list(space.keys())
    assign = {k: float(space[k][len(space[k]) // 2]) for k in keys}
    evals = 0
    history: list[tuple[dict[str, float], float]] = []
    best_cost = np.inf
    best_exact = False

    for _ in range(max_rounds):
        changed = False
        for k in keys:
            cand = np.asarray(list(space[k]), dtype=np.float64)
            overrides: dict[str, np.ndarray] = {k: cand}
            for k2 in keys:
                if k2 != k:
                    overrides[k2] = np.full(len(cand), assign[k2])
            res = evaluator.evaluate(overrides)
            evals += len(cand)
            costs = np.asarray(res.total_cost, dtype=np.float64)
            swept_exact = False
            if exact_fallback and not np.isfinite(costs).any():
                # whole sweep out of the closed-form domain: cost every
                # candidate via the exact simulator instead of argmin(inf)
                base = getattr(evaluator, "base_cfg", None)
                reasons = invalid_reason_counts(
                    res.outputs,
                    {**base, **overrides} if base is not None else None,
                )
                logger.info(
                    "valid==0 exact fallback: %s sweep (%d candidates) is "
                    "entirely out of the closed-form domain; failed "
                    "constraints: %s",
                    k, len(cand),
                    ", ".join(f"{n}={c}" for n, c in reasons.items())
                    or "not reported by this backend",
                )
                exact_costs = []
                for v in cand:
                    try:
                        exact_costs.append(
                            evaluator.exact_cost({**assign, k: float(v)}))
                    except ExactCostUnavailable as e:
                        logger.info("exact fallback skipped %s=%s: %s", k, v, e)
                        exact_costs.append(float("inf"))
                if None not in exact_costs:
                    costs = np.asarray(exact_costs, dtype=np.float64)
                    swept_exact = True
            i = int(np.argmin(costs))
            if costs[i] < best_cost - 1e-12:
                best_cost = float(costs[i])
                best_exact = swept_exact
                if assign[k] != float(cand[i]):
                    assign[k] = float(cand[i])
                    changed = True
            history.append((dict(assign), best_cost))
        if not changed:
            break

    if not np.isfinite(best_cost):
        raise InvalidGridError(
            "coordinate descent found no valid configuration (all sweeps "
            "invalid and no exact_cost escape hatch on this evaluator)"
        )
    return TuningResult(dict(assign), float(best_cost), evals, history,
                        exact=best_exact)


def _search_axes(evaluator: Evaluator, space: Mapping[str, Sequence[float]]):
    """Per-key relaxation axes for a candidate space: the declared axis with
    its physical bounds tightened to the candidate range, so the sigmoid
    transform searches exactly the span the grid strategies see."""
    ps = evaluator.param_space
    axes = {}
    for k, cand in space.items():
        vals = np.asarray(list(cand), dtype=np.float64)
        ax = ps[k] if ps is not None and k in ps else Axis(name=k)
        if ax.kind == "bool":
            axes[k] = ax          # bools relax on (0, 1) regardless
            continue
        lo, hi = float(vals.min()), float(vals.max())
        if lo == hi:
            hi = lo + max(abs(lo) * 1e-9, 1e-9)   # degenerate 1-candidate axis
        axes[k] = dataclasses.replace(ax, lower=lo, upper=hi, lower_open=False)
    return axes


def build_relaxed_objective(evaluator: Evaluator,
                            space: Mapping[str, Sequence[float]]):
    """Build the relaxed objective that gradient descent differentiates.

    Returns ``(raw_cost, axes, keys)``: ``raw_cost`` maps a dict of
    unconstrained per-key tensors (0-d, or one row per restart) to the
    evaluator's differentiable cost after per-axis
    :meth:`~repro_torch.spec.Axis.project` transforms.  Raises
    :class:`NotDifferentiableError` for non-differentiable backends.
    Module-level (rather than a closure inside :func:`gradient_descent_ev`)
    so ``repro_torch.analysis`` can trace exactly what the tuner descends.
    """
    objective = evaluator.grad_objective()
    keys = list(space.keys())
    axes = _search_axes(evaluator, space)

    def raw_cost(u):
        over = {k: axes[k].project(u[k]) for k in keys}
        cost, _ = objective(over)
        return cost

    return raw_cost, axes, keys


def gradient_descent_ev(
    evaluator: Evaluator,
    space: Mapping[str, Sequence[float]],
    *,
    steps: int = 80,
    restarts: int = 4,
    peak_lr: float = 0.5,
    seed: int = 0,
    checkpoints: int = 4,
    exact_fallback: bool = True,
) -> TuningResult:
    """First-order search over a continuous relaxation of the space.

    Each swept axis is relaxed to an unconstrained real via
    :meth:`repro_torch.spec.Axis.relax`/:meth:`~repro_torch.spec.Axis.project`
    — bounds through sigmoid transforms restricted to the candidate range,
    int/bool axes through straight-through rounding — and the evaluator's
    differentiable objective (:meth:`Evaluator.grad_objective`) is descended
    with the in-tree AdamW from ``restarts`` starting points at once.  The
    restarts are the rows of one batched model call (the reference vmaps
    ``value_and_grad`` over them): the model is row-wise, so the gradient
    of the summed cost is each restart's own.

    The descent trajectory is then **rounded and validated**: projected
    assignments checkpointed along each restart are deduplicated, checked
    against the declared :class:`repro_torch.spec.Predicate` constraints,
    and re-costed through ``evaluator.evaluate`` (masked total, with the
    ``exact_cost`` escape hatch) — the *reported* cost always comes from the
    evaluator, never from the relaxed objective.  ``evaluations`` counts
    those validation rows: the gradient steps differentiate the model
    directly and make no evaluator calls.

    Backends without a differentiable objective raise
    :class:`NotDifferentiableError`; this function falls back — loudly — to
    :func:`coordinate_descent_ev`.
    """
    try:
        raw_cost, axes, keys = build_relaxed_objective(evaluator, space)
    except NotDifferentiableError as e:
        logger.warning(
            "gradient_descent_ev: backend is not differentiable (%s); "
            "falling back to coordinate_descent_ev", e)
        return coordinate_descent_ev(
            evaluator, space, exact_fallback=exact_fallback)

    # an evaluator with an objective says where its model runs
    device, dtype = evaluator.device, evaluator.dtype
    rng = np.random.default_rng(seed)

    # Starting points: restart 0 at the per-axis midpoint candidate (the
    # coordinate-descent start), the rest uniform over the candidate range.
    u0 = {}
    for k in keys:
        vals = np.asarray(list(space[k]), dtype=np.float64)
        lo, hi = float(vals.min()), float(vals.max())
        starts = [float(vals[len(vals) // 2])]
        starts += list(rng.uniform(lo, hi, size=max(0, restarts - 1)))
        u0[k] = torch.tensor([float(axes[k].relax(v)) for v in starts[:restarts]],
                             dtype=dtype, device=device)

    opt_cfg = AdamWConfig(
        peak_lr=peak_lr,
        warmup_steps=max(1, steps // 10),
        total_steps=steps,
        weight_decay=0.0,
        # effectively unclipped: Adam's sqrt(v) normalization already bounds
        # the per-axis step, and clipping across restarts would couple them
        grad_clip_norm=1e6,
    )
    state = adamw_init(u0)

    def step(u, state):
        # vals ride along for observability: the per-restart relaxed cost
        # at the pre-update point
        leaves = {k: v.detach().requires_grad_(True) for k, v in u.items()}
        cost = raw_cost(leaves)
        grads = torch.autograd.grad(cost.sum(), [leaves[k] for k in keys],
                                    allow_unused=True)
        grads = {k: torch.zeros_like(u[k]) if g is None
                 else torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0)
                 for k, g in zip(keys, grads)}
        new_u, new_state, _ = adamw_update(grads, state, u, opt_cfg)
        return cost.detach(), new_u, new_state

    def snapshot(u) -> list[dict[str, float]]:
        with torch.no_grad():
            cols = {k: axes[k].project(u[k]).tolist() for k in keys}
        return [{k: float(cols[k][r]) for k in keys} for r in range(restarts)]

    ob = _obs_current()
    candidates: list[dict[str, float]] = snapshot(u0)
    u = u0
    every = max(1, steps // max(1, checkpoints))
    for i in range(steps):
        vals, u, state = step(u, state)
        if (i + 1) % every == 0 or i == steps - 1:
            candidates += snapshot(u)
            if ob.enabled:
                v = vals.to("cpu", torch.float64).reshape(-1).numpy()
                v = v[np.isfinite(v)]
                if v.size:
                    ob.tracer.counter("tuner", best_relaxed_cost=float(v.min()))
    if ob.enabled:
        ob.registry.counter("tuner.gradient_steps").inc(steps)

    # ---- round-and-validate: dedupe, predicate-check, evaluator re-cost ----
    seen: set[tuple] = set()
    rows: list[dict[str, float]] = []
    for cand in candidates:
        key = tuple(round(cand[k], 12) for k in keys)
        if key not in seen:
            seen.add(key)
            rows.append(cand)

    ps = evaluator.param_space
    if ps is not None and ps.predicates:
        cols = {k: np.asarray([r[k] for r in rows]) for k in keys}
        ok, reasons = ps.validity_mask(cols)
        if not ok.all():
            dropped = int((~ok).sum())
            failed = [n for n, m in reasons.items() if not m.all()]
            logger.info(
                "gradient_descent_ev: dropped %d/%d projected candidates "
                "failing declared predicates (%s)",
                dropped, len(rows), ", ".join(failed))
            rows = [r for r, good in zip(rows, ok) if good]
    if not rows:
        logger.warning(
            "gradient_descent_ev: every projected candidate failed the "
            "declared predicates; falling back to coordinate_descent_ev")
        return coordinate_descent_ev(
            evaluator, space, exact_fallback=exact_fallback)

    overrides = {k: np.asarray([r[k] for r in rows]) for k in keys}
    res = evaluator.evaluate(overrides)
    evals = len(rows)
    if ob.enabled:
        ob.registry.counter("tuner.evaluator_calls").inc()
        ob.registry.counter("tuner.validated_rows").inc(evals)
    costs = np.asarray(res.total_cost, dtype=np.float64)

    best_exact = False
    if exact_fallback and not np.isfinite(costs).any():
        exact_costs = []
        for r in rows:
            try:
                exact_costs.append(evaluator.exact_cost(r))
            except ExactCostUnavailable as e:
                logger.info("exact fallback skipped %s: %s", r, e)
                exact_costs.append(float("inf"))
        if None not in exact_costs:
            costs = np.asarray(exact_costs, dtype=np.float64)
            best_exact = True

    if not np.isfinite(costs).any():
        logger.warning(
            "gradient_descent_ev: no validated candidate has a finite cost; "
            "falling back to coordinate_descent_ev")
        return coordinate_descent_ev(
            evaluator, space, exact_fallback=exact_fallback)

    order = np.argsort(costs, kind="stable")
    history = [(dict(rows[i]), float(costs[i])) for i in order[::-1]]
    i = int(order[0])
    return TuningResult(dict(rows[i]), float(costs[i]), evals, history,
                        exact=best_exact)


# --------------------------------------------------------------------------
# Hadoop-first wrappers (the reference's repro.core.tuner signatures)
# --------------------------------------------------------------------------


def _hadoop_evaluator(p, s, c, evaluator, chunk, device):
    if evaluator is not None:
        return evaluator
    return cached_evaluator(p, s, c, chunk, device)


def grid_search(
    p: HadoopParams,
    s: ProfileStats,
    c: CostFactors,
    space: Mapping[str, Sequence[float]],
    *,
    evaluator: Evaluator | None = None,
    chunk: int | None = None,
    exact_fallback: bool = True,
    device=None,
) -> TuningResult:
    ev = _hadoop_evaluator(p, s, c, evaluator, chunk, device)
    return grid_search_ev(ev, space, exact_fallback=exact_fallback)


def random_search(
    p: HadoopParams,
    s: ProfileStats,
    c: CostFactors,
    space: Mapping[str, Sequence[float]],
    *,
    samples: int = 4096,
    seed: int = 0,
    evaluator: Evaluator | None = None,
    chunk: int | None = None,
    exact_fallback: bool = True,
    device=None,
) -> TuningResult:
    ev = _hadoop_evaluator(p, s, c, evaluator, chunk, device)
    return random_search_ev(ev, space, samples=samples, seed=seed,
                            exact_fallback=exact_fallback)


def coordinate_descent(
    p: HadoopParams,
    s: ProfileStats,
    c: CostFactors,
    space: Mapping[str, Sequence[float]],
    *,
    max_rounds: int = 8,
    evaluator: Evaluator | None = None,
    chunk: int | None = None,
    exact_fallback: bool = True,
    device=None,
) -> TuningResult:
    ev = _hadoop_evaluator(p, s, c, evaluator, chunk, device)
    return coordinate_descent_ev(ev, space, max_rounds=max_rounds,
                                 exact_fallback=exact_fallback)
