"""Search strategies over any :class:`repro_torch.search.evaluator.Evaluator`.

The paper's "find the optimal configuration" use case:

* :func:`search_topk`            — streaming exhaustive top-k over a product
  space (the primitive everything else builds on).
* :func:`grid_search_ev`         — exhaustive optimum (k=1 wrapper).
* :func:`random_search_ev`       — uniform sampling of the space.
* :func:`coordinate_descent_ev`  — per-axis sweeps to a fixpoint.

Gradient search (the reference package's ``gradient_descent_ev`` and
``build_relaxed_objective``) comes with calibration; the Hadoop-first
``grid_search`` / ``random_search`` / ``coordinate_descent`` signatures come
with the ``whatif`` / ``tuner`` aliases.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.hadoop.params import CostFactors, HadoopParams, ProfileStats
from repro_torch.spec.report import invalid_reason_counts

from .evaluator import (
    Evaluator,
    ExactCostUnavailable,
    InvalidGridError,
    apply_assignment,
)
from .grid import iter_blocks, sample_space
from .topk import TopKAccumulator, TopKResult

__all__ = [
    "TuningResult",
    "search_topk",
    "grid_search_ev",
    "random_search_ev",
    "coordinate_descent_ev",
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
