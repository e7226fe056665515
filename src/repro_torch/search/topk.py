"""Streaming top-k accumulation across evaluator blocks.

Each block is reduced on device to its k cheapest valid rows and k cheapest
invalid rows (:class:`repro_torch.search.evaluator.BlockTopK`); this module merges
those per-block winners into one global ranking, and applies the invalid
escape hatch: when fewer than ``k`` valid configs exist, the best invalid
candidates are re-costed through the evaluator's ``exact_cost`` path (the
task-scheduler simulator for the Hadoop model) instead of reporting ``inf``.

Merging is deterministic: ties in cost resolve to the lower global index,
so streamed results agree with a full numpy ``argsort`` oracle (tested).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Mapping

import numpy as np

from .evaluator import BlockTopK, Evaluator, ExactCostUnavailable, InvalidGridError

__all__ = ["TopKEntry", "TopKResult", "TopKAccumulator"]

logger = logging.getLogger("repro_torch.search.topk")


@dataclass
class TopKEntry:
    # Offset into the streamed candidate sequence: the flat product index
    # for grid searches (usable with grid.assignment_at), the sample index
    # for random search.  `assignment` is always the authoritative config.
    index: int
    cost: float                     # seconds (exact-sim seconds if exact)
    assignment: dict[str, float]    # swept key -> value at this config
    valid: bool                     # closed-form model applicable?
    exact: bool = False             # costed via the exact simulator path


@dataclass
class TopKResult:
    entries: list[TopKEntry]        # sorted: valid by cost, then exact-costed
    k: int
    n_evaluated: int
    n_valid: int
    elapsed_s: float = 0.0
    #: why rows were invalid, summed over all streamed blocks: constraint
    #: name (repro_torch.spec.VALIDITY_CONSTRAINTS) -> row count
    invalid_reason_counts: dict[str, int] = field(default_factory=dict)

    def best(self) -> TopKEntry:
        if not self.entries:
            raise InvalidGridError(
                "search produced no rankable configuration (no valid configs "
                "and no exact_cost escape hatch on this evaluator)"
            )
        return self.entries[0]

    @property
    def configs_per_sec(self) -> float:
        return self.n_evaluated / self.elapsed_s if self.elapsed_s > 0 else 0.0


@dataclass
class _Cands:
    """One running candidate pool (cost-ascending, ties by global index)."""

    costs: np.ndarray = field(default_factory=lambda: np.empty(0))
    gidx: np.ndarray = field(default_factory=lambda: np.empty(0, dtype=np.int64))
    assigns: list = field(default_factory=list)

    def merge(self, k: int, costs, gidx, assigns) -> None:
        allc = np.concatenate([self.costs, costs])
        alli = np.concatenate([self.gidx, gidx])
        alla = self.assigns + assigns
        finite = np.isfinite(allc)
        order = np.lexsort((alli[finite], allc[finite]))[:k]
        self.costs = allc[finite][order]
        self.gidx = alli[finite][order]
        fa = [a for a, f in zip(alla, finite) if f]
        self.assigns = [fa[i] for i in order]


class TopKAccumulator:
    """Merge per-block :class:`BlockTopK` reductions into a global top-k."""

    def __init__(self, k: int):
        self.k = k
        self._valid = _Cands()
        self._invalid = _Cands()
        self.n_evaluated = 0
        self.n_valid = 0
        self._reasons: dict[str, int] = {}

    def update(
        self, start: int, cols: Mapping[str, np.ndarray], block: BlockTopK
    ) -> None:
        """Fold one block's winners in (``start`` = its global offset)."""
        n_rows = len(next(iter(cols.values())))
        self.n_evaluated += n_rows
        self.n_valid += block.n_valid
        for name, n in block.reason_counts.items():
            self._reasons[name] = self._reasons.get(name, 0) + n

        def pick(costs, idx, pool: _Cands):
            keep = np.isfinite(costs)
            li = idx[keep]
            assigns = [
                {k: float(v[i]) for k, v in cols.items()} for i in li
            ]
            pool.merge(self.k, costs[keep], start + li.astype(np.int64), assigns)

        pick(block.costs, block.idx, self._valid)
        pick(block.inv_costs, block.inv_idx, self._invalid)

    def finalize(
        self,
        evaluator: Evaluator,
        *,
        exact_fallback: bool = True,
        elapsed_s: float = 0.0,
    ) -> TopKResult:
        """Global ranking; open slots are filled by the best invalid configs
        re-costed through ``evaluator.exact_cost`` (never silent ``inf``)."""
        entries = [
            TopKEntry(int(i), float(c), a, valid=True)
            for c, i, a in zip(self._valid.costs, self._valid.gidx,
                               self._valid.assigns)
        ]
        free = self.k - len(entries)
        if free > 0 and exact_fallback and len(self._invalid.assigns):
            logger.info(
                "valid==0 exact fallback: only %d/%d ranked rows are model-"
                "valid; re-costing up to %d invalid survivor(s) via "
                "evaluator.exact_cost; failed constraints across the grid: %s",
                len(entries), self.k, len(self._invalid.assigns),
                ", ".join(f"{n}={c}" for n, c in self._reasons.items())
                or "not reported by this backend",
            )
            survivors = []
            for c, i, a in zip(self._invalid.costs, self._invalid.gidx,
                               self._invalid.assigns):
                try:
                    exact = evaluator.exact_cost(a)
                except ExactCostUnavailable as e:
                    logger.info("exact fallback skipped row %d: %s", i, e)
                    continue            # candidate stays out of the ranking
                if exact is None:
                    break               # evaluator has no exact path
                survivors.append(TopKEntry(int(i), exact, a,
                                           valid=False, exact=True))
            survivors.sort(key=lambda e: (e.cost, e.index))
            entries.extend(survivors[:free])
        return TopKResult(
            entries=entries,
            k=self.k,
            n_evaluated=self.n_evaluated,
            n_valid=self.n_valid,
            elapsed_s=elapsed_s,
            invalid_reason_counts=dict(self._reasons),
        )
