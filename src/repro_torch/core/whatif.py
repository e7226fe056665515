"""What-if engine: vectorized evaluation of the job model over config grids.

The engine lives in :mod:`repro_torch.search` — a chunked, padded
evaluator with streaming top-k and an exact-simulator escape hatch for
``valid == 0`` configs.  This module keeps the reference's seed API:

* :class:`WhatIfResult` (= :class:`repro_torch.search.SearchResult`) — batched
  outputs + overrides; ``best()`` raises :class:`InvalidGridError` on an
  all-invalid grid instead of silently returning index 0.
* :func:`evaluate_grid` — parameters swept as (B,) arrays.
* :func:`evaluate_product_grid` — streamed Cartesian sweep.
* :func:`evaluate_queries` — MANY heterogeneous queries at once, resolved
  concurrently through :class:`repro_torch.search.service.WhatIfService` (the
  multi-query path: probes/sweeps/grids are coalesced into shared evaluator
  chunks instead of paying one padded ``evaluate`` call each).
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np

from repro_torch.search.evaluator import (
    ChunkedEvaluator,
    InvalidGridError,
    SearchResult,
    cached_evaluator,
)
from repro_torch.search.grid import iter_blocks
from repro_torch.search.service import QueryResult, WhatIfService

from .hadoop.params import CostFactors, HadoopParams, ProfileStats

__all__ = [
    "WhatIfResult",
    "InvalidGridError",
    "evaluate_grid",
    "evaluate_product_grid",
    "evaluate_queries",
    "WhatIfService",
]

# The seed name; one dataclass serves both the legacy and search APIs.
WhatIfResult = SearchResult


def evaluate_grid(
    p: HadoopParams,
    s: ProfileStats,
    c: CostFactors,
    overrides: Mapping[str, Any],
    *,
    chunk: int | None = None,
    evaluator: ChunkedEvaluator | None = None,
    device=None,
) -> WhatIfResult:
    """Evaluate the job model with some parameters swept as (B,) arrays.

    ``overrides`` maps config keys (any field of the three dataclasses) to a
    1-D array of values; all arrays must have the same length B.  Scalar
    overrides are allowed and applied unbatched.  Evaluation streams through
    the chunked evaluator on ``device`` (``None``: the CUDA card), bit for
    bit equal to one unchunked batched call.
    """
    if evaluator is None:
        evaluator = cached_evaluator(p, s, c, chunk, device)
    return evaluator.evaluate(overrides)


def evaluate_product_grid(
    p: HadoopParams,
    s: ProfileStats,
    c: CostFactors,
    space: Mapping[str, Sequence[float]],
    *,
    chunk: int = 1 << 13,
    evaluator: ChunkedEvaluator | None = None,
    device=None,
) -> WhatIfResult:
    """Cartesian-product sweep over ``space`` (key -> candidate values).

    The product is never materialized: index blocks stream through the
    fixed-size chunked evaluator, so arbitrarily large grids run in bounded
    device memory.  (For 10^5+-config spaces
    prefer :func:`repro_torch.search.search_topk`, which keeps only the top-k
    instead of returning every output column.)
    """
    if evaluator is None:
        evaluator = cached_evaluator(p, s, c, chunk, device)
    parts: list[WhatIfResult] = [
        evaluator.evaluate(cols) for _, cols in iter_blocks(space, evaluator.chunk)
    ]
    return WhatIfResult(
        overrides={k: np.concatenate([r.overrides[k] for r in parts])
                   for k in parts[0].overrides},
        outputs={k: np.concatenate([r.outputs[k] for r in parts])
                 for k in parts[0].outputs},
        total_cost=np.concatenate([r.total_cost for r in parts]),
    )


def evaluate_queries(
    p: HadoopParams,
    s: ProfileStats,
    c: CostFactors,
    queries: Sequence[Mapping[str, Any]],
    *,
    chunk: int | None = None,
    exact_fallback: bool = False,
    evaluator: ChunkedEvaluator | None = None,
    device=None,
) -> list[QueryResult]:
    """Answer many what-if queries in one coalesced pass.

    Each query is an override mapping in the :func:`evaluate_grid` format
    (scalars broadcast, 1-D arrays sweep).  All queries share one admission
    queue and one evaluator; results are bit-for-bit
    what per-query :func:`evaluate_grid` calls would return, but heterogen-
    eous small queries no longer pay a padded chunk evaluation each.  With
    ``exact_fallback`` rows whose closed-form model is out of domain are
    re-costed through the task-scheduler simulator instead of ``inf``.
    """
    if evaluator is None:
        evaluator = cached_evaluator(p, s, c, chunk, device)
    with WhatIfService(evaluator) as svc:
        return svc.map(queries, exact_fallback=exact_fallback)
