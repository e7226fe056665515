"""repro_torch.search — the config-search subsystem.

* :mod:`~repro_torch.search.grid`       — streaming Cartesian spaces (no
  materialized 10^6-row products).
* :mod:`~repro_torch.search.evaluator`  — chunked, padded batched model
  evaluation on one device (bit-for-bit equal to the unchunked path) + the
  ``valid == 0`` -> exact-simulator escape hatch.
* :mod:`~repro_torch.search.topk`       — streaming top-k merging.
* :mod:`~repro_torch.search.strategies` — grid / random / coordinate-descent /
  gradient-descent search over any evaluator (gradient descent relaxes the
  space continuously and differentiates the model itself, falling back
  loudly on non-differentiable backends).
* :mod:`~repro_torch.search.service`    — async what-if query service:
  concurrent probes/sweeps/grids coalesced into shared evaluator chunks.
* :mod:`~repro_torch.search.tpu`        — the accelerator step model
  (:mod:`repro_torch.core.tpu_model`) behind the same interface.
"""

from .evaluator import (
    BlockTopK,
    ChunkedEvaluator,
    Evaluator,
    ExactCostUnavailable,
    InvalidGridError,
    NotDifferentiableError,
    SearchResult,
    apply_assignment,
    cached_evaluator,
    evaluate_unchunked,
    masked_total,
    sanitize_costs,
)
from .grid import assignment_at, iter_blocks, sample_space, space_block, space_size
from .service import PhaseQueryResult, QueryResult, QueryStats, WhatIfService
from .strategies import (
    TuningResult,
    coordinate_descent,
    coordinate_descent_ev,
    gradient_descent_ev,
    grid_search,
    grid_search_ev,
    random_search,
    random_search_ev,
    search_topk,
)
from .topk import TopKAccumulator, TopKEntry, TopKResult
from .tpu import TpuEvaluator, mesh_space, tune_tpu

__all__ = [
    "ExactCostUnavailable",
    "InvalidGridError",
    "NotDifferentiableError",
    "SearchResult",
    "BlockTopK",
    "Evaluator",
    "ChunkedEvaluator",
    "cached_evaluator",
    "evaluate_unchunked",
    "apply_assignment",
    "sanitize_costs",
    "masked_total",
    "space_size",
    "space_block",
    "iter_blocks",
    "sample_space",
    "assignment_at",
    "TopKEntry",
    "TopKResult",
    "TopKAccumulator",
    "TuningResult",
    "search_topk",
    "grid_search",
    "grid_search_ev",
    "random_search",
    "random_search_ev",
    "coordinate_descent",
    "coordinate_descent_ev",
    "gradient_descent_ev",
    "WhatIfService",
    "QueryResult",
    "QueryStats",
    "PhaseQueryResult",
    "TpuEvaluator",
    "mesh_space",
    "tune_tpu",
]
