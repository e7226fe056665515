"""Configuration tuner — the paper's "find the optimal configuration" case.

The strategies live in :mod:`repro_torch.search.strategies`, running on the
chunked evaluator (:class:`repro_torch.search.ChunkedEvaluator`).  This
module keeps the reference's seed import path:

* :func:`grid_search`          — exhaustive Cartesian product, streamed with
  on-device top-k (exact optimum inside the grid).
* :func:`random_search`        — uniform sampling of the space.
* :func:`coordinate_descent`   — iterate per-parameter sweeps to a fixpoint.
"""

from __future__ import annotations

from repro_torch.search.strategies import (
    TuningResult,
    coordinate_descent,
    grid_search,
    random_search,
)

__all__ = ["TuningResult", "grid_search", "random_search", "coordinate_descent"]
