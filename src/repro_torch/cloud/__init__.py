"""repro_torch.cloud — dollar-cost elastic provisioning on the cluster planner.

Herodotou's models predict *seconds*; in a pay-as-you-go cloud the
objective is *dollars under an SLO* (the billing connection of Rizvandi
et al., arXiv 1303.3632).  This package is that economic layer, built
on the cluster machinery (:mod:`repro_torch.cluster`) and the
observability substrate (:mod:`repro_torch.obs`):

* :mod:`~repro_torch.cloud.pricing` — $/hour node prices, the expected-cost
  model of exponential spot reclamation, and the exact per-episode DES
  biller (:func:`bill_workload`).
* :mod:`~repro_torch.cloud.autoscaler` — :class:`ElasticFleet`: the
  provisioning lifecycle (provision latency, teardown, minimum billing
  granularity) plus the fixed / queue-depth / predicted-load policies,
  interpreted exactly by the DES and in expectation by the wave
  simulator (:func:`wave_columns`).
* :mod:`~repro_torch.cloud.evaluator` — :class:`CloudEvaluator`: the
  dollars-under-SLO objective behind the standard
  :class:`repro_torch.search.Evaluator` interface, so every strategy and
  :class:`~repro_torch.search.WhatIfService` walk the price-performance
  Pareto frontier unchanged (:func:`pareto_front` extracts it).

The public surface below is frozen in ``spec/manifest.json`` and
guarded by ``tests/test_torch_tuning.py``.
"""

from .autoscaler import (
    AUTOSCALE_POLICIES,
    ElasticFleet,
    predicted_extra_nodes,
    wave_columns,
)
from .evaluator import CloudEvaluator, SloUnmetError, cloud_space
from .pricing import bill_workload, dollars_for, spot_inflation
from .report import pareto_front, provisioning_report

__all__ = [
    "AUTOSCALE_POLICIES",
    "CloudEvaluator",
    "ElasticFleet",
    "SloUnmetError",
    "bill_workload",
    "cloud_space",
    "dollars_for",
    "pareto_front",
    "predicted_extra_nodes",
    "provisioning_report",
    "spot_inflation",
    "wave_columns",
]
