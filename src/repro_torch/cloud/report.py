"""Economic report glue: typed views and Pareto-frontier helpers.

The typed container itself (:class:`repro_torch.spec.ProvisioningReport`)
lives in the spec layer next to :class:`~repro_torch.spec.CostReport` so the
frozen API surface stays in one place; this module provides the
cloud-side conveniences built on top of it.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from repro_torch.spec import ProvisioningReport

__all__ = ["provisioning_report", "pareto_front"]


def provisioning_report(outputs: Mapping[str, object]) -> ProvisioningReport:
    """Lift a :meth:`CloudEvaluator.evaluate` output dict (the ``c_*``
    columns) into the typed view."""
    return ProvisioningReport.from_outputs(outputs)


def pareto_front(costs, quality) -> np.ndarray:
    """Boolean mask of the (min-cost, min-quality) Pareto-optimal rows.

    Both metrics are *minimized* — pass e.g. ``dollars_per_job`` and
    ``p95_latency`` (negate a maximize-metric like ``slo_attainment``
    first).  A row is kept when no other row is at least as good on
    both axes and strictly better on one; non-finite rows are dominated
    by definition.
    """
    c = np.asarray(costs, dtype=np.float64).ravel()
    q = np.asarray(quality, dtype=np.float64).ravel()
    if c.shape != q.shape:
        raise ValueError(
            f"cost/quality shape mismatch: {c.shape} vs {q.shape}")
    finite = np.isfinite(c) & np.isfinite(q)
    keep = np.zeros(c.shape, dtype=bool)
    for i in np.nonzero(finite)[0]:
        others = finite.copy()
        others[i] = False
        dominated = np.any(
            (c[others] <= c[i]) & (q[others] <= q[i])
            & ((c[others] < c[i]) | (q[others] < q[i])))
        keep[i] = not dominated
    return keep
