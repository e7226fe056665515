"""Dollar pricing for simulated fleets.

The Herodotou models predict *seconds*; in a pay-as-you-go cloud the
objective is *dollars under an SLO* (cf. Rizvandi et al., arXiv
1303.3632).  This module is the conversion layer between the two, shared
by both simulator backends:

* :func:`dollars_for` — differentiable (torch) span -> dollars
  conversion used by the ``cloud-pricing`` analysis target.  A quantum
  given as a Python number <= 0 skips the billing-quantum ceil entirely,
  so the differentiated path never contains a gradient-blocking ``ceil``
  (the analyzer's gate).
* :func:`spot_inflation` — the wave simulator's expectation model of
  exponential spot reclamation: a task of duration ``d`` on a node
  reclaimed at rate ``lam`` needs ``(e^{lam d} - 1) / lam`` seconds of
  wall clock in expectation (restart-from-scratch semantics, matching
  the DES kill-and-requeue machinery).
* :func:`bill_workload` — host-side exact biller for DES results: walks
  the per-node online episodes recorded by ``simulate_workload``,
  clips them to the billing window, applies the minimum billing
  granularity per episode, and prices each node by its class.

Prices are $/hour throughout (the industry unit); simulated time is
seconds, so every conversion divides by 3600.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Sequence

import torch

from repro_torch.cluster.network import _as_float

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (typing only)
    from repro_torch.cloud.autoscaler import ElasticFleet
    from repro_torch.cluster.sched import ClusterConfig, WorkloadResult

__all__ = ["spot_inflation", "dollars_for", "bill_workload"]

_EPS = 1e-9


def spot_inflation(rate, duration):
    """Expected wall-clock inflation factor for spot-reclaimed work.

    With exponential reclamation at ``rate`` (1/s) and restart-from-
    scratch semantics, a task of ``duration`` seconds takes
    ``(e^{rate * duration} - 1) / rate`` seconds in expectation; the
    factor returned here is that divided by ``duration``.  ``rate <= 0``
    (on-demand nodes) returns exactly 1.  Uses the double-``where``
    idiom so the guarded branch never produces ``inf * 0`` NaNs under
    autograd.  Inputs are Python numbers or tensors (which broadcast).
    """
    like = next((a for a in (rate, duration) if isinstance(a, torch.Tensor)),
                None)
    rate = _as_float(rate, like)
    rate = torch.maximum(rate, rate.new_tensor(0.0))
    dur = _as_float(duration, like)
    rate_safe = torch.where(rate > 0.0, rate, 1.0)
    expected = (torch.expm1(rate_safe * dur)
                / (rate_safe * torch.maximum(dur, dur.new_tensor(_EPS))))
    return torch.where(rate > 0.0, expected, 1.0)


def dollars_for(span_s, node_counts, prices_hr, billing_quantum=0.0):
    """Dollar bill for a fleet held online for ``span_s`` seconds.

    ``node_counts`` and ``prices_hr`` ($/hour) broadcast against each
    other and are summed over their last axis; ``span_s`` broadcasts
    against the result, so batched evaluators can pass ``(B,)`` spans
    with ``(B, C)`` fleets.  When ``billing_quantum`` is a concrete
    (python) non-positive number the span passes through untouched and
    the traced graph contains no ``ceil`` — keeping the differentiable
    pricing path clean for the analysis gate.
    """
    like = next((a for a in (span_s, node_counts, prices_hr, billing_quantum)
                 if isinstance(a, torch.Tensor)), None)
    span = _as_float(span_s, like)
    counts = _as_float(node_counts, like)
    prices = _as_float(prices_hr, like)
    concrete_off = (
        isinstance(billing_quantum, (int, float)) and billing_quantum <= 0.0
    )
    if concrete_off:
        billed = span
    else:
        quantum = _as_float(billing_quantum, like)
        q_safe = torch.where(quantum > 0.0, quantum, 1.0)
        billed = torch.where(
            quantum > 0.0, torch.ceil(span / q_safe) * q_safe, span
        )
    fleet_rate = torch.sum(counts * prices, dim=-1)
    return fleet_rate * billed / 3600.0


def _billed_seconds(episodes: Sequence[tuple[float, float]],
                    lo: float, hi: float, quantum: float) -> float:
    """Sum of quantized online-episode durations clipped to [lo, hi]."""
    total = 0.0
    for start, end in episodes:
        dur = min(end, hi) - max(start, lo)
        if dur <= 0.0:
            continue
        if quantum > 0.0:
            dur = math.ceil(dur / quantum - _EPS) * quantum
        total += dur
    return total


def bill_workload(result: "WorkloadResult", cluster: "ClusterConfig", *,
                  elastic: "ElasticFleet | None" = None,
                  window: tuple[float, float] | None = None) -> float:
    """Exact dollar bill for a DES run (the ``exact_cost`` pricing path).

    Walks ``result.node_online`` — the per-node ``(online, offline)``
    episodes recorded by ``simulate_workload`` — so reclaimed spot nodes
    stop billing while waiting for replacements and autoscaled extras
    bill only while provisioned.  Base nodes are priced by their
    ``NodeClass.hourly_price``; extra (autoscaled) nodes bill at
    ``elastic.extra_hourly_price`` when set, else their clone class's
    price.  ``window`` defaults to ``(0, result.makespan)``.
    """
    table = cluster.node_table()
    n_base = len(table)
    lo, hi = window if window is not None else (0.0, float(result.makespan))
    if not math.isfinite(hi):
        raise ValueError("cannot bill an unfinished workload (inf makespan)")
    quantum = float(elastic.billing_quantum) if elastic is not None else 0.0
    base_price = table[-1][2] if table else 0.0
    extra_price = base_price
    if elastic is not None and elastic.extra_hourly_price is not None:
        extra_price = float(elastic.extra_hourly_price)
    total = 0.0
    for nd, episodes in enumerate(result.node_online):
        price = table[nd][2] if nd < n_base else extra_price
        if price <= 0.0:
            continue
        total += price * _billed_seconds(episodes, lo, hi, quantum)
    return total / 3600.0
