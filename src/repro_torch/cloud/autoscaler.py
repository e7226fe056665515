"""Elastic-fleet provisioning lifecycle and autoscaling policies.

:class:`ElasticFleet` is the single value both simulator backends read
their cloud semantics from:

* the DES (``cluster.sched.simulate_workload(..., elastic=fleet)``)
  interprets it exactly — per-node reclaim processes, a provision
  latency before extra capacity comes online, teardown when the queue
  drains, per-episode minimum billing granularity;
* the wave simulator consumes it as scenario columns
  (:func:`wave_columns`) — one extra capacity block that switches on and
  off as a whole, with spot reclamation folded into task durations in
  expectation (``pricing.spot_inflation``).

Policies (``AUTOSCALE_POLICIES`` index == wire code):

======  =========  ====================================================
 code    name       behaviour
======  =========  ====================================================
 0       off        fixed fleet, never provisions
 1       queue      provision when unmet demand > ``high_water`` slots,
                    tear down when the queue drains
 2       predicted  provision once, up front, sized/justified by the
                    closed-form model (:func:`predicted_extra_nodes`)
======  =========  ====================================================
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

__all__ = [
    "AUTOSCALE_POLICIES",
    "ElasticFleet",
    "predicted_extra_nodes",
    "wave_columns",
]

AUTOSCALE_POLICIES = ("off", "queue", "predicted")


@dataclass(frozen=True)
class ElasticFleet:
    """Provisioning lifecycle + autoscaling policy for one fleet.

    ``reclaim_rate`` (1/s) applies to every ``spot`` node class in the
    cluster; ``0`` disables reclamation even for spot-flagged classes.
    Autoscaled extra nodes clone the slowest base class (never spot) and
    bill at ``extra_hourly_price`` when set, else that class's price.
    ``billing_quantum`` is the minimum billable seconds per online
    episode (e.g. 3600 for hour-granularity billing); ``0`` bills exact
    seconds.
    """

    policy: str = "off"
    max_extra_nodes: int = 0
    high_water: float = 0.0          # unmet-demand slots that trigger scale-up
    provision_latency: float = 0.0   # s between decision and capacity online
    billing_quantum: float = 0.0     # min billable s per online episode
    reclaim_rate: float = 0.0        # 1/s, exponential spot inter-reclaim
    seed: int = 0                    # reclaim-process RNG stream
    extra_hourly_price: float | None = None

    def __post_init__(self):
        if self.policy not in AUTOSCALE_POLICIES:
            raise ValueError(
                f"unknown autoscale policy: {self.policy!r} "
                f"(want one of {AUTOSCALE_POLICIES})")
        if self.max_extra_nodes < 0:
            raise ValueError("max_extra_nodes must be >= 0")
        if self.high_water < 0:
            raise ValueError("high_water must be >= 0")
        if self.provision_latency < 0:
            raise ValueError("provision_latency must be >= 0")
        if self.billing_quantum < 0:
            raise ValueError("billing_quantum must be >= 0")
        if self.reclaim_rate < 0:
            raise ValueError("reclaim_rate must be >= 0")
        if self.extra_hourly_price is not None and self.extra_hourly_price < 0:
            raise ValueError("extra_hourly_price must be >= 0")

    @property
    def policy_code(self) -> int:
        """Integer wire code (``AUTOSCALE_POLICIES`` index) shared by the
        DES, the wave columns, and the ``autoscalePolicy`` axis."""
        return AUTOSCALE_POLICIES.index(self.policy)


def predicted_extra_nodes(demand_slots: float, base_slots: int,
                          slots_per_node: int, max_extra: int) -> int:
    """Closed-form sizing for the ``predicted`` policy: how many extra
    nodes cover a predicted steady-state demand of ``demand_slots``
    concurrently-runnable tasks beyond the ``base_slots`` the fixed
    fleet already offers.  Clamped to ``[0, max_extra]``."""
    if slots_per_node <= 0 or max_extra <= 0:
        return 0
    deficit = float(demand_slots) - float(base_slots)
    if deficit <= 0.0:
        return 0
    return min(int(max_extra), int(math.ceil(deficit / slots_per_node)))


def wave_columns(fleet: "ElasticFleet", cluster, *, n_extra: int | None = None):
    """The wave simulator's view of an :class:`ElasticFleet`: the six
    scalar cloud columns plus the per-class ``reclaim_rate`` row for one
    scenario, keyed exactly as ``vector_sim.simulate_batch`` expects.

    ``cluster`` is the :class:`~repro_torch.cluster.sched.ClusterConfig` whose
    class columns the scenario already carries — its declared class
    order determines which columns get the spot reclaim rate.
    ``n_extra`` overrides the provisioned block size (defaults to
    ``fleet.max_extra_nodes``, e.g. after :func:`predicted_extra_nodes`
    sizing).
    """
    classes = cluster.node_classes or (None,)
    rates = [
        float(fleet.reclaim_rate) if (nc is not None and nc.spot) else 0.0
        for nc in classes
    ]
    extra = fleet.max_extra_nodes if n_extra is None else int(n_extra)
    on = fleet.policy_code > 0 and extra > 0
    return {
        "reclaim_rate": np.asarray(rates, dtype=np.float64),
        "autoscale": float(fleet.policy_code),
        "high_water": float(fleet.high_water),
        "provision_latency": float(fleet.provision_latency),
        "extra_map_slots": float(extra * cluster.map_slots_per_node) if on
        else 0.0,
        "extra_red_slots": float(extra * cluster.reduce_slots_per_node) if on
        else 0.0,
        "billing_quantum": float(fleet.billing_quantum),
    }
