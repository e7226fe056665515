"""Topology-aware shuffle/network model (replaces the flat-pipe Eqs. 90-91).

The paper treats the network as a single flat pipe: the shuffle moves
``intermDataSize * pNumMappers * (n-1)/n`` bytes at ``cNetworkCost`` seconds
per byte (Eqs. 90-91) and each reducer serially pulls its ``1/pNumReducers``
share.  Real MapReduce clusters are rack-structured: per-node NICs feed
rack switches whose uplinks into the core are *oversubscribed*, and a
reduce wave is an incast — many concurrent flows converging on few links —
so communication pattern, not aggregate volume, sets the shuffle time
(Ceesay et al., arXiv 2005.11608).  This module is the one home of both
views:

* :func:`per_reducer_shuffle` — the flat term, hoisted verbatim from the
  single-job simulator and the cluster DES (the ``Topology.flat()``
  contract pins it bit-for-bit);
* :class:`Topology` — racks, per-link up/down bandwidth, cross-rack
  oversubscription.  Bandwidths are in units of the *nominal* flat-pipe
  rate (the bandwidth ``cNetworkCost`` implies), so a flow at rate 1.0
  transfers its flat-model shuffle seconds in exactly that many seconds
  and contention can only slow flows down, never speed them up;
* :func:`max_min_rates` / :func:`flow_rates` — host-side max-min fair
  share by progressive filling, used by the cluster DES to schedule
  concurrent shuffle flows on links exactly;
* :func:`effective_bandwidth` — the differentiable count-based
  approximation of the same fair share (uniform flows over racks), used
  by the closed-form job model and the wave simulator's batched rollout,
  in torch.  Divisions are double-``where`` guarded: a ``torch.where``
  that merely selects away an ``x/0`` branch still differentiates to NaN
  under autograd, so every guarded quotient divides by a safe denominator
  first.

Layering: :mod:`repro_torch.core` cannot depend on :mod:`repro_torch.cluster`
(see the note in :mod:`repro_torch.cluster.sched`), and this module sits below both — it
imports nothing from either package, so the single-job simulator and the
closed-form model can reach it through deferred function-level imports
without creating an import cycle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

import torch

__all__ = [
    "Topology",
    "per_reducer_shuffle",
    "max_min_rates",
    "flow_rates",
    "effective_bandwidth",
]

_INF = float("inf")


def per_reducer_shuffle(net_cost: float, num_reducers: int) -> float:
    """Each reducer's serialized share of the network transfer (Eqs. 90-91).

    This is the flat-pipe shuffle term, hoisted verbatim from the
    single-job simulator and the cluster DES's :func:`~repro_torch.cluster.workload.task_costs`:
    the job's total network seconds (Eq. 91) split evenly across the
    reducers that pull it.  ``Topology.flat()`` runs reproduce it
    bit-for-bit (regression-gated).
    """
    return net_cost / num_reducers if num_reducers else 0.0


@dataclass(frozen=True)
class Topology:
    """A rack-structured cluster network.

    Nodes are assigned round-robin to ``num_racks`` racks
    (:meth:`rack_of`).  Capacities are in units of the nominal flat-pipe
    flow rate (1.0 = the bandwidth ``cNetworkCost`` implies), and
    ``float('inf')`` means "never the bottleneck":

    * ``down_bw`` / ``up_bw`` — per-node NIC receive / transmit capacity;
    * ``cross_rack_bw`` — raw capacity of one rack's aggregation downlink;
    * ``oversub`` — oversubscription factor; the *effective* rack downlink
      is ``cross_rack_bw / oversub`` (:attr:`rack_capacity`).

    A shuffle flow into a reducer on rack ``r`` draws on three links: the
    destination node's downlink, rack ``r``'s aggregation downlink for its
    cross-rack fraction ``(R-1)/R`` (map outputs are spread uniformly, so
    that share of the pull transits the core), and the shared source
    uplink pool.  :func:`flow_rates` max-min fair-shares concurrent flows
    across those links.
    """

    num_racks: int = 1
    down_bw: float = _INF
    up_bw: float = _INF
    cross_rack_bw: float = _INF
    oversub: float = 1.0

    def __post_init__(self):
        if self.num_racks < 1:
            raise ValueError(f"num_racks must be >= 1, got {self.num_racks}")
        for name in ("down_bw", "up_bw", "cross_rack_bw"):
            if not getattr(self, name) > 0:
                raise ValueError(f"{name} must be positive, got {getattr(self, name)}")
        if not self.oversub >= 1.0:
            raise ValueError(f"oversub must be >= 1, got {self.oversub}")

    @classmethod
    def flat(cls) -> "Topology":
        """The degenerate single-pipe network of Eqs. 90-91: one rack, no
        finite link, no contention.  Simulators bypass flow scheduling
        entirely for flat topologies, reproducing the seed model
        bit-for-bit."""
        return cls()

    @property
    def is_flat(self) -> bool:
        """True when no link constraint can ever bind (every flow runs at
        the nominal rate 1.0 regardless of concurrency)."""
        node_free = self.down_bw == _INF and self.up_bw == _INF
        rack_free = self.num_racks <= 1 or self.rack_capacity == _INF
        return node_free and rack_free

    @property
    def rack_capacity(self) -> float:
        """Effective aggregation-downlink capacity per rack."""
        return self.cross_rack_bw / self.oversub

    @property
    def cross_frac(self) -> float:
        """Fraction of a reducer's pull that crosses racks: map outputs are
        uniform over racks, so ``(R-1)/R`` of the bytes transit the core."""
        return (self.num_racks - 1) / self.num_racks

    def rack_of(self, node: int) -> int:
        return node % self.num_racks


def max_min_rates(
    usages: Sequence[Mapping[object, float]],
    capacities: Mapping[object, float],
    *,
    rate_cap: float = 1.0,
) -> list[float]:
    """Max-min fair rates by progressive filling.

    ``usages[i]`` maps link -> weight: flow ``i`` at rate ``r`` consumes
    ``weight * r`` of that link's capacity.  All flows' rates rise together
    from zero; when a link saturates, the flows crossing it freeze at the
    current level and the rest keep rising, up to ``rate_cap`` (the nominal
    application-limited rate — contention only slows flows down).
    Infinite-capacity links never constrain.  O(flows x links) per
    saturation round — fine for the DES's tens of concurrent flows.
    """
    n = len(usages)
    rates = [0.0] * n
    active = [i for i in range(n) if usages[i]]
    for i in range(n):
        if not usages[i]:
            rates[i] = rate_cap       # touches no finite link
    rem = {l: c for l, c in capacities.items() if c != _INF}
    level = 0.0
    while active:
        dt = rate_cap - level
        tight = None
        for link, cap in rem.items():
            w = sum(usages[i].get(link, 0.0) for i in active)
            if w <= 0.0:
                continue
            d = cap / w
            if d < dt - 1e-15:
                dt = d
                tight = link
        level += dt
        for i in active:
            rates[i] = level
        if tight is None:             # everyone reached the nominal rate
            break
        for link in rem:
            w = sum(usages[i].get(link, 0.0) for i in active)
            rem[link] = max(rem[link] - w * dt, 0.0)
        saturated = {l for l, c in rem.items() if c <= 1e-12}
        active = [i for i in active
                  if not any(l in saturated for l in usages[i])]
    return rates


def flow_rates(topo: Topology, dst_nodes: Sequence[int], num_nodes: int
               ) -> list[float]:
    """Max-min fair rates for concurrent shuffle flows, one per reducer.

    ``dst_nodes[i]`` is the node running flow ``i``'s reducer.  Each flow
    crosses its destination node's downlink (weight 1), its destination
    rack's aggregation downlink (weight = the cross-rack traffic fraction
    ``(R-1)/R``), and the shared source uplink pool of capacity
    ``num_nodes * up_bw`` (map outputs are spread over all nodes).  Rates
    are capped at the nominal 1.0.
    """
    if topo.is_flat or not dst_nodes:
        return [1.0] * len(dst_nodes)
    xr = topo.cross_frac
    capacities: dict[object, float] = {"up": num_nodes * topo.up_bw}
    usages: list[dict[object, float]] = []
    for nd in dst_nodes:
        use: dict[object, float] = {("node", nd): 1.0, "up": 1.0}
        if xr > 0.0:
            use[("rack", topo.rack_of(nd))] = xr
        capacities[("node", nd)] = topo.down_bw
        capacities[("rack", topo.rack_of(nd))] = topo.rack_capacity
        usages.append(use)
    return max_min_rates(usages, capacities, rate_cap=1.0)


def _as_float(x, like=None) -> torch.Tensor:
    """A float64 tensor of ``x`` (tensors keep their device and dtype)."""
    if isinstance(x, torch.Tensor):
        return x if x.is_floating_point() else x.to(torch.float64)
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, dtype=torch.float64, device=dev)


def _max(a: torch.Tensor, b: float) -> torch.Tensor:
    # torch.maximum splits the gradient evenly at a tie, as jnp.maximum
    # does; clamp would hand it all to ``a``
    return torch.maximum(a, a.new_tensor(b))


def effective_bandwidth(num_racks, cross_rack_bw, oversub, num_flows):
    """Differentiable per-flow effective bandwidth under uniform incast.

    The count-based approximation of :func:`flow_rates` used where flows
    cannot be placed individually — the closed-form job model (all
    ``pNumReducers`` pulls concurrent) and the wave simulator's batched
    rollout (per-round running-reduce counts).  ``num_flows`` concurrent
    flows spread uniformly over ``num_racks`` racks; each rack's
    aggregation downlink (``cross_rack_bw / oversub``) carries the
    cross-rack fraction ``(R-1)/R`` of ``max(F/R, 1)`` flows, so

        bw = min(1, (cross_rack_bw/oversub) / ((R-1)/R * max(F/R, 1)))

    in units of the nominal flat-pipe rate.  Rack-level contention only:
    node NICs are exact-DES territory (see :func:`flow_rates`).  Inputs
    may be Python numbers or tensors (which broadcast); every division is
    double-``where`` guarded so gradients stay finite on the guarded
    branch.
    """
    like = next((a for a in (num_racks, cross_rack_bw, oversub, num_flows)
                 if isinstance(a, torch.Tensor)), None)
    racks = _max(_as_float(num_racks, like), 1.0)
    osub = _max(_as_float(oversub, like), 1.0)
    xbw = _as_float(cross_rack_bw, like)
    flows = _max(_as_float(num_flows, like), 0.0)

    rack_cap = xbw / osub                       # osub >= 1: safe divisor
    xr = (racks - 1.0) / racks                  # racks >= 1: safe divisor
    flows_per_rack = _max(flows / racks, 1.0)
    demand = xr * flows_per_rack
    # contention binds only with >1 rack, >0 demand, and a finite link
    contended = (racks > 1.5) & (demand > 0.0) & torch.isfinite(rack_cap)
    demand_safe = torch.where(contended, torch.where(demand > 0.0, demand, 1.0),
                              1.0)
    share = torch.where(contended, rack_cap / demand_safe, 1.0)
    return torch.minimum(share, share.new_tensor(1.0))
