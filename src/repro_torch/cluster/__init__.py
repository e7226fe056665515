"""repro_torch.cluster — multi-job workload simulation + vectorized capacity planning.

The paper (and ``repro_torch.core.hadoop``) costs a *single* MapReduce job; this
subsystem answers the cluster-level questions a multi-tenant deployment
actually asks — how does a workload of concurrent jobs behave under slot
contention, and what cluster shape minimizes tail latency?  Three layers:

* :mod:`~repro_torch.cluster.workload` — job classes over the canonical
  :data:`repro_torch.mapreduce.jobs.JOBS` profiles and arrival traces (Poisson,
  bursty, replayed), generated at unit rate and rescaled so offered load is
  a searchable knob; :class:`StageDag` multi-stage (DAG) jobs whose
  dataflow is derived from the Table-1 identities (stage output bytes size
  the next stage's mappers), expanded by :func:`dag_trace` into
  dependency-carrying arrivals and analyzed by :func:`dag_report`
  (critical path vs makespan, a :class:`repro_torch.spec.DagReport`).
* :mod:`~repro_torch.cluster.network` — the topology model underneath all of it:
  :class:`Topology` (racks, per-link bandwidths, oversubscription) with
  max-min fair-shared shuffle flows for the DES, the differentiable
  :func:`effective_bandwidth` incast approximation for the wave model and
  the closed-form job model's topology hook.  ``Topology.flat()`` is
  bit-for-bit the seed's flat network.
* :mod:`~repro_torch.cluster.sched` — the multi-job discrete-event simulator:
  FIFO / fair-share / preemptive fair-share / capacity scheduling over
  shared slot pools (kill-and-requeue preemption with a configurable
  grace timeout, per-job-class guaranteed capacities), heterogeneous
  fleets (:class:`NodeClass` speed factors), per-job queueing delay /
  latency / makespan, per-node busy time, with the single-job simulator's
  straggler / speculation / failure mechanics (and its exact behaviour on
  a one-job trace).  An optional elastic fleet
  (:class:`repro_torch.cloud.ElasticFleet`) adds spot reclamation and
  autoscaled extra capacity with per-node online episodes for billing.
* :mod:`~repro_torch.cluster.vector_sim` + :mod:`~repro_torch.cluster.evaluator` — the
  wave-level torch rollout (a host loop over scheduling rounds, every op
  batched over scenarios in float64, split over devices via
  :func:`repro_torch.compat.split_rows`) and
  :class:`ClusterEvaluator`, which plugs cluster knobs into every
  ``repro_torch.search`` strategy and :class:`~repro_torch.search.WhatIfService`.

``chip_smoke.py`` phase 11 asserts DES<->wave agreement on contention-free
FIFO scenarios and measures scenario throughput on the card;
``examples/torch_capacity_planning.py`` is the end-to-end walkthrough.
"""

from .evaluator import ClusterEvaluator, UnfinishedWorkloadError, cluster_space
from .network import Topology, effective_bandwidth, per_reducer_shuffle
from .sched import (
    ClusterConfig,
    ClusterTaskRecord,
    JobStats,
    NodeClass,
    WorkloadResult,
    simulate_workload,
)
from .vector_sim import (
    POLICIES,
    estimate_steps,
    latency_quantile,
    pack_trace,
    simulate_batch,
)
from .workload import (
    JobArrival,
    JobClass,
    StageDag,
    StageEdge,
    WorkloadTrace,
    bursty_trace,
    dag_from_templates,
    dag_report,
    dag_trace,
    default_job_classes,
    poisson_trace,
    replayed_trace,
    rescale,
    shuffle_full,
    stage_output_bytes,
    task_costs,
)
from repro_torch.core.hadoop.simulator import SimConfig

__all__ = [
    "JobClass",
    "JobArrival",
    "WorkloadTrace",
    "StageDag",
    "StageEdge",
    "default_job_classes",
    "dag_from_templates",
    "dag_trace",
    "dag_report",
    "poisson_trace",
    "bursty_trace",
    "replayed_trace",
    "rescale",
    "task_costs",
    "shuffle_full",
    "stage_output_bytes",
    "ClusterConfig",
    "ClusterTaskRecord",
    "JobStats",
    "NodeClass",
    "SimConfig",
    "Topology",
    "WorkloadResult",
    "simulate_workload",
    "effective_bandwidth",
    "per_reducer_shuffle",
    "POLICIES",
    "pack_trace",
    "estimate_steps",
    "latency_quantile",
    "simulate_batch",
    "ClusterEvaluator",
    "UnfinishedWorkloadError",
    "cluster_space",
]
