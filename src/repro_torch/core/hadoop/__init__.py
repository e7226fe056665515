"""Faithful implementation of the paper's Hadoop performance models.

The typed surface over these models — :class:`repro_torch.spec.JobSpec`
(Tables 1-3 as one value) and :class:`repro_torch.spec.CostReport`
(per-phase costs with Eq numbers) — lives one layer up; everything here
remains the flat, dict-keyed ground truth it adapts.
"""

from .merge_math import (
    MergePlan,
    calc_num_spills_final_merge,
    calc_num_spills_first_pass,
    calc_num_spills_interm_merge,
    merge_plan,
    num_merge_passes,
    simulate_merge,
)
from .model import CONFIG_KEYS, job_model_torch, pack_config
from .params import (
    CostFactors,
    HadoopParams,
    MiB,
    ProfileStats,
    apply_initializations,
)
from .ref import (
    JobModel,
    MapTaskModel,
    ReduceTaskModel,
    job_model,
    map_task_model,
    network_model,
    reduce_task_model,
)
from .simulator import SimConfig, SimResult, TaskRecord, simulate_job

__all__ = [
    "MiB",
    "HadoopParams",
    "ProfileStats",
    "CostFactors",
    "apply_initializations",
    "MergePlan",
    "calc_num_spills_first_pass",
    "calc_num_spills_interm_merge",
    "calc_num_spills_final_merge",
    "num_merge_passes",
    "merge_plan",
    "simulate_merge",
    "MapTaskModel",
    "ReduceTaskModel",
    "JobModel",
    "map_task_model",
    "reduce_task_model",
    "network_model",
    "job_model",
    "pack_config",
    "job_model_torch",
    "CONFIG_KEYS",
    "SimConfig",
    "SimResult",
    "TaskRecord",
    "simulate_job",
]
