"""repro_torch.spec — typed, declarative descriptions of configs and costs.

* :mod:`~repro_torch.spec.axes` — :class:`Axis` / :class:`Predicate` /
  :class:`ParamSpace`: declarative searchable axes; :func:`hadoop_space` is
  the paper's full Tables-1-3 space.
* :mod:`~repro_torch.spec.job` — :class:`JobSpec`: the three parameter
  dataclasses as one frozen, hashable value, losslessly convertible to and
  from the flat ``pack_config`` dict.
* :mod:`~repro_torch.spec.report` — :class:`PhaseBreakdown` /
  :class:`CostReport`: the model's flat outputs lifted into typed per-phase
  costs with disaggregated validity; :class:`CalibrationReport`: one fit of
  :func:`repro_torch.calib.calibrate`; :class:`ProvisioningReport` /
  :class:`DagReport`: the cloud and cluster layers' typed results.

The public surface of this package and of :mod:`repro_torch.api` is frozen
in ``manifest.json`` beside this file and guarded by
``tests/test_torch_tuning.py``.
"""

from .axes import Axis, ParamSpace, Predicate, hadoop_space
from .job import JobSpec
from .report import (
    PHASES,
    VALIDITY_CONSTRAINTS,
    CalibrationReport,
    CostReport,
    DagReport,
    PhaseBreakdown,
    ProvisioningReport,
    invalid_reason_counts,
    invalid_reasons,
)

__all__ = [
    "Axis",
    "Predicate",
    "ParamSpace",
    "hadoop_space",
    "JobSpec",
    "PhaseBreakdown",
    "CostReport",
    "CalibrationReport",
    "ProvisioningReport",
    "DagReport",
    "PHASES",
    "VALIDITY_CONSTRAINTS",
    "invalid_reason_counts",
    "invalid_reasons",
]
