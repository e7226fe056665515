"""repro_torch.calib — gradient calibration of cost models against observations.

The differentiable half of the paper's workflow: where
``repro_torch.search`` asks "which config is cheapest given the model", this
package asks "which model parameters explain the observed costs".  Built on
the port's own stack — autograd through the branch-free job model, the
in-tree AdamW of :mod:`repro_torch.optim`, and the per-axis bound
transforms declared on :class:`repro_torch.spec.Axis` — and returns a
:class:`repro_torch.spec.CalibrationReport`.

Entry points: :func:`calibrate` (the general fit), :class:`Observation`
(one ``(JobSpec, measured cost)`` pair), and the profiler adapter
:func:`repro_torch.mapreduce.profiler.fit_cost_factors_autodiff`, which
starts at the per-phase least-squares solution and refines it on the
exact objective the paper reports (relative error of the Eq. 98 total).
"""

from .fit import COST_FACTOR_NAMES, Observation, calibrate, observations_from_pairs

__all__ = [
    "COST_FACTOR_NAMES",
    "Observation",
    "calibrate",
    "observations_from_pairs",
]
