"""grad-blocker: zero-derivative ops on a differentiated path.

Carried over from the reference's ``repro/analysis/checkers/grad_blocker.py``.
``floor``/``ceil``/``round``/``trunc``, float->int casts, and ``detach``
(the reference's ``stop_gradient``) silently kill gradients: calibration and
gradient search see flat objectives with no error.  This checker walks only
the targets that are actually differentiated (``grad_mode=True``: the
``j_totalCost`` path of gradient search, and in later slices the
calibration loss and the tuner's relaxed objective) and flags those ops —
**unless** they are routed through the ``ste_*`` helpers in
:mod:`repro_torch.core.hadoop.merge_math`, which trace as the custom
operators ``repro_torch::ste_*`` (the author owns the gradient there, so
they are exempt on principle), or applied to validity flags (values derived
purely from comparisons, which carry no useful gradient anyway).
"""

from __future__ import annotations

from ..findings import Finding
from .nan_hazard import format_events

__all__ = ["run", "EVENT_KINDS"]

EVENT_KINDS = {
    "rounding": "floor/ceil/round has zero derivative",
    "int_cast": "float -> integer cast has zero derivative",
    "stop_gradient": "detach severs the path",
}

_HINT = (
    "route round counts through merge_math.ste_floor / ste_ceil / ste_round "
    "(straight-through custom operators), or keep the op off the "
    "differentiated path; detach is fine on validity flags only"
)


def run(ctx) -> list[Finding]:
    findings: list[Finding] = []
    for t in ctx.targets:
        if not t.traceable or not t.grad_mode:
            continue
        an = ctx.analyzed(t)
        findings.extend(
            format_events(an, t.name, "grad-blocker", EVENT_KINDS, _HINT))
    return findings
