"""nan-hazard: divisions / logs / subtractions that can produce NaN under
the declared axis bounds.

Carried over from the reference's ``repro/analysis/checkers/nan_hazard.py``.
The bug class: a masked computation whose *forward* value is a deliberate
``inf`` but whose unguarded op can evaluate ``0/0``, ``inf - inf``,
``0 * inf`` or ``log(0)`` — either in the primal or as a ``0 * inf``
gradient.  Detected by abstract-interval propagation over the traced aten
graph (:mod:`repro_torch.analysis.absint`) with
:func:`repro_torch.spec.hadoop_space` bounds as the initial abstraction; a
double-``where`` guard refines the guarded operand's interval away from the
singularity, which is how guarded sites pass without any pattern-matching
on the guard idiom.
"""

from __future__ import annotations

from ..findings import Finding

__all__ = ["run", "EVENT_KINDS", "format_events"]

EVENT_KINDS = {
    "div0": "denominator can be exactly 0 under the axis bounds",
    "inf_over_inf": "numerator and denominator can both be infinite",
    "inf_minus_inf": "both operands can carry the same-signed infinity",
    "zero_times_inf": "one factor can be 0 while the other is infinite",
    "log_domain": "argument can reach log's singular domain (<= 0)",
    "sqrt_domain": "argument can be negative",
    "pow_domain": "negative base with non-integer exponent",
}

_HINT = (
    "guard with the double-where idiom: "
    "where(ok, f(where(ok, x, safe)), masked) — see "
    "repro_torch.core.hadoop.model._masked_div"
)


def format_events(analysis, target_name: str, checker: str,
                  kinds: dict[str, str], hint: str) -> list[Finding]:
    out = []
    for e in analysis.events:
        if e.kind not in kinds:
            continue
        out.append(Finding(
            checker=checker,
            target=target_name,
            kind=e.kind,
            message=f"{kinds[e.kind]}: {e.detail}",
            location=e.location,
            chain=e.chain,
            hint=hint,
        ))
    return out


def run(ctx) -> list[Finding]:
    findings: list[Finding] = []
    for t in ctx.targets:
        if not t.traceable:
            continue
        an = ctx.analyzed(t)
        findings.extend(
            format_events(an, t.name, "nan-hazard", EVENT_KINDS, _HINT))
    return findings
