"""repro_torch.analysis — static analysis of the port's cost models and
kernel launches.

The port of the reference's ``repro.analysis``.  It walks the aten graphs of
the registered cost models (traced with ``make_fx``, in place of jaxprs)
under the axis bounds of :func:`repro_torch.spec.hadoop_space`, plus AST and
launch-geometry passes for the parts no graph reaches.  Five checkers:

====================  ====================================================
``nan-hazard``        div/remainder/log/sqrt/pow/sub whose operand
                      intervals reach a singularity (0/0, inf-inf, 0*inf,
                      log 0) without a double-``where`` guard
``grad-blocker``      floor/ceil/round/int-cast/detach on a path that
                      gradient search differentiates, unless routed through
                      the ``repro_torch::ste_*`` custom operators
``recompile-hazard``  Python scalars at the trace boundary and bodies whose
                      graph is not one per key set (``make_fx`` twice)
``mask-contract``     cost totals escaping without ``masked_total``/
                      ``sanitize_costs``; models without validity outputs
``launch-geometry``   grid/block/shared-memory geometry of the port's CUDA
                      launches (``LaunchSpec``), checked without a card
====================  ====================================================

Run ``python -m repro_torch.analysis`` for the gate (non-zero exit on any
finding not accepted in ``analysis_baseline_torch.json``), or
:func:`run_all` programmatically.  Tracing runs on the CUDA card unless the
caller asks for the CPU (``device="cpu"``).
"""

from __future__ import annotations

from .findings import (DEFAULT_BASELINE, FINDING_FIELDS, Finding, Report,
                       load_baseline, save_baseline)
from .interval import Interval
from .targets import TraceTarget, iter_targets

__all__ = [
    "Finding",
    "Report",
    "Interval",
    "TraceTarget",
    "run_all",
    "checker_names",
    "iter_targets",
    "load_baseline",
    "save_baseline",
    "DEFAULT_BASELINE",
    "FINDING_FIELDS",
]


def checker_names() -> list[str]:
    """Registry order == report order."""
    from .checkers import CHECKERS

    return list(CHECKERS)


def run_all(checkers=None, targets=None, device=None) -> Report:
    """Run every (or the named) checker over every registered target,
    tracing on ``device`` (None: the CUDA card, which raises without one).

    ``targets`` overrides the registry — used by the analyzer's own tests
    to point checkers at known-bad fixtures.
    """
    from repro_torch.compat import resolve_device

    from .checkers import CHECKERS, AnalysisContext

    dev = resolve_device(device)
    ctx = AnalysisContext(device=dev) if targets is None \
        else AnalysisContext(targets=list(targets), device=dev)
    report = Report()
    for name, mod in CHECKERS.items():
        if checkers is not None and name not in checkers:
            continue
        report.findings.extend(mod.run(ctx))
        report.checkers_run.append(name)
    for t in ctx.targets:
        if not t.traceable:
            report.skipped[t.name] = t.skip_reason
    for tname, an in ctx._analyzed.items():
        if an.unknown_ops:
            report.coverage_gaps[tname] = sorted(an.unknown_ops)
    return report
