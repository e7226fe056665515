"""Checker registry for :mod:`repro_torch.analysis`.

Each checker module exposes ``run(ctx) -> list[Finding]`` where ``ctx`` is
an :class:`AnalysisContext` carrying lazily-traced targets.  The registry
order is the report order, the reference's with ``launch-geometry`` in place
of ``pallas-kernel``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from repro_torch.compat import resolve_device

from ..absint import Analysis, LoopGraphs, analyze_graph, analyze_loop
from ..targets import TraceTarget, Traced, iter_targets, trace_target

__all__ = ["CHECKERS", "AnalysisContext"]


@dataclass
class AnalysisContext:
    """Shared state for one analysis run: targets are traced on ``device``
    (and abstractly interpreted) once, then reused by every graph-level
    checker.  ``device=None`` means the CUDA card, which raises without one
    (``compat.resolve_device``); pass ``device="cpu"`` for the CPU."""

    targets: list[TraceTarget] = field(default_factory=iter_targets)
    device: Any = None
    _traced: dict = field(default_factory=dict)
    _analyzed: dict = field(default_factory=dict)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def traced(self, t: TraceTarget) -> Traced:
        if t.name not in self._traced:
            self._traced[t.name] = trace_target(t, self.device)
        return self._traced[t.name]

    def analyzed(self, t: TraceTarget) -> Analysis:
        if t.name not in self._analyzed:
            tr = self.traced(t)
            walk = analyze_loop if isinstance(tr.graph, LoopGraphs) \
                else analyze_graph
            self._analyzed[t.name] = walk(tr.graph, tr.intervals,
                                          grad_mode=t.grad_mode)
        return self._analyzed[t.name]


def _registry():
    from . import (grad_blocker, launch_geometry, mask_contract, nan_hazard,
                   recompile)

    return {
        "nan-hazard": nan_hazard,
        "grad-blocker": grad_blocker,
        "recompile-hazard": recompile,
        "mask-contract": mask_contract,
        "launch-geometry": launch_geometry,
    }


CHECKERS = _registry()
