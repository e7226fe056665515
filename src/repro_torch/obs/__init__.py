"""repro_torch.obs — metrics, tracing, and profiling hooks for the whole stack.

The paper models a MapReduce job phase-by-phase so costs can be attributed;
this package does the same for the system that reproduces it.  One ambient
:class:`Observability` (a :class:`~repro_torch.obs.metrics.MetricsRegistry` plus a
:class:`~repro_torch.obs.trace.Tracer`) is visible to every instrumented
component via :func:`current`:

    from repro_torch.obs import observe

    with observe(trace="run.json") as ob:
        svc.submit(...)                       # spans + counters recorded
    print(ob.registry.snapshot())             # {"service.queries": 42, ...}
    # run.json opens at https://ui.perfetto.dev

Off by default: :func:`current` returns null singletons until an
:func:`observe` context installs live ones, and every instrumented hot path
guards on ``ob.enabled``, so the disabled cost is one attribute check.
Instrumentation is strictly host-side — it never runs inside device code
and never changes what an instrumented component computes.

The ambient slot is process-global, *not* thread-local, on purpose: the
what-if service and serve-loop do their work on worker threads that must
see the ``observe()`` installed by the driving thread.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

from repro_torch.obs.metrics import (
    NULL_REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    percentile_interp,
)
from repro_torch.obs.trace import NULL_TRACER, Tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_REGISTRY",
    "NULL_TRACER",
    "Observability",
    "Tracer",
    "current",
    "observe",
    "percentile_interp",
]


class Observability:
    """A registry + tracer pair; what instrumented components consume."""

    __slots__ = ("registry", "tracer")

    def __init__(self, registry: MetricsRegistry, tracer: Tracer):
        self.registry = registry
        self.tracer = tracer

    @property
    def enabled(self) -> bool:
        return self.registry.enabled or self.tracer.enabled


#: the ambient null default — ``current() is NULL_OBS`` means "off".
NULL_OBS = Observability(NULL_REGISTRY, NULL_TRACER)

_current: Observability = NULL_OBS


def current() -> Observability:
    """The ambient :class:`Observability` (null singletons when off)."""
    return _current


@contextlib.contextmanager
def observe(
    trace: str | None = None,
    *,
    registry: MetricsRegistry | None = None,
    tracer: Tracer | None = None,
) -> Iterator[Observability]:
    """Install a live ambient Observability for the duration of the block.

    ``trace="out.json"`` writes a Chrome trace-event file on exit (open it
    at https://ui.perfetto.dev).  Pass an explicit ``registry``/``tracer``
    to reuse existing instances (e.g. to accumulate across blocks); omitted
    ones are created fresh.  Restores the previous ambient value on exit,
    so contexts nest.
    """
    global _current
    ob = Observability(
        registry if registry is not None else MetricsRegistry(),
        tracer if tracer is not None else Tracer(),
    )
    prev = _current
    _current = ob
    try:
        yield ob
    finally:
        _current = prev
        if trace is not None:
            ob.tracer.write(trace)


def __getattr__(name: str):
    # Lazy: destrace pulls in repro_torch.cluster, profile_hooks pulls in
    # torch.profiler — neither belongs in the stdlib-only import path above.
    if name == "workload_trace":
        from repro_torch.obs.destrace import workload_trace

        return workload_trace
    if name == "profile_capture":
        from repro_torch.obs.profile_hooks import profile_capture

        return profile_capture
    raise AttributeError(f"module 'repro_torch.obs' has no attribute {name!r}")
