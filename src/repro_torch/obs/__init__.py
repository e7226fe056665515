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

:func:`span` is the program's span: a B/E pair on the ambient tracer under
``observe()``, and a ``torch.profiler`` range while a profiler session
records, so it lands among the profiler's host events on its clock (the
tracer's ``origin_ns`` puts the tracer's on the same one).  With neither it
is the shared null span.  Collections are spans too: a ``gc.callbacks`` hook
records each as a ``gc.collect`` range (a ``ph: X`` event on the tracer)
while either is on.
"""

from __future__ import annotations

import contextlib
import gc
import sys
from typing import Iterator

from repro_torch.obs.metrics import (
    NULL_REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    percentile_interp,
)
from repro_torch.obs.trace import _NULL_SPAN, NULL_TRACER, Tracer

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
    "span",
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


def _profiler():
    """``torch.autograd.profiler`` while a profiler session records, else
    None; looked up in ``sys.modules``, so this module never imports torch
    (a session cannot record before torch is imported).  The flag may not
    exist yet: a collection can start while torch is being imported."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof if getattr(prof, "_is_profiler_enabled", False) else None


class _Both:
    """A tracer span and a profiler range, entered and left together
    (the range inside the span)."""

    __slots__ = ("_outer", "_inner")

    def __init__(self, outer, inner):
        self._outer, self._inner = outer, inner

    def __enter__(self) -> "_Both":
        self._outer.__enter__()
        self._inner.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._inner.__exit__(*exc)
        self._outer.__exit__(*exc)


def span(name: str, **args):
    """``with span("server.prefill"): ...``: a B/E span on the ambient
    tracer under ``observe()``; a ``torch.profiler`` range named ``name``
    (``args`` as its string argument) while a profiler session records;
    both when both are on.  With neither it returns the shared null span
    and allocates nothing."""
    tracer = _current.tracer
    prof = _profiler()
    if prof is None:
        return tracer.span(name, **args) if tracer.enabled else _NULL_SPAN
    rf = prof.record_function(name, repr(args) if args else None)
    return _Both(tracer.span(name, **args), rf) if tracer.enabled else rf


class _CollectionSpans:
    """The ``gc.callbacks`` hook: each collection that starts while a
    profiler session records or ``observe()`` is on becomes a
    ``gc.collect`` profiler range and one ``ph: X`` event on the ambient
    tracer, both with its generation.  Off, a collection costs two flag
    reads."""

    def __init__(self):
        self._open = None        # (tracer, start µs or None, profiler range)

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            tracer, prof = _current.tracer, _profiler()
            if prof is None and not tracer.enabled:
                return
            rf = None
            if prof is not None:
                rf = prof.record_function("gc.collect",
                                          f"generation={info['generation']}")
                rf.__enter__()
            self._open = (tracer, tracer.now_us() if tracer.enabled else None, rf)
        elif self._open is not None:
            tracer, t0, rf = self._open
            self._open = None
            if rf is not None:
                rf.__exit__(None, None, None)
            if t0 is not None:
                tracer.complete("gc.collect", t0, tracer.now_us() - t0,
                                generation=info["generation"])


_COLLECTION_SPANS = _CollectionSpans()
gc.callbacks.append(_COLLECTION_SPANS)


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
