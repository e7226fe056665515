"""Span tracer emitting Chrome trace-event JSON (Perfetto-loadable).

The observability layer's timeline side.  A :class:`Tracer` collects
`trace-event format <https://ui.perfetto.dev>`_ records:

* ``span(name)`` — nested wall-clock duration events (``ph: B/E``) on the
  calling thread's track; thread-safe, nesting handled by the viewer.
* ``complete(...)`` — a single ``ph: X`` event with an explicit start and
  duration, used for *virtual-time* tracks (the cluster DES emits simulated
  seconds as microseconds; see :mod:`repro_torch.obs.destrace`).
* ``instant(name)`` — ``ph: i`` markers (preemptions, failures, compiles).
* ``counter(track, **series)`` — ``ph: C`` counter tracks (queue depth,
  configs/s, loss curves).
* ``async_begin/async_end`` — ``ph: b/e`` events tied by id, for spans that
  start on one thread and finish on another (a query's submit→resolve life
  across the service worker).

Timestamps are microseconds from the tracer's construction
(``time.perf_counter`` based), so traces start at t=0.  ``origin_ns``, the
epoch nanoseconds of t=0 (written as ``otherData.origin_ns``), puts them on
``torch.profiler``'s timeline, whose events are epoch nanoseconds
(``trace_start_ns()`` plus each event's offset): ``ts + origin_ns / 1e3``.
All methods are safe from any thread; each append takes one short lock.

``NULL_TRACER`` is the off switch: every method is a no-op and ``span()``
returns a shared reusable context manager, so disabled instrumentation
costs one attribute lookup and no allocation.
"""

from __future__ import annotations

import json
import threading
import time

__all__ = ["Tracer", "NULL_TRACER"]


class _Span:
    """Context manager emitting B on enter / E on exit for one tracer."""

    __slots__ = ("_tracer", "_name", "_args")

    def __init__(self, tracer: "Tracer", name: str, args: dict | None):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self) -> "_Span":
        self._tracer._emit("B", self._name, args=self._args)
        return self

    def __exit__(self, *exc) -> None:
        self._tracer._emit("E", self._name)


class Tracer:
    """Collects Chrome trace events; ``write(path)`` dumps Perfetto JSON."""

    #: mirrors MetricsRegistry.enabled — hot paths check one attribute.
    enabled: bool = True

    def __init__(self, *, process_name: str = "repro_torch") -> None:
        # the anchor pair: t=0 on the perf_counter clock and on the epoch's
        self._t0 = time.perf_counter_ns()
        #: epoch nanoseconds of the trace's t=0
        self.origin_ns = time.time_ns()
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._pid = 1
        self.process_name(self._pid, process_name)

    # ---------------------------------------------------------------- core

    def now_us(self) -> float:
        """Microseconds since tracer construction (the trace clock)."""
        return (time.perf_counter_ns() - self._t0) / 1e3

    def _emit(
        self,
        ph: str,
        name: str,
        *,
        ts: float | None = None,
        dur: float | None = None,
        pid: int | None = None,
        tid: int | None = None,
        args: dict | None = None,
        extra: dict | None = None,
    ) -> None:
        ev: dict = {
            "name": name,
            "ph": ph,
            "ts": self.now_us() if ts is None else float(ts),
            "pid": self._pid if pid is None else pid,
            "tid": threading.get_ident() % 1_000_000 if tid is None else tid,
        }
        if dur is not None:
            ev["dur"] = float(dur)
        if args:
            ev["args"] = args
        if extra:
            ev.update(extra)
        with self._lock:
            self._events.append(ev)

    def event(self, ev: dict) -> None:
        """Append a raw pre-built trace event (virtual-time producers)."""
        with self._lock:
            self._events.append(ev)

    # ------------------------------------------------------------ wall time

    def span(self, name: str, **args) -> _Span:
        """``with tracer.span("evaluate", rows=n): ...`` — nested B/E pair."""
        return _Span(self, name, args or None)

    def complete(
        self,
        name: str,
        ts: float,
        dur: float,
        *,
        pid: int | None = None,
        tid: int | None = None,
        **args,
    ) -> None:
        """One ``ph: X`` event with explicit start/duration (virtual time)."""
        self._emit("X", name, ts=ts, dur=dur, pid=pid, tid=tid,
                   args=args or None)

    def instant(
        self,
        name: str,
        *,
        ts: float | None = None,
        pid: int | None = None,
        tid: int | None = None,
        scope: str = "t",
        **args,
    ) -> None:
        self._emit("i", name, ts=ts, pid=pid, tid=tid, args=args or None,
                   extra={"s": scope})

    def counter(
        self,
        track: str,
        *,
        ts: float | None = None,
        pid: int | None = None,
        **series: float,
    ) -> None:
        """One sample on a counter track (``ph: C``); each keyword is a
        series on that track."""
        self._emit("C", track, ts=ts, pid=pid, tid=0,
                   args={k: float(v) for k, v in series.items()})

    # ------------------------------------------------------- async (cross-thread)

    def async_begin(self, name: str, id: int, *, category: str = "repro_torch",
                    **args) -> None:
        self._emit("b", name, args=args or None,
                   extra={"cat": category, "id": id})

    def async_end(self, name: str, id: int, *, category: str = "repro_torch",
                  **args) -> None:
        self._emit("e", name, args=args or None,
                   extra={"cat": category, "id": id})

    # ------------------------------------------------------------- metadata

    def process_name(self, pid: int, name: str) -> None:
        self._emit("M", "process_name", ts=0.0, pid=pid, tid=0,
                   args={"name": name})

    def thread_name(self, pid: int, tid: int, name: str,
                    sort_index: int | None = None) -> None:
        self._emit("M", "thread_name", ts=0.0, pid=pid, tid=tid,
                   args={"name": name})
        if sort_index is not None:
            self._emit("M", "thread_sort_index", ts=0.0, pid=pid, tid=tid,
                       args={"sort_index": sort_index})

    # --------------------------------------------------------------- export

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def to_json(self) -> str:
        return json.dumps({"traceEvents": self.events(),
                           "otherData": {"origin_ns": self.origin_ns}})

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _NullTracer(Tracer):
    """The default tracer: records nothing, allocates nothing per call."""

    enabled = False

    def __init__(self) -> None:
        self._t0 = 0
        self.origin_ns = 0
        self._events = []
        self._lock = threading.Lock()
        self._pid = 1

    def _emit(self, *a, **k) -> None:
        pass

    def event(self, ev: dict) -> None:
        pass

    def span(self, name: str, **args) -> _NullSpan:  # type: ignore[override]
        return _NULL_SPAN

    def events(self) -> list[dict]:
        return []


#: process-wide off switch — handed out by ``repro_torch.obs.current()`` until an
#: ``observe()`` context installs a live tracer.
NULL_TRACER: Tracer = _NullTracer()
