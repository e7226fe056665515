"""Zero-dependency metrics core: counters, gauges, histograms, a registry.

The observability layer's number side.  Everything here is plain stdlib —
no jax, no numpy — so instrumented modules can import it without touching
the accelerator stack, and a :class:`MetricsRegistry` can live inside a
worker thread, a benchmark process, or a unit test with no setup.

Design rules (the contract the instrumented hot paths rely on):

* **Off is free.**  :data:`NULL_REGISTRY` hands out shared no-op
  instruments; ``NULL_REGISTRY.counter("x").inc()`` is a constant-time
  method call on a singleton that allocates nothing and takes no lock.
  Instrumentation that must skip even that guards on
  ``registry.enabled`` / ``Observability.enabled``.
* **Thread-safe.**  Real instruments take one uncontended lock per op;
  the registry locks only on instrument *creation* (get-or-create), so
  steady-state updates never contend on the registry itself.
* **Mergeable.**  ``MetricsRegistry.merge`` folds another registry (e.g. a
  per-worker one) into this one: counters add, gauges last-write-win,
  histograms pool their samples — the same semantics as
  :meth:`repro_torch.runtime.batching.LatencyStats.merge`.
"""

from __future__ import annotations

import json
import math
import threading
from typing import Iterable, Mapping

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_REGISTRY",
    "percentile_interp",
]


def percentile_interp(ordered: Iterable[float], p: float) -> float:
    """Exact linear-interpolated percentile of an already-sorted sequence.

    The one percentile implementation of the repo (histograms here,
    :class:`~repro_torch.runtime.batching.LatencyStats`): ``rank = (n-1) * p/100``
    interpolated between the two neighbouring order statistics — identical
    to ``numpy.percentile(..., method="linear")`` but with well-defined
    small-sample behavior:

    * empty input  -> ``0.0`` (nothing observed, not ``nan``);
    * one sample   -> that sample for every ``p``;
    * an integral rank returns the order statistic *exactly* (no ``0 * inf``
      corner when the other neighbour is infinite);
    * equal neighbours (both ``inf`` included) return the common value.
    """
    vals = ordered if isinstance(ordered, (list, tuple)) else list(ordered)
    n = len(vals)
    if n == 0:
        return 0.0
    if n == 1:
        return float(vals[0])
    if p <= 0.0:
        return float(vals[0])
    if p >= 100.0:
        return float(vals[-1])
    rank = (n - 1) * (p / 100.0)
    lo = int(math.floor(rank))
    hi = min(lo + 1, n - 1)
    frac = rank - lo
    a, b = float(vals[lo]), float(vals[hi])
    if frac == 0.0 or a == b:
        return a
    return a + (b - a) * frac


class Counter:
    """A monotonically-increasing count (events, rows, compiles)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease (n={n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """A point-in-time value (queue depth, configs/s, padding fraction)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, d: float) -> None:
        with self._lock:
            self._value += float(d)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """A streaming sample distribution (latencies, chunk durations).

    Keeps raw samples (observability cardinalities here are small — one
    entry per chunk/query/step, not per config row), so percentiles are
    exact and merges are lossless.
    """

    __slots__ = ("name", "_samples", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._samples: list[float] = []
        self._lock = threading.Lock()

    def record(self, v: float) -> None:
        with self._lock:
            self._samples.append(float(v))

    def samples(self) -> list[float]:
        with self._lock:
            return list(self._samples)

    @property
    def count(self) -> int:
        with self._lock:
            return len(self._samples)

    def percentile(self, p: float) -> float:
        with self._lock:
            return percentile_interp(sorted(self._samples), p)

    def summary(self) -> dict[str, float]:
        with self._lock:
            s = sorted(self._samples)
        n = len(s)
        return {
            "count": n,
            "sum": math.fsum(s),
            "mean": math.fsum(s) / n if n else 0.0,
            "min": s[0] if n else 0.0,
            "max": s[-1] if n else 0.0,
            "p50": percentile_interp(s, 50.0),
            "p99": percentile_interp(s, 99.0),
        }


class MetricsRegistry:
    """A named collection of instruments with snapshot/merge/JSON export.

    ``counter(name)`` / ``gauge(name)`` / ``histogram(name)`` get-or-create;
    asking for an existing name with a different instrument kind raises, so
    metric names cannot silently change meaning between call sites.
    """

    #: real registries record; the null registry overrides this to False so
    #: hot paths can skip even cheap bookkeeping with one attribute check.
    enabled: bool = True

    def __init__(self) -> None:
        self._instruments: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name)
            elif type(inst) is not cls:
                raise TypeError(
                    f"metric {name!r} is a {type(inst).__name__}, "
                    f"not a {cls.__name__}"
                )
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._instruments)

    def snapshot(self) -> dict[str, object]:
        """Flat ``{name: value}`` view; histograms expand to their summary
        dict.  Plain JSON-serializable types only."""
        with self._lock:
            items = list(self._instruments.items())
        out: dict[str, object] = {}
        for name, inst in sorted(items):
            if isinstance(inst, Histogram):
                out[name] = inst.summary()
            else:
                v = inst.value
                out[name] = int(v) if float(v).is_integer() else v
        return out

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold ``other`` (e.g. a per-worker registry) into this one.

        Counters add, gauges take the other's value (last write wins),
        histograms pool samples.  Returns ``self`` for chaining.
        """
        with other._lock:
            items = list(other._instruments.items())
        for name, inst in items:
            if isinstance(inst, Counter):
                self.counter(name).inc(inst.value)
            elif isinstance(inst, Gauge):
                self.gauge(name).set(inst.value)
            elif isinstance(inst, Histogram):
                mine = self.histogram(name)
                for v in inst.samples():
                    mine.record(v)
        return self

    def to_json(self, *, indent: int | None = 2) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)


class _NullInstrument:
    """Shared do-nothing counter/gauge/histogram (the off switch)."""

    __slots__ = ()
    name = "null"
    value = 0.0
    count = 0

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def add(self, d: float) -> None:
        pass

    def record(self, v: float) -> None:
        pass

    def samples(self) -> list[float]:
        return []

    def percentile(self, p: float) -> float:
        return 0.0

    def summary(self) -> dict[str, float]:
        return {}


_NULL_INSTRUMENT = _NullInstrument()


class _NullRegistry(MetricsRegistry):
    """The default registry: every instrument is the shared no-op."""

    enabled = False

    def __init__(self) -> None:
        super().__init__()

    def _get(self, name: str, cls):
        return _NULL_INSTRUMENT

    def snapshot(self) -> dict[str, object]:
        return {}

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        return self


#: process-wide off switch — handed out by ``repro_torch.obs.current()`` until an
#: ``observe()`` context installs a live registry.
NULL_REGISTRY: MetricsRegistry = _NullRegistry()


def _is_mapping(x) -> bool:
    return isinstance(x, Mapping)
