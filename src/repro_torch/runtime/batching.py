"""Generic admission/batching machinery shared by the serving loops.

Two production services in this repo have the same shape: heterogeneous
requests arrive over time, a fixed-size compiled executable does the work,
and throughput comes from packing waiting requests into that executable's
static batch.  :mod:`repro_torch.runtime.serve_loop` does it with KV-cache slots
and lockstep decode ticks; :mod:`repro_torch.search.service` does it with rows of
a :class:`~repro_torch.search.evaluator.ChunkedEvaluator` chunk.  This module
holds the pieces both share so the admission semantics (FIFO, depth
accounting, end-to-end latency) stay identical:

* :class:`AdmissionQueue` — thread-safe FIFO with depth accounting and a
  condition variable for blocking consumers.  Single-threaded callers (the
  LM server's synchronous ``generate``) pay one uncontended lock per op.
* :class:`LatencyStats` — streaming latency recorder with p50/p99/mean.
  Latency is *end-to-end* by convention: measured from admission-queue
  entry to final completion, never from a mid-flight milestone (that was
  the ``Server.generate`` bug this module's extraction fixed).
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Generic, Iterator, TypeVar

from repro_torch.obs.metrics import percentile_interp

__all__ = ["AdmissionQueue", "LatencyStats"]

T = TypeVar("T")


class LatencyStats:
    """Streaming end-to-end latency recorder (seconds) with percentiles.

    Percentiles use the repo's one interpolation rule
    (:func:`repro_torch.obs.percentile_interp` — linear between order statistics,
    the same method ``numpy.percentile`` defaults to), with well-defined
    small-sample behavior: no samples -> 0.0, one sample -> that sample for
    every ``p``.  :meth:`merge` pools per-worker recorders losslessly.
    """

    def __init__(self) -> None:
        self._samples: list[float] = []
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(float(seconds))

    def merge(self, other: "LatencyStats") -> "LatencyStats":
        """Pool another recorder's samples into this one (e.g. combining
        per-worker stats).  Exact: percentiles of the merged recorder are
        percentiles of the union sample set.  Returns ``self``."""
        with other._lock:
            theirs = list(other._samples)
        with self._lock:
            self._samples.extend(theirs)
        return self

    @property
    def count(self) -> int:
        with self._lock:
            return len(self._samples)

    def mean(self) -> float:
        with self._lock:
            return (math.fsum(self._samples) / len(self._samples)
                    if self._samples else 0.0)

    def percentile(self, p: float) -> float:
        """Linear-interpolated percentile; 0.0 when nothing was recorded."""
        with self._lock:
            return percentile_interp(sorted(self._samples), p)

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p99(self) -> float:
        return self.percentile(99.0)

    def summary(self) -> dict[str, float]:
        return {
            "count": self.count,
            "mean_s": self.mean(),
            "p50_s": self.p50,
            "p99_s": self.p99,
        }


class AdmissionQueue(Generic[T]):
    """Thread-safe FIFO of pending work with depth accounting.

    Producers :meth:`put`; the consumer inspects the head with :meth:`peek`
    (so it can drain an item across several batches before retiring it with
    :meth:`pop`) or drains whole items with :meth:`take`.  :meth:`wait`
    blocks until work arrives or the queue is closed; :meth:`close` wakes
    every waiter so consumers can drain and exit.  ``peak_depth`` records
    the high-water mark for queue-pressure reporting.
    """

    def __init__(self, *, depth_gauge=None) -> None:
        self._items: deque[T] = deque()
        self._cond = threading.Condition()
        self._closed = False
        self.peak_depth = 0
        #: optional observability hook: any object with ``set(depth)`` (a
        #: repro_torch.obs Gauge) called under the lock on every depth change.
        self.depth_gauge = depth_gauge

    def _depth_changed(self) -> None:
        if self.depth_gauge is not None:
            self.depth_gauge.set(len(self._items))

    def __len__(self) -> int:
        with self._cond:
            return len(self._items)

    @property
    def depth(self) -> int:
        return len(self)

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def put(self, item: T) -> int:
        """Enqueue; returns the depth *including* the new item."""
        with self._cond:
            if self._closed:
                raise RuntimeError("cannot put into a closed AdmissionQueue")
            self._items.append(item)
            depth = len(self._items)
            self.peak_depth = max(self.peak_depth, depth)
            self._depth_changed()
            self._cond.notify_all()
            return depth

    def put_many(self, items: Iterator[T] | list[T]) -> int:
        """Enqueue a batch under one lock (single wake-up => one admission
        window sees all of them; the coalescing path in tests/benchmarks)."""
        with self._cond:
            if self._closed:
                raise RuntimeError("cannot put into a closed AdmissionQueue")
            n0 = len(self._items)
            self._items.extend(items)
            depth = len(self._items)
            self.peak_depth = max(self.peak_depth, depth)
            self._depth_changed()
            self._cond.notify_all()
            return depth - n0

    def peek(self) -> T | None:
        with self._cond:
            return self._items[0] if self._items else None

    def items(self) -> list[T]:
        """Shallow snapshot of the pending items (for depth/row gauges and
        consumers that select by predicate rather than strict FIFO)."""
        with self._cond:
            return list(self._items)

    def remove(self, item: T) -> bool:
        """Remove a specific pending item (identity match); ``False`` if it
        is no longer queued.  O(depth) — admission queues stay short."""
        with self._cond:
            try:
                self._items.remove(item)
                self._depth_changed()
                return True
            except ValueError:
                return False

    def pop(self) -> T | None:
        with self._cond:
            item = self._items.popleft() if self._items else None
            if item is not None:
                self._depth_changed()
            return item

    def take(self, max_items: int | None = None) -> list[T]:
        """Pop up to ``max_items`` (all pending when ``None``)."""
        with self._cond:
            n = len(self._items) if max_items is None else min(max_items,
                                                               len(self._items))
            out = [self._items.popleft() for _ in range(n)]
            if out:
                self._depth_changed()
            return out

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the queue is non-empty or closed.  Returns ``True``
        when items are available, ``False`` on close-with-nothing-pending or
        timeout."""
        with self._cond:
            self._cond.wait_for(
                lambda: self._items or self._closed, timeout=timeout
            )
            return bool(self._items)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
