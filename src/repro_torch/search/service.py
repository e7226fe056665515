"""Async what-if query service: many tenants, one evaluator.

The paper's headline use case — "what happens to the job if I change X?" —
arrives in production as a stream of *small heterogeneous* queries: a
single-config probe here, a per-axis sweep there, the occasional full grid.
Evaluating each one through its own :meth:`ChunkedEvaluator.evaluate` call
wastes almost the whole chunk: a 3-row sweep still pays for ``chunk`` padded
rows and a dispatch.

:class:`WhatIfService` applies continuous batching to model evaluation.  Queries enter a shared
:class:`~repro_torch.runtime.batching.AdmissionQueue`; a worker thread packs the
waiting rows — FIFO, across query boundaries — into the evaluator's
fixed-size chunk ("row slots"), evaluates it on the evaluator's device,
and scatters the results, copied back to the host, to each query's future.  A query larger than a chunk streams across several chunks;
a chunk usually carries rows from several queries.

Correctness contract (tested against the reference service):

* **Equivalence** — a query's resolved outputs are bit-for-bit identical to
  a sequential ``evaluator.evaluate(rows)`` call on the query's rows (its
  overrides with scalars broadcast to per-row columns — the form
  ``evaluate`` itself requires for a 1-row probe).  This is structural,
  not approximate: a chunk only coalesces queries that sweep the *same
  key-set*, so it runs the same batched operations the sequential call
  runs, and rows are bitwise-independent of their chunk neighbours (the
  evaluator's padding invariant).  Batching a key the sequential call left
  static changes which values are broadcast and can differ in the last
  float bit — the service never does that silently; the ``keys=...`` mode
  makes the expansion explicit.
* **No silent ``inf``** — rows whose closed-form model is out of domain
  (``valid == 0``) are re-costed through the evaluator's exact simulator
  path when the query asks for it (``exact_fallback=True``), and
  :meth:`QueryResult.best` raises :class:`InvalidGridError` rather than
  returning an unusable row otherwise.
* **Accounting** — per-query end-to-end latency (submit -> future resolved),
  queue depth at admission, and chunk-sharing counters; service-level
  p50/p99 via :class:`~repro_torch.runtime.batching.LatencyStats`.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import numpy as np

from repro_torch.obs import current as _obs_current
from repro_torch.runtime.batching import AdmissionQueue, LatencyStats
from repro_torch.spec import CostReport, PhaseBreakdown
from repro_torch.spec.report import invalid_reasons

from .evaluator import (
    Evaluator,
    ExactCostUnavailable,
    InvalidGridError,
    SearchResult,
    masked_total,
)
from .grid import space_block, space_size

__all__ = ["QueryStats", "QueryResult", "PhaseQueryResult", "WhatIfService"]

logger = logging.getLogger("repro_torch.search.service")


@dataclass
class QueryStats:
    """Per-query service accounting, attached to every :class:`QueryResult`."""

    latency_s: float = 0.0        # submit -> future resolved (end-to-end)
    queue_depth: int = 0          # queries already waiting at submit time
    n_rows: int = 0               # rows this query expanded to
    n_chunks: int = 0             # evaluator chunks its rows rode in
    n_shared_chunks: int = 0      # of those, chunks shared with other queries
    n_exact: int = 0              # rows re-costed via the exact simulator


@dataclass
class QueryResult(SearchResult):
    """A resolved query: :class:`SearchResult` (so ``best()`` keeps the
    raise-on-all-invalid semantics) plus the escape-hatch row mask and the
    service accounting.  ``total_cost`` holds exact-simulator seconds where
    ``exact`` is set, model seconds elsewhere, ``inf`` only for invalid rows
    the query did not ask to re-cost."""

    exact: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=bool))
    stats: QueryStats = field(default_factory=QueryStats)


@dataclass
class PhaseQueryResult:
    """A resolved *per-phase* what-if query (the typed query type).

    ``objective`` is the chosen phase's job-level cost per row
    (:class:`repro_torch.spec.PhaseBreakdown` field, seconds); ``feasible`` marks
    rows that are model-valid AND satisfy the total-cost constraint.
    ``report`` is the full typed :class:`repro_torch.spec.CostReport`, so callers
    can inspect every other phase (and the disaggregated validity flags) of
    the rows they asked about.
    """

    overrides: dict[str, np.ndarray]
    report: CostReport
    phase: str
    objective: np.ndarray
    feasible: np.ndarray
    total_max: float | None = None
    stats: QueryStats = field(default_factory=QueryStats)

    def best(self) -> tuple[int, float, dict[str, float]]:
        """Index, phase cost and assignment of the best feasible row."""
        obj = np.where(self.feasible, np.asarray(self.objective), np.inf)
        if obj.size == 0 or not np.isfinite(obj).any():
            constraint = (f" under total_cost <= {self.total_max}"
                          if self.total_max is not None else "")
            raise InvalidGridError(
                f"no feasible configuration for phase {self.phase!r}"
                f"{constraint}; invalid-constraint reasons: "
                + ("; ".join(self.report.invalid_reasons()) or "none")
            )
        i = int(np.argmin(obj))
        return i, float(obj[i]), {
            k: float(v[i]) for k, v in self.overrides.items()
        }


class _Query:
    """Internal pending-query record (rows + scatter-back accumulators)."""

    __slots__ = (
        "qid", "cols", "sig", "n", "taken", "done_rows", "outputs", "future",
        "exact_fallback", "t_submit", "stats",
    )

    def __init__(self, qid: int, cols: dict[str, np.ndarray], n: int,
                 exact_fallback: bool):
        self.qid = qid
        self.cols = cols              # the query's row columns, (n,) each
        self.sig = tuple(sorted(cols))   # key-set = batched-column identity
        self.n = n
        self.taken = 0                # rows already packed into chunks
        self.done_rows = 0
        self.outputs: dict[str, np.ndarray] | None = None
        self.future: Future = Future()
        self.exact_fallback = exact_fallback
        self.t_submit = time.perf_counter()
        self.stats = QueryStats(n_rows=n)


class WhatIfService:
    """Coalesce concurrent what-if queries into shared evaluator chunks.

    Parameters
    ----------
    evaluator : the shared (usually :class:`ChunkedEvaluator`) backend; its
        ``chunk`` is the row-slot count of one admission tick.  The worker
        thread's tensors live on the evaluator's device; results come back
        to the host as numpy arrays.
    keys : optional fixed universe of sweepable config keys.  When given,
        every query is expanded to sweep this whole key-set at admission
        (absent keys ride along at their base-config values), so ALL
        tenants share a single key-set for the service's lifetime.  Queries may then only use keys from
        the universe.  When ``None``, queries keep their own key-sets and
        only same-key-set queries coalesce into a chunk.
    window_s : admission window — after waking on work, the worker waits up
        to this long for more rows while the chunk is not yet full (the
        continuous-batching knob; 0 disables).  Bulk :meth:`map` submissions
        enqueue under one lock and do not need a window to coalesce.
    """

    def __init__(self, evaluator: Evaluator, *,
                 keys: Sequence[str] | None = None,
                 window_s: float = 0.0):
        self.evaluator = evaluator
        base = getattr(evaluator, "base_cfg", None)
        if base is None:
            raise TypeError(
                "WhatIfService needs an evaluator exposing base_cfg "
                "(a ChunkedEvaluator-style backend)"
            )
        self._base = {k: v.cpu().numpy() for k, v in base.items()}
        self._universe: list[str] | None = None
        if keys is not None:
            for k in keys:
                self._check_key(k)
            self._universe = list(dict.fromkeys(keys))
        self.window_s = float(window_s)
        self._queue: AdmissionQueue[_Query] = AdmissionQueue()
        self._qid = itertools.count()
        self._lock = threading.Lock()
        self.latency = LatencyStats()
        self.stats = {
            "queries": 0,
            "rows": 0,
            "chunks": 0,           # evaluator calls issued
            "shared_chunks": 0,    # chunks carrying >1 query
            "rows_padded": 0,      # slack rows in partially-filled chunks
            "exact_rows": 0,       # escape-hatch simulator re-costs
        }
        self._worker = threading.Thread(
            target=self._run, name="whatif-service", daemon=True
        )
        self._worker.start()

    # ------------------------------------------------------------------
    # submission API
    # ------------------------------------------------------------------

    def _check_key(self, k: str) -> None:
        if k not in self._base:
            raise KeyError(f"unknown config key: {k!r}")

    def _normalize(self, overrides: Mapping[str, Any]) -> tuple[dict, int]:
        """Validate an override mapping and expand it to (n,) row columns.

        Scalars broadcast; 1-D values must agree on a common length.  An
        all-scalar mapping is a single-config probe (n=1).  In fixed-
        universe mode, keys the query did not override are filled with
        their base-config values so every tenant sweeps the same key-set.
        """
        if not overrides:
            raise ValueError("query has no overrides")
        n = None
        arrs: dict[str, np.ndarray] = {}
        for k, v in overrides.items():
            self._check_key(k)
            if self._universe is not None and k not in self._universe:
                raise KeyError(
                    f"key {k!r} is outside this service's fixed key "
                    f"universe {self._universe}"
                )
            a = np.asarray(v, dtype=self._base[k].dtype)
            if a.ndim > 1:
                raise ValueError(f"override {k!r} must be scalar or 1-D")
            if a.ndim == 1:
                if a.size == 0:
                    raise ValueError(f"override {k!r} is empty (0-length query)")
                if n is None:
                    n = a.size
                elif a.size != n:
                    raise ValueError("all batched overrides must share a length")
            arrs[k] = a
        n = 1 if n is None else n
        cols = {
            k: (a if a.ndim == 1 else np.full(n, a, dtype=a.dtype))
            for k, a in arrs.items()
        }
        if self._universe is not None:
            for k in self._universe:
                if k not in cols:
                    fill = self._base[k]
                    cols[k] = np.full(n, fill, dtype=fill.dtype)
        return cols, n

    def submit(self, overrides: Mapping[str, Any], *,
               exact_fallback: bool = False) -> Future:
        """Admit one query; returns a future resolving to :class:`QueryResult`.

        ``overrides`` maps config keys to a scalar (applied to every row) or
        a 1-D array of per-row values — the same contract as
        ``ChunkedEvaluator.evaluate``, whose sequential result this query's
        resolution is bit-for-bit equal to.
        """
        cols, n = self._normalize(overrides)
        q = self._make_query(cols, n, exact_fallback)
        # depth is recorded BEFORE publishing: once put() returns, a fast
        # worker may already have resolved the future and handed q.stats out
        q.stats.queue_depth = len(self._queue)
        depth = self._queue.put(q)
        ob = _obs_current()
        if ob.enabled:
            ob.tracer.counter("service queue", depth=depth)
        return q.future

    def probe(self, assignment: Mapping[str, float], *,
              exact_fallback: bool = True) -> Future:
        """Single-config what-if probe (1 row; escape hatch on by default —
        a probe of an out-of-domain config should cost it, not return inf)."""
        return self.submit(assignment, exact_fallback=exact_fallback)

    def sweep(self, key: str, values: Sequence[float], *,
              base: Mapping[str, float] | None = None,
              exact_fallback: bool = False) -> Future:
        """Per-axis sweep: ``key`` takes each of ``values``; ``base`` pins
        other keys for every row."""
        ov: dict[str, Any] = dict(base or {})
        ov[key] = np.asarray(list(values), dtype=np.float64)
        return self.submit(ov, exact_fallback=exact_fallback)

    def grid(self, space: Mapping[str, Sequence[float]], *,
             base: Mapping[str, float] | None = None,
             exact_fallback: bool = False) -> Future:
        """Full Cartesian grid over ``space`` (streamed through as many
        chunks as it needs; rides shared chunks at its edges)."""
        cols = space_block(space, 0, space_size(space))
        ov: dict[str, Any] = dict(base or {})
        ov.update(cols)
        return self.submit(ov, exact_fallback=exact_fallback)

    def phase_query(self, overrides: Mapping[str, Any], *,
                    phase: str, total_max: float | None = None) -> Future:
        """Typed per-phase what-if query: minimize one phase's cost, with an
        optional job-total budget.

        "Which of these configs minimizes ``shuffle`` time subject to
        ``j_totalCost <= total_max``?"  ``phase`` is a
        :class:`repro_torch.spec.PhaseBreakdown` field; rows are evaluated
        through the exact same coalesced chunks as :meth:`submit` (identical
        numbers), then lifted into a :class:`repro_torch.spec.CostReport` — the
        future resolves to :class:`PhaseQueryResult`.  Requires a backend
        with phase reports (the Hadoop job model).
        """
        if phase not in PhaseBreakdown.names():
            raise KeyError(
                f"unknown phase: {phase!r} (phases: {list(PhaseBreakdown.names())})"
            )
        inner = self.submit(overrides)
        out: Future = Future()

        def _lift(f: Future) -> None:
            try:
                out.set_result(self._phase_result(f.result(), phase, total_max))
            except BaseException as e:
                out.set_exception(e)

        inner.add_done_callback(_lift)
        return out

    def _phase_result(self, qr: QueryResult, phase: str,
                      total_max: float | None) -> PhaseQueryResult:
        if "m_ioReadCost" not in qr.outputs:
            raise TypeError(
                "phase queries need per-phase model outputs (the Hadoop job "
                f"model); this service's backend emits {sorted(qr.outputs)[:4]}..."
            )
        cfg = {**self._base, **qr.overrides}
        report = CostReport.from_outputs(qr.outputs, cfg)
        feasible = np.asarray(qr.outputs["valid"]) > 0
        if total_max is not None:
            feasible = feasible & (np.asarray(report.total_cost) <= total_max)
        return PhaseQueryResult(
            overrides=dict(qr.overrides),
            report=report,
            phase=phase,
            objective=np.asarray(report.phases[phase]),
            feasible=feasible,
            total_max=total_max,
            stats=qr.stats,
        )

    def map(self, queries: Sequence[Mapping[str, Any]], *,
            exact_fallback: bool = False) -> list[QueryResult]:
        """Submit many queries under one admission lock and wait for all.
        One wake-up sees every row, so coalescing is deterministic."""
        qs = []
        for ov in queries:
            cols, n = self._normalize(ov)
            qs.append(self._make_query(cols, n, exact_fallback))
        depth = len(self._queue)
        for i, q in enumerate(qs):
            q.stats.queue_depth = depth + i
        self._queue.put_many(qs)
        ob = _obs_current()
        if ob.enabled:
            ob.tracer.counter("service queue", depth=depth + len(qs))
        return [q.future.result() for q in qs]

    def _make_query(self, cols, n, exact_fallback) -> _Query:
        q = _Query(next(self._qid), cols, n, exact_fallback)
        with self._lock:
            self.stats["queries"] += 1
            self.stats["rows"] += n
        ob = _obs_current()
        if ob.enabled:
            ob.registry.counter("service.queries").inc()
            ob.registry.counter("service.rows").inc(n)
            # async span: begins here on the submitting thread, ends in
            # _resolve on the worker — the query's submit->resolve life
            ob.tracer.async_begin("query", q.qid, rows=n,
                                  keys=",".join(q.sig))
        return q

    # ------------------------------------------------------------------
    # worker: pack -> evaluate -> scatter
    # ------------------------------------------------------------------

    def _run(self) -> None:
        chunk = self.evaluator.chunk
        while True:
            if not self._queue.wait():
                return                      # closed and drained
            if self.window_s > 0:
                deadline = time.perf_counter() + self.window_s
                while (time.perf_counter() < deadline
                       and self._pending_rows() < chunk):
                    time.sleep(min(self.window_s / 10, 1e-3))
            segments = self._pack(chunk)
            if segments:
                try:
                    self._evaluate_segments(segments)
                except BaseException as e:     # resolve, don't kill the loop
                    for q, _, _, _ in segments:
                        # drop a partially-packed query's remaining rows
                        # BEFORE failing its future — they would be wasted
                        # chunks, and a caller unblocked by the exception
                        # must not observe the dead query still queued
                        if q.taken < q.n:
                            self._queue.remove(q)
                        if not q.future.done():
                            q.future.set_exception(e)

    def _pending_rows(self) -> int:
        """Rows the NEXT chunk could actually pack: only queries sharing the
        head query's key-set coalesce, so other signatures don't count."""
        items = self._queue.items()
        if not items:
            return 0
        sig = items[0].sig
        return sum(q.n - q.taken for q in items if q.sig == sig)

    def _pack(self, chunk: int) -> list[tuple[_Query, int, int, int]]:
        """Fill up to ``chunk`` row slots FIFO across query boundaries,
        coalescing only queries that sweep the head query's key-set (so the
        chunk runs exactly the operations their sequential calls would).
        Returns ``(query, query_row_start, n_rows, chunk_offset)`` segments;
        a query leaves the queue once all its rows are packed."""
        segments: list[tuple[_Query, int, int, int]] = []
        offset = 0
        sig = None
        for q in self._queue.items():       # FIFO snapshot; worker-only pops
            if offset >= chunk:
                break
            if sig is None:
                sig = q.sig
            elif q.sig != sig:
                continue                    # different key-set: next chunk
            take = min(chunk - offset, q.n - q.taken)
            segments.append((q, q.taken, take, offset))
            q.taken += take
            offset += take
            if q.taken == q.n:
                self._queue.remove(q)
        return segments

    def _evaluate_segments(self, segments) -> None:
        n_rows = sum(take for _, _, take, _ in segments)
        cols: dict[str, np.ndarray] = {}
        for k in segments[0][0].sig:        # shared key-set by construction
            col = np.empty(n_rows, dtype=segments[0][0].cols[k].dtype)
            for q, q_start, take, offset in segments:
                col[offset:offset + take] = q.cols[k][q_start:q_start + take]
            cols[k] = col

        ob = _obs_current()
        with ob.tracer.span("service.chunk", rows=n_rows,
                            queries=len(segments)):
            out = self.evaluator.evaluate(cols).outputs
        with self._lock:
            self.stats["chunks"] += 1
            if len(segments) > 1:
                self.stats["shared_chunks"] += 1
            self.stats["rows_padded"] += self.evaluator.chunk - n_rows
        if ob.enabled:
            reg = ob.registry
            reg.counter("service.chunks").inc()
            if len(segments) > 1:
                reg.counter("service.shared_chunks").inc()
            reg.counter("service.rows_padded").inc(
                self.evaluator.chunk - n_rows)
            ob.tracer.counter("chunk sharing",
                              queries_per_chunk=len(segments))
            ob.tracer.counter("service queue", depth=len(self._queue))

        shared = len(segments) > 1
        for q, q_start, take, offset in segments:
            if q.outputs is None:
                q.outputs = {k: np.empty(q.n, dtype=v.dtype)
                             for k, v in out.items()}
            for k, v in out.items():
                q.outputs[k][q_start:q_start + take] = v[offset:offset + take]
            q.done_rows += take
            q.stats.n_chunks += 1
            q.stats.n_shared_chunks += int(shared)
            if q.done_rows == q.n:
                self._resolve(q)

    def _resolve(self, q: _Query) -> None:
        outputs = q.outputs
        valid = outputs["valid"] > 0
        total = masked_total(outputs, self.evaluator.cost_key)
        exact = np.zeros(q.n, dtype=bool)
        if q.exact_fallback and not valid.all():
            cfg = {**self._base, **q.cols}
            for i in np.flatnonzero(~valid):
                try:
                    cost = self.evaluator.exact_cost(
                        {k: float(v[i]) for k, v in q.cols.items()}
                    )
                except ExactCostUnavailable as e:
                    logger.info("exact fallback skipped query %d row %d: %s",
                                q.qid, i, e)
                    continue            # row stays inf, explicitly logged
                if cost is None:
                    break               # backend has no exact path
                logger.info(
                    "valid==0 exact fallback: query %d row %d re-costed via "
                    "the exact simulator (%.6gs); failed constraints: %s",
                    q.qid, i, cost,
                    "; ".join(invalid_reasons(outputs, i, cfg)) or "unknown",
                )
                total[i] = cost
                exact[i] = True
            with self._lock:
                self.stats["exact_rows"] += int(exact.sum())
            q.stats.n_exact = int(exact.sum())
        q.stats.latency_s = time.perf_counter() - q.t_submit
        self.latency.record(q.stats.latency_s)
        ob = _obs_current()
        if ob.enabled:
            ob.registry.histogram("service.latency_s").record(
                q.stats.latency_s)
            if q.stats.n_exact:
                ob.registry.counter("service.exact_rows").inc(q.stats.n_exact)
            ob.tracer.async_end("query", q.qid,
                                chunks=q.stats.n_chunks,
                                shared=q.stats.n_shared_chunks)
        q.future.set_result(QueryResult(
            overrides=dict(q.cols),
            outputs=outputs,
            total_cost=total,
            exact=exact,
            stats=q.stats,
        ))

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def close(self, wait: bool = True) -> None:
        """Stop admitting; the worker drains already-queued queries, then
        exits.  Idempotent."""
        self._queue.close()
        if wait and self._worker.is_alive():
            self._worker.join()

    def __enter__(self) -> "WhatIfService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def summary(self) -> dict:
        """Service-level counters + latency percentiles (for benchmarks)."""
        with self._lock:
            s = dict(self.stats)
        s["peak_queue_depth"] = self._queue.peak_depth
        s.update({f"latency_{k}": v for k, v in self.latency.summary().items()})
        return s
