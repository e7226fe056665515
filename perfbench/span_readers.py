"""What the span metrics read: the program's spans (``repro_torch.obs.span``,
profiler ranges in a traced run) against the traced window's device
activity, both on the profiler's clock.  Each ``metrics/<metric>.py`` binds
one of these as its ``read``; a reader returns None where the trace or the
spans it reads are missing, as in a program that has none.

Idle time: every interval of the traced window in which no device activity
ran is charged, piece by piece, to the innermost of the spans in
``IDLE_SPANS`` whose host interval covers the piece (the shortest, where
ranges nest), and to nothing where none does.  So each idle second is
charged at most once and the parts sum to at most the window's idle time.
"""

from __future__ import annotations

import numpy as np

from perfbench.trace import _device_us

#: the part of the idle time each span's name is charged to
IDLE_SPANS = {"prefill": "server.prefill", "capture": "decoder.capture",
              "decode": "server.decode", "release": "server.release",
              "gc": "gc.collect"}

#: the ranges whose device time is the MoE's dispatch and combine
MOE_DISPATCH = ("moe.dispatch", "moe.combine")


def idle_holes(trace) -> tuple[np.ndarray, np.ndarray]:
    """(starts, ends) in seconds of the intervals of ``[0, window_s]`` in
    which no device activity ran, in order."""
    start = np.array([s for _, s, _ in trace.device], dtype=float)
    order = np.argsort(start, kind="stable")
    start = start[order]
    end = np.maximum.accumulate(
        np.array([s + d for _, s, d in trace.device], dtype=float)[order])
    lo = np.concatenate(([0.0], end))
    hi = np.concatenate((start, [trace.window_s]))
    lo, hi = np.clip(lo, 0.0, trace.window_s), np.clip(hi, 0.0, trace.window_s)
    keep = hi > lo
    return lo[keep], hi[keep]


def innermost(trace, names) -> list[tuple[float, float, str]]:
    """The timeline cut into pieces (start, end, name), in seconds and in
    order, each under the shortest of the host ranges named in ``names``
    that covers it; pieces no such range covers are left out."""
    ranges = [(e.time_range.start / 1e6, e.time_range.end / 1e6, e.name)
              for e in trace.host if e.name in names]
    cuts = sorted({t for a, b, _ in ranges for t in (a, b)})
    opens = sorted(range(len(ranges)), key=lambda i: ranges[i][0])
    closes = sorted(range(len(ranges)), key=lambda i: ranges[i][1])
    active, pieces, o, c = set(), [], 0, 0
    for x, y in zip(cuts, cuts[1:]):
        while o < len(opens) and ranges[opens[o]][0] <= x:
            active.add(opens[o])
            o += 1
        while c < len(closes) and ranges[closes[c]][1] <= x:
            active.discard(closes[c])
            c += 1
        if active:
            _, _, name = min((ranges[i] for i in active), key=lambda r: r[1] - r[0])
            pieces.append((x, y, name))
    return pieces


def idle_parts(trace) -> dict | None:
    """Idle seconds of the traced window charged to each span of
    ``IDLE_SPANS`` (by its part's name); None without a trace, without
    device activity, or without the serving spans (no ``server.batch``)."""
    if trace is None or not trace.device or not any(
            e.name == "server.batch" for e in trace.host):
        return None
    lo, hi = idle_holes(trace)
    before = np.concatenate(([0.0], np.cumsum(hi - lo)))

    def idle_until(t: float) -> float:
        k = int(np.searchsorted(lo, t, side="right")) - 1
        return 0.0 if k < 0 else float(before[k] + min(max(t - lo[k], 0.0), hi[k] - lo[k]))

    part_of = {name: part for part, name in IDLE_SPANS.items()}
    parts = dict.fromkeys(IDLE_SPANS, 0.0)
    for x, y, name in innermost(trace, part_of):
        parts[part_of[name]] += idle_until(y) - idle_until(x)
    return parts


def _idle_ms(obs, part: str):
    parts = idle_parts(obs.trace)
    return None if parts is None else 1e3 * parts[part] / obs.trace.items


def idle_prefill_ms(obs):
    """Device idle under ``server.prefill`` (not under a collection), ms a
    traced batch."""
    return _idle_ms(obs, "prefill")


def idle_capture_ms(obs):
    """Device idle under ``decoder.capture``, the decode step's CUDA-graph
    capture (not under a collection), ms a traced batch."""
    return _idle_ms(obs, "capture")


def idle_decode_ms(obs):
    """Device idle under ``server.decode`` outside the capture and the
    collections (the eager first step and the replays), ms a traced batch."""
    return _idle_ms(obs, "decode")


def idle_release_ms(obs):
    """Device idle under ``server.release`` (the decoder, its graph and the
    caches freed; not under a collection), ms a traced batch."""
    return _idle_ms(obs, "release")


def idle_gc_ms(obs):
    """Device idle under ``gc.collect``, the interpreter's collections
    (0 where none ran), ms a traced batch."""
    return _idle_ms(obs, "gc")


def _within(event, names: tuple) -> list:
    """The host events named in ``names`` among ``event``'s descendants."""
    found = []
    for child in event.cpu_children:
        found += [child] if child.name in names else _within(child, names)
    return found


def moe_dispatch_share(obs):
    """Device time under the ``moe.dispatch`` and ``moe.combine`` ranges
    inside ``server.prefill`` over the device time under ``server.prefill``,
    in %."""
    t = obs.trace
    if t is None:
        return None
    prefills = [e for e in t.host if e.name == "server.prefill"]
    total = sum(_device_us(e, t.annotations) for e in prefills)
    moe = [m for e in prefills for m in _within(e, MOE_DISPATCH)]
    if not moe or not total:
        return None
    return 100.0 * sum(_device_us(m, t.annotations) for m in moe) / total


def optimizer_share(obs):
    """Device time under the ``train_step.optimizer`` range (AdamW and the
    copy-back of the parameters) over the traced steps' device time, in %."""
    t = obs.trace
    if t is None:
        return None
    total = sum(d for _, _, d in t.device)
    seconds, n = t.range_s("train_step.optimizer")
    return 100.0 * seconds / total if n and total else None
