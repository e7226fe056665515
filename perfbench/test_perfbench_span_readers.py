"""The span metrics' readers on a hand-built trace: idle time charged to the
innermost span once, the parts within the window's idle time, the MoE and
optimizer shares by kernel correlation, and None where nothing is read."""

from types import SimpleNamespace as NS

import pytest

from perfbench import span_readers as sr
from perfbench.harness import Obs
from perfbench.trace import Trace


def _event(name, start_s, end_s, kernels=(), children=()):
    return NS(name=name, time_range=NS(start=start_s * 1e6, end=end_s * 1e6),
              kernels=[NS(name=f"k{i}", duration=us) for i, us in enumerate(kernels)],
              cpu_children=list(children))


def _serving_trace(items=1):
    """Device busy in [0, 1], [3, 4] and [10, 11] of a 12 s window; under
    ``server.batch`` (0.5–11.5): prefill 0.5–2.5, decode 2.5–9 holding the
    capture 5–8, which holds a collection 6–7, and release 9–10.5."""
    gc_ = _event("gc.collect", 6, 7)
    capture = _event("decoder.capture", 5, 8, children=[gc_])
    spans = [_event("server.prefill", 0.5, 2.5), _event("server.decode", 2.5, 9,
                                                        children=[capture]),
             _event("server.release", 9, 10.5)]
    batch = _event("server.batch", 0.5, 11.5, children=spans)
    host = [batch, *spans, capture, gc_, _event("aten::mm", 6.2, 6.4)]
    device = [("k", 0.0, 1.0), ("k", 3.0, 1.0), ("k", 10.0, 0.5), ("k", 10.2, 0.8)]
    return Trace(window_s=12.0, items=items, device=device, host=host)


def _obs(trace):
    return Obs(workload={}, config={}, setup_s=0.0, records=[], peak_bytes=0,
               trace=trace)


IDLE = {"prefill": 1.5, "decode": 0.5 + 1.0 + 1.0, "capture": 2.0, "gc": 1.0,
        "release": 1.0}


@pytest.mark.parametrize("items", [1, 4])
@pytest.mark.parametrize("part", sorted(IDLE))
def test_each_idle_piece_goes_to_its_innermost_span_once(part, items):
    read = getattr(sr, f"idle_{part}_ms")
    assert read(_obs(_serving_trace(items))) == pytest.approx(1e3 * IDLE[part] / items)


def test_the_parts_sum_to_at_most_the_windows_idle_time():
    t = _serving_trace()
    parts = sr.idle_parts(t)
    idle = t.window_s - t.busy_s
    assert idle == pytest.approx(9.0)
    assert sum(parts.values()) == pytest.approx(8.0) and sum(parts.values()) <= idle
    lo, hi = sr.idle_holes(t)
    assert list(zip(lo, hi)) == [(1.0, 3.0), (4.0, 10.0), (11.0, 12.0)]


def test_overlapping_activity_leaves_no_hole_between():
    t = Trace(window_s=5.0, items=1, device=[("a", 1.0, 2.0), ("b", 1.5, 0.5),
                                             ("c", 2.5, 2.5)])
    lo, hi = sr.idle_holes(t)
    assert list(zip(lo, hi)) == [(0.0, 1.0)]
    assert float((hi - lo).sum()) == pytest.approx(t.window_s - t.busy_s)


def _moe_trace():
    moe = [_event(n, 1 + i, 2 + i, kernels=[1e3 * (i + 1)]) for i, n in
           enumerate(("moe.route", "moe.dispatch", "moe.experts", "moe.combine"))]
    layer = _event("lm.layer", 1, 5, children=moe)
    prefill = _event("server.prefill", 0.5, 6, kernels=[500.0], children=[layer])
    stray = _event("moe.dispatch", 7, 8, kernels=[9e3])   # the eager decode step's
    decode = _event("server.decode", 6, 9, children=[stray])
    host = [prefill, layer, *moe, decode, stray]
    return Trace(window_s=10.0, items=1, device=[("k", 0.0, 0.0105)], host=host)


def test_the_moe_share_counts_dispatch_and_combine_inside_prefill_alone():
    share = sr.moe_dispatch_share(_obs(_moe_trace()))
    assert share == pytest.approx(100.0 * (2e3 + 4e3) / (500 + 1e3 + 2e3 + 3e3 + 4e3))


def test_the_optimizer_share_is_its_ranges_device_time_over_all_of_it():
    opt = _event("train_step.optimizer", 2, 3, kernels=[250.0, 250.0])
    step = _event("aten::mm", 0, 1, kernels=[1500.0])
    t = Trace(window_s=4.0, items=1, device=[("k", 0.0, 1.5e-3), ("o", 2.0, 5e-4)],
              host=[step, opt])
    assert sr.optimizer_share(_obs(t)) == pytest.approx(25.0)


READERS = ["idle_prefill_ms", "idle_capture_ms", "idle_decode_ms", "idle_release_ms",
           "idle_gc_ms", "moe_dispatch_share", "optimizer_share"]


@pytest.mark.parametrize("reader", READERS)
@pytest.mark.parametrize("trace", ["none", "no ranges", "no device"])
def test_a_reader_without_its_trace_or_ranges_reads_none(reader, trace):
    t = {"none": None,
         "no ranges": Trace(window_s=2.0, items=1, device=[("k", 0.5, 0.5)],
                            host=[_event("aten::mm", 0.4, 0.6, kernels=[500.0])]),
         "no device": Trace(window_s=2.0, items=1, device=[],
                            host=[_event("server.batch", 0, 1),
                                  _event("server.prefill", 0, 1),
                                  _event("train_step.optimizer", 1, 2)])}[trace]
    assert getattr(sr, reader)(_obs(t)) is None


def test_idle_gc_reads_zero_where_no_collection_ran():
    t = _serving_trace()
    t.host = [e for e in t.host if e.name != "gc.collect"]
    assert sr.idle_gc_ms(_obs(t)) == 0.0
    assert sr.idle_capture_ms(_obs(t)) == pytest.approx(3e3)
