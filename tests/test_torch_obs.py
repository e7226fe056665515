"""The port's span helper ``repro_torch.obs.span``: the null span when off,
a ``torch.profiler`` range while a session records, a B/E pair under
``observe()``; collections as spans; the tracer on the profiler's clock."""

import gc
import json
import sys
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.obs import _COLLECTION_SPANS, observe, span
from repro_torch.obs.trace import _NULL_SPAN, NULL_TRACER, Tracer, _Span


def _profiled(body):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        body()
    return prof


def _named(prof, name):
    return [e for e in prof.events() if e.name == name]


def test_off_it_is_the_null_span_and_the_profiler_sees_nothing():
    assert span("x.off") is _NULL_SPAN
    assert span("x.off", rows=3) is _NULL_SPAN
    with span("x.off"):
        torch.ones(4).add(1)

    def body():
        torch.ones(4).add(1)
    with span("x.outside"):
        prof = _profiled(body)
    assert not _named(prof, "x.outside") and not _named(prof, "x.off")


@pytest.mark.parametrize("traced", [False, True])
def test_a_recording_profiler_gets_a_range_and_observe_a_pair(traced):
    def body():
        with span("x.on", rows=3):
            torch.ones(4).mul(2)

    if traced:
        with observe() as ob:
            prof = _profiled(body)
        pairs = [(e["ph"], e.get("args")) for e in ob.tracer.events()
                 if e["name"] == "x.on"]
        assert pairs == [("B", {"rows": 3}), ("E", None)]
    else:
        prof = _profiled(body)
    (rng,) = _named(prof, "x.on")
    assert any(c.name == "aten::mul" for c in rng.cpu_children)


def test_observe_alone_gets_a_pair_and_no_range():
    with observe() as ob:
        sp = span("x.observed", step=1)
        with sp:
            pass
    assert isinstance(sp, _Span)     # the tracer's own: no profiler range
    assert [e["ph"] for e in ob.tracer.events() if e["name"] == "x.observed"] == ["B", "E"]
    assert NULL_TRACER.events() == []


@pytest.mark.parametrize("under", ["profiler", "observe"])
def test_a_forced_collection_is_one_span(under):
    def body():
        with span("x.around"):
            gc.collect()

    if under == "profiler":
        prof = _profiled(body)
        (outer,) = _named(prof, "x.around")
        inside = [e for e in _named(prof, "gc.collect")
                  if outer.time_range.start <= e.time_range.start
                  and e.time_range.end <= outer.time_range.end]
        assert len(inside) == 1
    else:
        with observe() as ob:
            body()
        evs = ob.tracer.events()
        b, e = (x["ts"] for x in evs if x["name"] == "x.around")
        inside = [x for x in evs if x["name"] == "gc.collect" and b <= x["ts"] <= e]
        assert [(x["ph"], x["args"]["generation"]) for x in inside] == [("X", 2)]
        assert inside[0]["dur"] > 0 and not [x for x in evs if x["name"] == "gc.collect"
                                             and x["ph"] != "X"]


def test_the_tracer_is_on_the_profilers_clock():
    with observe() as ob:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with span("x.clock"):
                torch.ones(8).sum()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    (rng,) = _named(prof, "x.clock")
    (b,) = [e for e in ob.tracer.events() if e["name"] == "x.clock" and e["ph"] == "B"]
    tracer_us = b["ts"] + ob.tracer.origin_ns / 1e3
    profiler_us = start_ns / 1e3 + rng.time_range.start
    assert abs(tracer_us - profiler_us) < 1e3
    doc = json.loads(ob.tracer.to_json())
    assert doc["otherData"] == {"origin_ns": ob.tracer.origin_ns}


def test_a_fresh_tracer_starts_near_zero_on_its_anchor():
    tr = Tracer()
    assert 0 <= tr.now_us() < 1e6 and tr.origin_ns > 1.6e18


def test_a_collection_while_torch_imports_its_profiler_reads_it_as_off(monkeypatch):
    # the module is in sys.modules before its flag is set: a collection
    # then (or a span) must read the profiler as off, not raise
    monkeypatch.setitem(sys.modules, "torch.autograd.profiler",
                        types.ModuleType("torch.autograd.profiler"))
    assert span("x.importing") is _NULL_SPAN
    _COLLECTION_SPANS("start", {"generation": 0})
    _COLLECTION_SPANS("stop", {"generation": 0})
