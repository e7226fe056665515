"""The port's static analyzer (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``), on the CPU.

Held to the reference where the reference's own tests pass here, and to what
each fixture is meant to show where they do not (four reference analyzer
tests fail under the installed jax; ``ROADMAP.md`` queue 3):

* the carried interval domain equals the reference's, operation by
  operation, on a seeded grid of intervals;
* the abstract interpreter over ``make_fx`` graphs: unguarded division fires
  ``div0``, the double-``where`` guard suppresses it, the straight-through
  custom operators are exempt in grad mode, a bare ``floor`` is not;
* every checker fires on its fixture; the registered models are clean
  against the port's empty baseline, with no coverage gaps;
* the reversion gate: a single-``where`` ``_masked_div`` re-fires ``div0``;
* the launch-geometry checker, the kernels' canonical launches, and the
  ``fixture_copy`` counterpart of ``_bad_pallas_probe`` against the Pallas
  kernel in interpret mode;
* the CLI in a subprocess where ``import jax`` fails.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import repro.analysis as j_an
from repro.analysis import interval as j_iv
from repro.analysis.absint import analyze_jaxpr
from repro.core.hadoop import merge_math as j_mm
from repro_torch import analysis as t_an
from repro_torch.analysis import interval as t_iv
from repro_torch.analysis.interval import Interval as Interval_t
from repro_torch.analysis.absint import analyze_graph, trace
from repro_torch.analysis.checkers import launch_geometry as lg
from repro_torch.analysis.fixtures import (bad_launch_probes, confirm_unwritten,
                                           selftest)
from repro_torch.core.hadoop import merge_math as t_mm
from repro_torch.kernels import fixture_copy
from repro_torch.kernels._build import LaunchSpec

ROOT = Path(__file__).resolve().parents[1]
INF = math.inf

# ---------------------------------------------------------------------------
# the interval domain, pinned to the reference's
# ---------------------------------------------------------------------------


def _grid(seed: int, n: int = 40) -> list[tuple]:
    """Seeded (lo, hi, lo_open, hi_open, maybe_nan) tuples: finite, zero and
    infinite endpoints, open and closed."""
    rng = np.random.default_rng(seed)
    ends = [-INF, -3.0, -1.0, -0.5, 0.0, 0.25, 1.0, 2.0, 7.5, INF]
    out = [(0.0, INF, False, True, False), (0.0, INF, False, False, False),
           (-INF, INF, True, True, False), (0.0, 0.0, False, False, False),
           (INF, INF, False, False, False), (1.0, 2.0, False, False, True)]
    while len(out) < n:
        lo, hi = sorted(rng.choice(ends, 2))
        out.append((float(lo), float(hi), bool(rng.integers(2)),
                    bool(rng.integers(2)), bool(rng.random() < 0.1)))
    return out


def _same(a, b) -> bool:
    if isinstance(a, (t_iv.Interval, j_iv.Interval)):
        a = (a.lo, a.hi, a.lo_open, a.hi_open, a.maybe_nan)
        b = (b.lo, b.hi, b.lo_open, b.hi_open, b.maybe_nan)
    return repr(a) == repr(b)


_UNARY = {
    "neg": lambda i: i.neg(),
    "abs": lambda i: i.abs_(),
    "str": str,
    "attains": lambda i: (i.attains_zero, i.attains_pinf, i.attains_ninf,
                          i.attains_inf, i.is_nonneg, i.contains_negative(),
                          i.attains(1.0)),
    "reciprocal": lambda i: i._reciprocal() if not i.attains_zero else None,
    "exp": lambda i: i.monotone(math.exp),
    "log": lambda i: i.monotone(math.log, nan_below=0.0, nan_at=0.0),
    "sqrt": lambda i: i.monotone(math.sqrt, nan_below=0.0),
    "floor": lambda i: i.round_like("floor"),
    "ceil": lambda i: i.round_like("ceil"),
    "round": lambda i: i.round_like("round"),
    "trunc": lambda i: i.round_like("trunc"),
    "scale_by_count": lambda i: i.scale_by_count(7),
}
_BINARY = {
    "add": lambda a, b: a.add(b),
    "sub": lambda a, b: a.sub(b),
    "mul": lambda a, b: a.mul(b),
    "div": lambda a, b: a.div(b),
    "min": lambda a, b: a.min_(b),
    "max": lambda a, b: a.max_(b),
    "hull": lambda a, b: a.hull(b),
    "intersect": lambda a, b: a.intersect(b),
    "widen_against": lambda a, b: a.widen_against(b),
    "eq": lambda a, b: a == b,
}


def _apply(fn, *ivals):
    try:
        return fn(*ivals)
    except Exception as e:   # the same input must fail the same way on both
        return type(e).__name__


@pytest.mark.parametrize("op", sorted(_UNARY))
def test_interval_unary_equals_reference(op):
    for t in _grid(1) + [(v, v, False, False, False) for v in (-2.5, 0.5, 3.0)]:
        got = _apply(_UNARY[op], t_iv.Interval(*t))
        want = _apply(_UNARY[op], j_iv.Interval(*t))
        assert _same(got, want), (op, t, got, want)


@pytest.mark.parametrize("op", sorted(_BINARY))
def test_interval_binary_equals_reference(op):
    grid = _grid(2, 24)
    for a, b in itertools.product(grid, grid):
        got = _apply(_BINARY[op], t_iv.Interval(*a), t_iv.Interval(*b))
        want = _apply(_BINARY[op], j_iv.Interval(*a), j_iv.Interval(*b))
        assert _same(got, want), (op, a, b, got, want)


def test_interval_constructors_and_constants_equal_reference():
    for v in (0.0, -1.5, INF, -INF, float("nan")):
        assert _same(t_iv.Interval.point(v), j_iv.Interval.point(v))
    for args in ((None, None), (0, None, True), (1.0, 4.0), (None, 0.0)):
        assert _same(t_iv.Interval.bounded(*args), j_iv.Interval.bounded(*args))
    for name in ("TOP", "FINITE_TOP", "NONNEG", "UNIT", "BOOL"):
        assert _same(getattr(t_iv, name), getattr(j_iv, name)), name


# ---------------------------------------------------------------------------
# abstract interpretation over make_fx graphs
# ---------------------------------------------------------------------------

NONNEG = t_iv.Interval(0.0, INF, False, True)


def _events(fn, ivals, *args, grad_mode=False) -> set[str]:
    an = analyze_graph(trace(fn, *args), ivals, grad_mode=grad_mode)
    assert not an.unknown_ops, an.unknown_ops
    return {e.kind for e in an.events}


def test_unguarded_division_fires_div0_as_in_the_reference():
    x = torch.tensor(1.0, dtype=torch.float64)
    got = _events(lambda v: 1.0 / v, [NONNEG], x)
    closed = jax.make_jaxpr(lambda v: 1.0 / v)(jnp.asarray(1.0))
    want = {e.kind for e in analyze_jaxpr(
        closed, [j_iv.Interval(0.0, INF, False, True)]).events}
    assert got == want == {"div0"}


def test_double_where_guard_suppresses_div0():
    def guarded(v):
        ok = v > 0.0
        return torch.where(ok, 1.0 / torch.where(ok, v, 1.0), INF)

    def single(v):
        return torch.where(v > 0.0, 1.0 / v, INF)

    x = torch.tensor(1.0, dtype=torch.float64)
    assert _events(guarded, [NONNEG], x) == set()
    assert _events(single, [NONNEG], x) == {"div0"}


@pytest.mark.parametrize("name", ["floor", "ceil", "round"])
def test_ste_interior_exempt_in_grad_mode_bare_rounding_fires(name):
    x = torch.tensor(4.0, dtype=torch.float64)
    ste = getattr(t_mm, f"ste_{name}")
    bare = getattr(torch, name)
    top = t_iv.FINITE_TOP
    assert _events(lambda v: ste(v) * v, [top], x, grad_mode=True) == set()
    assert _events(lambda v: bare(v) * v, [top], x, grad_mode=True) == {"rounding"}
    assert _events(lambda v: bare(v) * v, [top], x) == set()      # not differentiated
    if name != "floor":
        return
    # the reference agrees on both, with its custom_jvp helper (its own test
    # holds floor; under the installed jax its analyzer misses jnp.round)
    j_ste, j_bare = getattr(j_mm, f"ste_{name}"), getattr(jnp, name)
    for fn, want in ((lambda v: j_ste(v) * v, set()),
                     (lambda v: j_bare(v) * v, {"rounding"})):
        an = analyze_jaxpr(jax.make_jaxpr(fn)(jnp.asarray(4.0)),
                           [j_iv.FINITE_TOP], grad_mode=True)
        assert {e.kind for e in an.events} == want


@pytest.mark.parametrize("fn,kind", [
    (lambda v: v.detach() * v, "stop_gradient"),
    (lambda v: v.to(torch.int64) * 2, "int_cast"),
    (lambda v: torch.div(v, 3.0, rounding_mode="floor") * v, "rounding"),
], ids=["detach", "int_cast", "floor_division"])
def test_other_gradient_blockers_fire_in_grad_mode(fn, kind):
    x = torch.tensor(4.0, dtype=torch.float64)
    assert kind in _events(fn, [t_iv.FINITE_TOP], x, grad_mode=True)


def test_detach_of_a_validity_flag_is_benign():
    x = torch.tensor(4.0, dtype=torch.float64)
    fn = lambda v: (v > 0).to(v.dtype).detach() * v          # noqa: E731
    assert _events(fn, [t_iv.FINITE_TOP], x, grad_mode=True) == set()


@pytest.mark.parametrize("fn,kind", [
    (lambda v: torch.remainder(v, v), "div0"),
    (lambda v: torch.log2(v), "log_domain"),
    (lambda v: torch.sqrt(v - 1.0), "sqrt_domain"),
    (lambda v: torch.rsqrt(v), "div0"),
    (lambda v: torch.pow(v - 1.0, 0.5), "pow_domain"),
    (lambda v: torch.where(v > 1.0, v, INF) - torch.where(v > 2.0, v, INF),
     "inf_minus_inf"),
    (lambda v: torch.where(v > 1.0, v, INF) * (v - 1.0), "zero_times_inf"),
], ids=["remainder", "log2", "sqrt", "rsqrt", "pow", "sub_of_infinities",
        "zero_times_inf"])
def test_hazardous_ops_record_events(fn, kind):
    x = torch.tensor(4.0, dtype=torch.float64)
    assert kind in _events(fn, [NONNEG], x)


def test_events_carry_the_user_source_line():
    def f(v):
        return 1.0 / v

    an = analyze_graph(trace(f, torch.tensor(1.0)), [NONNEG])
    (e,) = an.events
    assert e.location.startswith("tests/test_torch_analysis.py:")
    assert e.location.endswith(" in f")


def test_unknown_op_is_a_coverage_gap():
    an = analyze_graph(trace(lambda v: torch.special.i0(v), torch.tensor(1.0)),
                       [NONNEG])
    assert an.unknown_ops == {"aten.i0.default"}
    assert an.out_vals[0].ival == t_iv.FINITE_TOP


# ---------------------------------------------------------------------------
# the straight-through custom operators
# ---------------------------------------------------------------------------


class _OldSte(torch.autograd.Function):
    """The autograd.Function the custom operators replaced."""

    @staticmethod
    def forward(ctx, x, name):
        ctx.save_for_backward(x)
        return getattr(torch, name)(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(torch.isfinite(x), g, torch.zeros_like(g)), None


STE_NAMES = ["floor", "ceil", "round"]
XS = [0.0, -0.0, 0.5, -0.5, 1.5, -1.5, 2.5, 1.0 + 2 ** -52, -3.75, 1e15 + 0.4999,
      7e12, INF, -INF, float("nan")]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", STE_NAMES)
def test_ste_custom_op_forward_bit_for_bit_and_backward_as_before(name, dtype):
    ste = getattr(t_mm, f"ste_{name}")
    x = torch.tensor(XS, dtype=dtype, requires_grad=True)
    x_old = x.detach().clone().requires_grad_(True)
    y, y_old = ste(x), _OldSte.apply(x_old, name)
    assert y.detach().numpy().tobytes() == getattr(torch, name)(x.detach()).numpy().tobytes()
    assert y.detach().numpy().tobytes() == y_old.detach().numpy().tobytes()
    g = torch.arange(1.0, len(XS) + 1, dtype=dtype)
    (grad,) = torch.autograd.grad(y, x, grad_outputs=g)
    (grad_old,) = torch.autograd.grad(y_old, x_old, grad_outputs=g)
    assert torch.equal(grad, grad_old)


@pytest.mark.parametrize("name", STE_NAMES)
def test_ste_custom_op_is_one_node_of_its_name_in_a_trace(name):
    ste = getattr(t_mm, f"ste_{name}")
    gm = trace(lambda v: ste(v) * 2.0, torch.tensor([1.5, -2.5]))
    targets = [str(n.target) for n in gm.graph.nodes if n.op == "call_function"]
    assert f"repro_torch.ste_{name}.default" in targets
    assert name not in {t.split(".")[1] for t in targets}


# ---------------------------------------------------------------------------
# checkers: fixtures fire, registered models stay clean
# ---------------------------------------------------------------------------


def test_every_checker_fires_on_its_fixture_as_in_the_reference():
    results = selftest("cpu")
    assert list(results) == t_an.checker_names() == [
        "nan-hazard", "grad-blocker", "recompile-hazard", "mask-contract",
        "launch-geometry"]
    for name, findings in results.items():
        assert findings, f"checker {name} no longer fires on its fixture"
    from repro.analysis.fixtures import selftest as j_selftest

    ref = j_selftest()
    ref_names = [("pallas-kernel" if n == "launch-geometry" else n)
                 for n in results]
    assert sorted(ref) == sorted(ref_names)
    assert all(ref[n] for n in ref_names)


def test_fixture_finding_kinds():
    kinds = {n: {f.kind for f in fs} for n, fs in selftest("cpu").items()}
    assert kinds["nan-hazard"] == {"div0"}
    assert kinds["grad-blocker"] == {"rounding"}
    assert kinds["recompile-hazard"] == {"scalar_input", "trace_error"}
    assert kinds["mask-contract"] == {"unmasked_total"}
    assert kinds["launch-geometry"] == {"coverage", "block_threads"}


def test_trace_stability_probe_sees_a_shape_dependent_body():
    from repro_torch.analysis.checkers.recompile import probe_trace_stability

    def body(x):
        return x * 2.0 if x.shape[0] > 4 else x + 1.0

    def typed(x):
        return x * 2.0

    kw = dict(target_name="t", location="here")
    (f,) = probe_trace_stability(body, (torch.ones(3),), (torch.ones(7),), **kw)
    assert f.kind == "retrace"
    (f,) = probe_trace_stability(typed, (torch.ones(3),), (torch.ones(7),), **kw)
    assert f.kind == "signature_drift"
    assert probe_trace_stability(typed, (torch.ones(7),), (torch.zeros(7),),
                                 **kw) == []


@pytest.fixture(scope="module")
def full_report():
    return t_an.run_all(device="cpu")


def test_registered_models_clean_against_the_port_baseline(full_report):
    baseline = t_an.load_baseline(str(ROOT / t_an.DEFAULT_BASELINE))
    assert t_an.DEFAULT_BASELINE == "analysis_baseline_torch.json"
    assert baseline == set()
    new = full_report.new_findings(baseline)
    assert not new, "\n".join(
        f"{f.checker}/{f.kind} {f.target} {f.location}: {f.message}" for f in new)
    assert full_report.checkers_run == t_an.checker_names()


def test_no_coverage_gaps_on_the_traced_models(full_report):
    assert not full_report.coverage_gaps


def test_report_covers_the_reference_targets_and_says_why_it_skips(full_report):
    names = [t.name for t in t_an.iter_targets()]
    assert names == [t.name for t in j_an.iter_targets()]
    traced = {"hadoop-model", "hadoop-grad", "calib-loss", "tuner-objective",
              "network-model", "cloud-pricing", "cluster-rollout",
              "cloud-rollout"}
    assert set(full_report.skipped) == set(names) - traced == {"tpu-model"}
    # calibration's loss, gradient search's relaxed cost, the topology hook's
    # bandwidth and the spot-pricing path trace, in grad mode, with no
    # finding and no coverage gap
    by_name = {t.name: t for t in t_an.iter_targets()}
    for name in ("calib-loss", "tuner-objective", "network-model",
                 "cloud-pricing"):
        assert by_name[name].traceable and by_name[name].grad_mode
        assert not [f for f in full_report.findings if f.target == name], name
        assert name not in full_report.coverage_gaps
    # the step model is a numpy table model with no graph to trace, as in
    # the reference; it is ported, so its reason names no ROADMAP item
    why = full_report.skipped["tpu-model"]
    assert "numpy" in why and "no graph" in why and "ROADMAP" not in why, why
    # the rollouts trace as loops, grad mode off, walked to their fixpoint
    # with no finding and no coverage gap
    for name in ("cluster-rollout", "cloud-rollout"):
        assert by_name[name].traceable and not by_name[name].grad_mode
        assert not [f for f in full_report.findings if f.target == name], name
        assert name not in full_report.coverage_gaps


def test_hadoop_grad_is_the_model_graph_cut_to_the_total_cost():
    from repro_torch.analysis.targets import trace_target

    model, grad = (trace_target(t, "cpu") for t in t_an.iter_targets()[:2])
    n_model, n_grad = len(model.graph.graph.nodes), len(grad.graph.graph.nodes)
    assert grad.out_names == ("j_totalCost",) and "valid" in model.out_names
    assert n_grad < n_model
    ste = [str(n.target) for n in grad.graph.graph.nodes if "ste_" in str(n.target)]
    assert ste and all(s.startswith("repro_torch.ste_") for s in ste)
    idx = model.out_names.index("j_totalCost")
    args = [a.clone() for a in model.args]
    assert torch.equal(grad.graph(*args)[0], model.graph(*args)[idx])


# ---------------------------------------------------------------------------
# the loop fixpoint (the reference's prim_while / prim_scan)
# ---------------------------------------------------------------------------


def _loop(init, body, finish, *args):
    from repro_torch.analysis.absint import LoopGraphs

    st = init(*args)
    return LoopGraphs(trace(init, *args), trace(body, *args, *st),
                      trace(finish, *args, *st))


def test_a_state_that_grows_every_round_widens_to_an_infinite_bound():
    """x -> x + 1 from x0 >= 0: after the hull rounds the bound still moves,
    so it widens to +inf, and ``1 / (1000 - x)`` in the outputs reaches 0.
    One round alone (x in [0, 2]) reads as clean."""
    from repro_torch.analysis.absint import analyze_loop

    x0 = torch.zeros(3, dtype=torch.float64)
    loop = _loop(lambda x: [x * 1.0], lambda x, st: [st + 1.0],
                 lambda x, st: [1.0 / (1000.0 - st)], x0)
    an = analyze_loop(loop, [Interval_t(0.0, 1.0)])
    (state,) = an.loop_state
    assert state.lo == 0.0 and state.hi == INF
    assert [(e.kind, e.chain) for e in an.events] == [("div0", ("loop:finish",))]
    # without the fixpoint: the outputs of one round
    once = trace(lambda x: 1.0 / (1000.0 - (x * 1.0 + 1.0)), x0)
    assert not analyze_graph(once, [Interval_t(0.0, 1.0)]).events


def test_a_state_that_settles_keeps_its_hull_and_stays_clean():
    """x -> min(x + 1, 2) settles at [0, 2] inside the hull rounds: no
    widening, and ``1 / (1000 - x)`` stays clean."""
    from repro_torch.analysis.absint import MAX_LOOP_ITERS, analyze_loop

    assert MAX_LOOP_ITERS == 3          # the reference's max_while_iters
    x0 = torch.zeros(3, dtype=torch.float64)
    loop = _loop(lambda x: [x * 0.0],
                 lambda x, st: [torch.clamp(st + 1.0, max=2.0)],
                 lambda x, st: [1.0 / (1000.0 - st)], x0)
    an = analyze_loop(loop, [Interval_t(0.0, 1.0)])
    (state,) = an.loop_state
    assert (state.lo, state.hi, state.hi_open) == (0.0, 2.0, False)
    assert not an.events and not an.unknown_ops


def test_decomposed_isfinite_guard_refines_the_where_case():
    """make_fx decomposes isfinite to (x == x) * (|x| != inf); the guard
    still narrows the where case to finite values."""
    def guarded(x):
        y = torch.where(torch.isfinite(x), x, 0.0)
        return y - y

    def unguarded(x):
        return x - x

    x = torch.tensor([1.0, INF], dtype=torch.float64)
    top = Interval_t(-INF, INF)
    assert not analyze_graph(trace(guarded, x), [top]).events
    assert [e.kind for e in analyze_graph(trace(unguarded, x), [top]).events] \
        == ["inf_minus_inf"]


@pytest.mark.parametrize("name", ["cluster-rollout", "cloud-rollout"])
def test_rollout_loop_graphs_compute_the_rollout(name):
    """The three traced graphs, run on tensors, are the rollout: init, the
    round until no row is active, finish equal the host loop's outputs."""
    from repro_torch.analysis.targets import _rollout_columns, trace_target
    from repro_torch.cluster import vector_sim as vs

    t = next(t for t in t_an.iter_targets() if t.name == name)
    tr = trace_target(t, "cpu")
    st = list(tr.graph.init(*tr.args))
    for _ in range(64):
        st = list(tr.graph.body(*tr.args, *st))
    outs = dict(zip(tr.out_names, tr.graph.finish(*tr.args, *st)))
    cols = dict(zip(sorted(_rollout_columns("cpu", name == "cloud-rollout")),
                    tr.args))
    flags = dict(with_fair=True, with_preempt=True, with_capacity=True,
                 with_cloud=name == "cloud-rollout", with_dag=False,
                 with_topo=False)
    want, rounds = vs._rollout(cols, 64, 8, **flags)
    assert rounds < 64 and set(want) == set(outs)
    for k, v in want.items():
        assert torch.equal(outs[k], v), k
    assert tr.n_nodes == sum(len(g.graph.nodes) for g in
                             (tr.graph.init, tr.graph.body, tr.graph.finish))


def test_reverting_masked_div_guard_refires_nan_hazard(monkeypatch):
    import repro_torch.core.hadoop.model as model

    def single_where_div(num, den, ok):     # the unguarded form
        return torch.where(ok, num / den, INF)

    monkeypatch.setattr(model, "_masked_div", single_where_div)
    report = t_an.run_all(checkers=["nan-hazard"], device="cpu")
    hits = [f for f in report.findings
            if f.kind == "div0" and f.target == "hadoop-model"]
    assert hits, "nan-hazard no longer sees the single-where masked division"
    assert all(f.location.endswith("in single_where_div") for f in hits)
    baseline = t_an.load_baseline(str(ROOT / t_an.DEFAULT_BASELINE))
    assert report.new_findings(baseline)


def test_run_all_without_a_device_means_the_card(monkeypatch):
    import repro_torch.compat as compat

    monkeypatch.setattr(compat, "has_cuda", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_an.run_all(checkers=["mask-contract"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        selftest()


def test_analysis_context_without_a_device_means_the_card(monkeypatch):
    import repro_torch.compat as compat
    from repro_torch.analysis.checkers import AnalysisContext

    assert AnalysisContext(targets=[], device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(compat, "has_cuda", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AnalysisContext(targets=[])


def test_mask_contract_checks_the_port_sources():
    from repro_torch.analysis.checkers import mask_contract

    files = mask_contract.iter_source_files()
    rel = {os.path.relpath(f, ROOT / "src") for f in files}
    assert "repro_torch/search/evaluator.py" in rel
    assert not any(r.startswith("repro_torch/analysis") for r in rel)


# ---------------------------------------------------------------------------
# launch geometry
# ---------------------------------------------------------------------------


def _spec(grid=(4, 4, 1), block=(256, 1, 1), smem=0):
    return LaunchSpec(grid=grid, block=block, smem_bytes=smem)


def test_validate_launch_accepts_good_geometry():
    assert lg.validate_launch("demo", _spec(), (4, 1000, 1), (1, 300, 1)) == []
    assert lg.validate_launch("demo", _spec(grid=(4, 5, 1)), (4, 1000, 1),
                              (1, 200, 1), guarded=False) == []


@pytest.mark.parametrize("spec,shape,tile,guarded,kind", [
    (_spec(grid=(4, 3, 1)), (4, 1000, 1), (1, 300, 1), True, "coverage"),
    (_spec(grid=(2, 4, 1)), (4, 1000, 1), (1, 300, 1), True, "coverage"),
    (_spec(), (4, 1000, 1), (1, 300, 1), False, "overrun"),
    (_spec(block=(300, 1, 1)), (4, 1000, 1), (1, 300, 1), True, "block_threads"),
    (_spec(block=(32, 33, 1)), (4, 1000, 1), (1, 300, 1), True, "block_threads"),
    (_spec(grid=(1, 70_000, 1)), (1, 70_000, 1), (1, 1, 1), True, "grid_limit"),
    (_spec(grid=(0, 4, 1)), (0, 1000, 1), (1, 300, 1), True, "grid_limit"),
    (_spec(smem=232_449), (4, 1000, 1), (1, 300, 1), True, "smem_limit"),
], ids=["coverage_y", "coverage_x", "overrun", "threads_not_warps",
        "threads_over_1024", "grid_y", "grid_empty", "smem"])
def test_validate_launch_rejects_each_bad_kind(spec, shape, tile, guarded, kind):
    kinds = [f.kind for f in lg.validate_launch("demo", spec, shape, tile,
                                                guarded=guarded)]
    assert kinds == [kind]


@pytest.mark.parametrize("hd", lg.HEAD_DIMS)
def test_attention_kernels_canonical_launches_are_clean(hd):
    probes = (lg.KERNEL_PROBES["flash_attention"](hds=(hd,))
              + lg.KERNEL_PROBES["decode_attention"](hds=(hd,)))
    assert len(probes) == 9        # flash: 3 shapes x 2 kernels; decode: 3
    assert lg.probe_kernels(probes) == []


def test_seg_combine_and_fixture_copy_canonical_launches_are_clean():
    probes = (lg.KERNEL_PROBES["seg_combine"]()
              + lg.KERNEL_PROBES["fixture_copy"]())
    assert lg.probe_kernels(probes) == []
    assert {p.kernel for p in probes} == {"seg_combine", "fixture_copy"}


def test_recorded_geometries_are_checked_except_the_fixtures_own(monkeypatch):
    from repro_torch.kernels import ops
    from repro_torch.kernels.seg_combine import coverage, launch_spec

    coverage_probe = bad_launch_probes()[0]
    # one CTA covers 2,048 rows of a D == 1 call: a grid of 3 leaves 3,904
    short = LaunchSpec(grid=(3, 1, 1), block=(256, 1, 1), smem_bytes=0)
    monkeypatch.setattr(ops.seg_combine, "geometries", {
        (launch_spec(10_048, 1, 50_000), *coverage(10_048, 1, 50_000)),
        (short, *coverage(10_048, 1, 50_000))})
    monkeypatch.setattr(ops.fixture_copy, "geometries", {
        (coverage_probe.spec, coverage_probe.shape, coverage_probe.tile)})
    assert len(lg.recorded()) == 3
    (f,) = lg.check_recorded()
    assert (f.kind, f.target) == ("coverage", "seg_combine")
    assert "[6144:10048, :, :]" in f.message


def test_coverage_finding_names_columns_900_to_999():
    coverage, threads = bad_launch_probes()
    (f,) = lg.probe_kernels([coverage])
    assert f.kind == "coverage" and f.target == "fixture_copy"
    assert "[:, 900:1000, :]" in f.message
    assert lg.unwritten(coverage.spec, coverage.shape, coverage.tile) == [(1, 900, 1000)]
    assert [f.kind for f in lg.probe_kernels([threads])] == ["block_threads"]
    # the plain version runs the geometry: exactly those 400 stay NaN
    assert confirm_unwritten(coverage, "cpu") == 400


def test_reference_flags_its_fixture_and_the_port_its_counterpart():
    from repro.analysis.checkers import pallas_kernel
    from repro.analysis.fixtures import bad_pallas_probes

    ref = {f.kind for f in pallas_kernel.probe_kernels(bad_pallas_probes())}
    assert {"block_divisibility", "index_map_arity"} <= ref
    port = {f.kind for f in lg.probe_kernels(bad_launch_probes())}
    assert port == {"coverage", "block_threads"}


def _pallas_copy(x: np.ndarray, grid) -> np.ndarray:
    """The reference fixture's kernel body, ``o_ref[...] = x_ref[...]`` in
    (1, 300) blocks, with a 2-ary out index map, in interpret mode."""
    def kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...]

    spec = pl.BlockSpec((1, 300), lambda i, j: (i, j))
    return np.asarray(pl.pallas_call(
        kernel, grid=grid, in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)(jnp.asarray(x)))


@pytest.mark.parametrize("grid", [(4, 4), (4, 3)], ids=["ceil", "floor"])
def test_fixture_copy_plain_matches_the_pallas_kernel_in_interpret_mode(grid):
    x = np.random.default_rng(0).standard_normal((4, 1000)).astype(np.float32)
    want = _pallas_copy(x, grid)
    got = fixture_copy(torch.from_numpy(x), (1, 300), grid=grid).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    assert np.isnan(got).sum() == (400 if grid == (4, 3) else 0)


# ---------------------------------------------------------------------------
# the CLI, with jax blocked
# ---------------------------------------------------------------------------


def _cli(*argv: str) -> subprocess.CompletedProcess:
    code = ("import runpy, sys; sys.modules['jax'] = None; "
            f"sys.argv = ['repro_torch.analysis', *{list(argv)!r}]; "
            "runpy.run_module('repro_torch.analysis', run_name='__main__')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=str(ROOT), env=env, timeout=300)


def test_cli_smoke_subprocess_without_jax():
    proc = _cli("--smoke", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "all checkers fire" in proc.stdout
    assert "launch-geometry" in proc.stdout


def test_cli_json_report_without_jax():
    proc = _cli("--json", "--device", "cpu", "--checker", "launch-geometry",
                "--checker", "mask-contract")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["checkers_run"] == ["mask-contract", "launch-geometry"]
    assert payload["findings"] == [] and payload["new_findings"] == []
    want = set(j_an.Report().to_dict()) | {"new_findings", "stale_baseline",
                                           "baseline"}
    assert set(payload) == want
    assert payload["baseline"].endswith("analysis_baseline_torch.json")


def test_cli_exits_1_on_a_new_finding(tmp_path, monkeypatch):
    from repro_torch.analysis import __main__ as cli
    from repro_torch.analysis.findings import Finding, Report

    bad = Finding(checker="nan-hazard", target="demo", kind="div0",
                  message="m", location="a/b.py:3 in fn")
    monkeypatch.setattr(cli, "run_all", lambda **kw: Report(findings=[bad]))
    path = tmp_path / "baseline.json"
    assert cli.main(["--baseline", str(path)]) == 1
    assert cli.main(["--baseline", str(path), "--update-baseline"]) == 0
    assert cli.main(["--baseline", str(path)]) == 0
    assert t_an.load_baseline(str(path)) == {bad.fingerprint()}
