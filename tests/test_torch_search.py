"""The port's search layer against the JAX package's, on the CPU in float64.

Contracts: chunked equals unchunked bit for bit; ``evaluate`` equals the
reference ``ChunkedEvaluator`` at rtol 1e-12 (``tests/test_search.py``);
the streamed top-k has the reference's set and order, ties included; the
strategies pick the same assignment after the same number of evaluations;
the exact-simulator escape hatch gives the same seconds.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.hadoop import params as j_params
from repro.search import ChunkedEvaluator as JChunkedEvaluator
from repro.search import coordinate_descent_ev as j_coordinate_descent_ev
from repro.search import grid_search_ev as j_grid_search_ev
from repro.search import random_search_ev as j_random_search_ev
from repro.search import search_topk as j_search_topk
from repro_torch.compat import has_cuda
from repro_torch.core.hadoop import params as t_params
from repro_torch.search import (
    ChunkedEvaluator,
    InvalidGridError,
    coordinate_descent_ev,
    evaluate_unchunked,
    grid_search_ev,
    random_search_ev,
    search_topk,
    space_block,
    space_size,
)

MiB = j_params.MiB
P = j_params.HadoopParams(pNumNodes=8, pNumMappers=64, pNumReducers=16,
                          pSplitSize=128 * MiB)
S = j_params.ProfileStats(sMapSizeSel=0.8, sReduceSizeSel=0.5)
C = j_params.CostFactors()

SPACE = {
    "pSortMB": [25.0, 50.0, 100.0, 200.0, 400.0],
    "pSortFactor": [5.0, 10.0, 25.0, 50.0],
    "pNumReducers": [4.0, 8.0, 16.0, 32.0, 64.0],
    "pIsIntermCompressed": [0.0, 1.0],
}
# exact ties: a repeated pSortMB value, and a combiner that costs nothing
# and reduces nothing (sCombine*Sel = 1, cCombineCPUCost = 0)
TIE_STATS = j_params.ProfileStats(sMapSizeSel=0.8, sReduceSizeSel=0.5)
TIE_COSTS = j_params.CostFactors(cCombineCPUCost=0.0)
TIE_SPACE = {
    "pSortMB": [50.0, 100.0, 100.0, 200.0],
    "pSortFactor": [10.0, 25.0],
    "pNumReducers": [8.0, 16.0, 32.0],
    "pUseCombine": [0.0, 1.0],
}
# numSpills >> pSortFactor**2 everywhere -> closed-form merge math invalid
INVALID_SPACE = {"pSortMB": [0.25, 0.5], "pSortFactor": [2.0, 3.0]}


def to_port(obj):
    return getattr(t_params, type(obj).__name__)(**dataclasses.asdict(obj))


def port_ev(p=P, s=S, c=C, **kw):
    return ChunkedEvaluator(to_port(p), to_port(s), to_port(c), device="cpu", **kw)


def full_grid(space):
    return space_block(space, 0, space_size(space))


@pytest.mark.parametrize("chunk", [7, 64, 1 << 13])
def test_chunked_matches_unchunked_bit_for_bit(chunk):
    ev = port_ev(chunk=chunk)
    cols = full_grid(SPACE)
    got = ev.evaluate(cols)
    ref = evaluate_unchunked(ev.base_cfg, cols)
    assert sorted(got.outputs) == sorted(ref)
    for k, v in ref.items():
        assert got.outputs[k].tobytes() == v.tobytes(), (chunk, k)
    assert got.total_cost.tobytes() == np.where(
        ref["valid"] > 0, ref["j_totalCost"], np.inf).tobytes()


def test_padding_changes_nothing_around_the_chunk_boundary():
    ev = port_ev(chunk=16)
    vals = np.random.default_rng(3).choice([25.0, 50.0, 100.0, 200.0], 64)
    full = ev.evaluate({"pSortMB": vals}).outputs["j_totalCost"]
    for n in (1, 15, 16, 17, 33):
        res = ev.evaluate({"pSortMB": vals[:n]})
        assert res.outputs["j_totalCost"].tobytes() == full[:n].tobytes()


@pytest.mark.parametrize("chunk", [64, 1 << 13])
def test_evaluate_matches_reference_evaluator(chunk):
    cols = full_grid(SPACE)
    got = port_ev(chunk=chunk).evaluate(cols)
    want = JChunkedEvaluator(P, S, C, chunk=chunk).evaluate(cols)
    assert sorted(got.outputs) == sorted(want.outputs)
    for k in want.outputs:
        np.testing.assert_allclose(got.outputs[k], want.outputs[k],
                                   rtol=1e-12, atol=0, err_msg=k)
    np.testing.assert_array_equal(np.isfinite(got.total_cost),
                                  np.isfinite(want.total_cost))


def test_report_matches_reference_report():
    cols = full_grid({"pSortMB": SPACE["pSortMB"], "pNumReducers": [0.0, 8.0]})
    got = port_ev(chunk=8).report(cols)
    want = JChunkedEvaluator(P, S, C, chunk=8).report(cols)
    for name in got.phases.names():
        np.testing.assert_allclose(np.asarray(got.phases[name]),
                                   np.asarray(want.phases[name]), rtol=1e-12)
    for f in ("total_cost", "valid", "shuffle_valid", "sort_valid"):
        np.testing.assert_allclose(np.asarray(getattr(got, f)),
                                   np.asarray(getattr(want, f)), rtol=1e-12)


def _entries(res):
    return [(e.index, e.assignment, e.valid, e.exact) for e in res.entries]


@pytest.mark.parametrize("chunk", [5, 64])
def test_topk_set_and_order_match_reference_with_ties(chunk):
    cols = full_grid(TIE_SPACE)
    costs = port_ev(P, TIE_STATS, TIE_COSTS,
                    chunk=1 << 13).evaluate(cols).total_cost
    # the space really has exact ties among its best ten
    assert len(np.unique(np.sort(costs)[:10])) < 10
    got = search_topk(port_ev(P, TIE_STATS, TIE_COSTS, chunk=chunk),
                      TIE_SPACE, k=10)
    want = j_search_topk(JChunkedEvaluator(P, TIE_STATS, TIE_COSTS, chunk=chunk),
                         TIE_SPACE, k=10)
    assert _entries(got) == _entries(want)
    np.testing.assert_allclose([e.cost for e in got.entries],
                               [e.cost for e in want.entries], rtol=1e-12)
    assert (got.n_evaluated, got.n_valid) == (want.n_evaluated, want.n_valid)


def test_grid_search_matches_reference():
    got = grid_search_ev(port_ev(chunk=64), SPACE)
    want = j_grid_search_ev(JChunkedEvaluator(P, S, C, chunk=64), SPACE)
    assert got.best_assignment == want.best_assignment
    assert got.evaluations == want.evaluations
    assert got.best_cost == pytest.approx(want.best_cost, rel=1e-12)


def test_coordinate_descent_matches_reference():
    got = coordinate_descent_ev(port_ev(chunk=64), SPACE)
    want = j_coordinate_descent_ev(JChunkedEvaluator(P, S, C, chunk=64), SPACE)
    assert got.best_assignment == want.best_assignment
    assert got.evaluations == want.evaluations
    assert got.exact == want.exact
    assert [a for a, _ in got.history] == [a for a, _ in want.history]
    assert got.best_cost == pytest.approx(want.best_cost, rel=1e-12)


def test_random_search_matches_reference():
    got = random_search_ev(port_ev(chunk=64), SPACE, samples=300, seed=4)
    want = j_random_search_ev(JChunkedEvaluator(P, S, C, chunk=64), SPACE,
                              samples=300, seed=4)
    assert got.best_assignment == want.best_assignment
    assert got.evaluations == want.evaluations
    assert got.best_cost == pytest.approx(want.best_cost, rel=1e-12)


def test_exact_cost_equal():
    ev, jev = port_ev(chunk=8), JChunkedEvaluator(P, S, C, chunk=8)
    for a in ({"pSortMB": 0.25, "pSortFactor": 2.0},
              {"pSortMB": 100.0, "pNumReducers": 8.0, "pUseCombine": 1.0}):
        assert ev.exact_cost(a) == jev.exact_cost(a)


def test_invalid_grid_routes_through_the_exact_simulator_like_reference():
    ev = port_ev(chunk=8)
    with pytest.raises(InvalidGridError):
        ev.evaluate(full_grid(INVALID_SPACE)).best()
    got = search_topk(ev, INVALID_SPACE, k=2)
    want = j_search_topk(JChunkedEvaluator(P, S, C, chunk=8), INVALID_SPACE, k=2)
    assert _entries(got) == _entries(want)
    assert [e.cost for e in got.entries] == [e.cost for e in want.entries]
    assert got.invalid_reason_counts == want.invalid_reason_counts
    cd = coordinate_descent_ev(ev, INVALID_SPACE)
    jcd = j_coordinate_descent_ev(JChunkedEvaluator(P, S, C, chunk=8),
                                  INVALID_SPACE)
    assert (cd.best_assignment, cd.best_cost, cd.exact) == (
        jcd.best_assignment, jcd.best_cost, jcd.exact)


def test_override_errors_and_scalar_overrides():
    ev = port_ev(chunk=8)
    res = ev.evaluate({"pSortMB": np.array([64.0, 128.0]), "pSortFactor": 25.0})
    ref = ev.evaluate({"pSortMB": np.array([64.0, 128.0]),
                       "pSortFactor": np.array([25.0, 25.0])})
    assert res.total_cost.tobytes() == ref.total_cost.tobytes()
    with pytest.raises(KeyError):
        ev.evaluate({"nope": np.array([1.0])})
    with pytest.raises(ValueError):
        ev.evaluate({"pSortMB": 64.0})
    with pytest.raises(ValueError, match="empty"):
        ev.evaluate({"pSortMB": np.array([])})
    with pytest.raises(ValueError):
        ev.chunk_topk({"pSortMB": np.arange(9.0)}, k=1)


def test_evaluator_device_and_dtype_policy():
    ev = port_ev(chunk=8, dtype=torch.float32)
    assert ev.device == torch.device("cpu")
    assert all(v.dtype == torch.float32 for v in ev.base_cfg.values())
    if not has_cuda():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ChunkedEvaluator(to_port(P), to_port(S), to_port(C))


def test_instrumented_evaluator_is_bit_identical_and_counts():
    from repro_torch.obs import observe

    ev = port_ev(chunk=64)
    cols = full_grid(SPACE)
    plain = ev.evaluate(cols)
    with observe() as ob:
        traced = ev.evaluate(cols)
        search_topk(ev, SPACE, k=3)
    assert traced.total_cost.tobytes() == plain.total_cost.tobytes()
    n = space_size(SPACE)
    reg = ob.registry
    assert reg.counter("evaluator.chunks").value == -(-n // 64)
    assert reg.counter("evaluator.topk_blocks").value == -(-n // 64)
    assert reg.counter("evaluator.rows").value == 2 * n
    assert any(e.get("name") == "evaluator.chunk_topk" for e in ob.tracer.events())


# ------------------------------------------- chunks split across devices


@pytest.mark.parametrize("chunk", [8, 30, 1 << 13])
def test_chunks_split_over_four_devices_equal_one_device_bit_for_bit(chunk):
    # 397 rows, not a multiple of 4; chunk 30 rounds up to 32 over 4 devices
    one = port_ev(chunk=chunk)
    four = port_ev(chunk=chunk, devices=["cpu"] * 4)
    assert four.num_devices == 4 and four.chunk % 4 == 0
    cols = {k: v[:397] for k, v in full_grid(SPACE).items()}
    a, b = one.evaluate(cols), four.evaluate(cols)
    for k, v in a.outputs.items():
        assert b.outputs[k].tobytes() == v.tobytes(), k
    assert b.total_cost.tobytes() == a.total_cost.tobytes()
    t1 = search_topk(one, SPACE, k=5)
    t4 = search_topk(four, SPACE, k=5)
    assert [e.index for e in t4.entries] == [e.index for e in t1.entries]
    assert [e.cost for e in t4.entries] == [e.cost for e in t1.entries]
    odd = {"pSortMB": np.array([25.0, 50.0, 100.0, 200.0, 400.0, 75.0, 30.0]),
           "pNumReducers": 16.0}
    x, y = one.chunk_topk(odd, 3), four.chunk_topk(odd, 3)
    assert y.idx.tolist() == x.idx.tolist() and y.costs.tobytes() == x.costs.tobytes()
    assert y.n_valid == x.n_valid and y.reason_counts == x.reason_counts


def test_split_evaluator_keeps_the_reference_contract():
    cols = full_grid(SPACE)
    got = port_ev(chunk=64, devices=["cpu"] * 4).evaluate(cols)
    want = JChunkedEvaluator(P, S, C, chunk=64).evaluate(cols)
    for k in want.outputs:
        np.testing.assert_allclose(got.outputs[k], want.outputs[k],
                                   rtol=1e-12, atol=0, err_msg=k)
    with pytest.raises(ValueError, match="first of devices"):
        port_ev(devices=["meta", "cpu"])


def test_search_devices_and_split_rows():
    from repro_torch.compat import search_devices, split_rows

    assert search_devices(["cpu"] * 3) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="empty"):
        search_devices([])
    if not has_cuda():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            search_devices()
    rows = {"x": torch.arange(10.0), "y": torch.arange(20.0).reshape(10, 2)}
    seen = []

    def fn(block, dev):
        seen.append((block["x"].shape[0], dev))
        return {"s": block["x"] + block["y"].sum(-1), "y": block["y"] * 2}

    out = split_rows(fn, rows, search_devices(["cpu"] * 4))
    assert sorted(n for n, _ in seen) == [3, 3, 3, 3]      # 10 padded to 12
    np.testing.assert_array_equal(out["s"].numpy(), np.arange(10.0) * 5 + 1)
    np.testing.assert_array_equal(out["y"].numpy(), rows["y"].numpy() * 2)
