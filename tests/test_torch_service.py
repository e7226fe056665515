"""The port's what-if service against sequential ``evaluate`` calls and
against the JAX package's service, on the CPU in float64.

Answers are bit-for-bit equal to sequential ``ChunkedEvaluator.evaluate``
calls on each query's rows; the chunk accounting in ``summary()`` equals
the reference service's on the same queries; a per-phase query matches.
"""

import dataclasses
import threading

import numpy as np
import pytest

from repro.core.hadoop import params as j_params
from repro.search import ChunkedEvaluator as JChunkedEvaluator
from repro.search import WhatIfService as JWhatIfService
from repro_torch.core.hadoop import params as t_params
from repro_torch.search import (
    ChunkedEvaluator,
    InvalidGridError,
    WhatIfService,
    space_block,
    space_size,
)

MiB = j_params.MiB
P = j_params.HadoopParams(pNumNodes=8, pNumMappers=64, pNumReducers=16,
                          pSplitSize=128 * MiB)
S = j_params.ProfileStats(sMapSizeSel=0.8, sReduceSizeSel=0.5)
C = j_params.CostFactors()
INVALID = {"pSortMB": 0.25, "pSortFactor": 2.0}
COUNTS = ("queries", "rows", "chunks", "shared_chunks", "rows_padded",
          "exact_rows")


def to_port(obj):
    return getattr(t_params, type(obj).__name__)(**dataclasses.asdict(obj))


@pytest.fixture(scope="module")
def evaluator():
    return ChunkedEvaluator(to_port(P), to_port(S), to_port(C), chunk=64,
                            device="cpu")


def _mixed_queries(rng, n):
    """~1/3 probes, ~1/3 sweeps, ~1/3 small grids."""
    sortmb = np.array([16.0, 25.0, 50.0, 100.0, 200.0, 400.0])
    queries = []
    for i in range(n):
        kind = i % 3
        if kind == 0:
            queries.append({"pSortMB": np.array([rng.choice(sortmb)])})
        elif kind == 1:
            queries.append({
                "pNumReducers": np.array([4.0, 8.0, 16.0, 32.0]),
                "pSortMB": np.full(4, rng.choice(sortmb)),
            })
        else:
            space = {"pSortMB": sortmb[:3].tolist(),
                     "pSortFactor": [5.0, 10.0, 25.0]}
            queries.append(space_block(space, 0, space_size(space)))
    return queries


def _assert_bitwise(result, ref):
    assert result.total_cost.tobytes() == ref.total_cost.tobytes()
    assert sorted(result.outputs) == sorted(ref.outputs)
    for k in ref.outputs:
        assert result.outputs[k].tobytes() == ref.outputs[k].tobytes(), k


def test_mixed_queries_match_sequential_evaluate(evaluator):
    queries = _mixed_queries(np.random.default_rng(0), 24)
    with WhatIfService(evaluator) as svc:
        results = svc.map(queries)
    for q, r in zip(queries, results):
        _assert_bitwise(r, evaluator.evaluate(q))
        assert r.stats.n_rows == len(next(iter(q.values())))
        assert r.stats.latency_s > 0 and r.stats.n_chunks >= 1


def test_threaded_submission_matches_sequential(evaluator):
    queries = _mixed_queries(np.random.default_rng(1), 12)
    results = [None] * len(queries)

    def submit(i):
        results[i] = svc.submit(queries[i]).result(timeout=120)

    with WhatIfService(evaluator, window_s=0.01) as svc:
        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(len(queries))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    for q, r in zip(queries, results):
        _assert_bitwise(r, evaluator.evaluate(q))


def test_summary_counts_equal_reference_service(evaluator):
    queries = _mixed_queries(np.random.default_rng(2), 30)
    queries.append(INVALID)
    with WhatIfService(evaluator) as svc:
        got = svc.map(queries, exact_fallback=True)
    jev = JChunkedEvaluator(P, S, C, chunk=64)
    with JWhatIfService(jev) as jsvc:
        want = jsvc.map(queries, exact_fallback=True)
    s, js = svc.summary(), jsvc.summary()
    assert {k: s[k] for k in COUNTS} == {k: js[k] for k in COUNTS}
    assert s["shared_chunks"] > 0 and s["chunks"] < len(queries)
    for r, jr in zip(got, want):
        np.testing.assert_allclose(r.total_cost, jr.total_cost, rtol=1e-12)
        np.testing.assert_array_equal(r.exact, jr.exact)
        assert (r.stats.n_chunks, r.stats.n_shared_chunks, r.stats.n_exact) == (
            jr.stats.n_chunks, jr.stats.n_shared_chunks, jr.stats.n_exact)


def test_job_tuning_queries_match_sequential_and_reference(evaluator):
    # the four query kinds of the job-tuning loop: two probes, a sweep, a grid
    best = {"pSortMB": 100.0, "pSortFactor": 10.0, "pNumReducers": 8.0,
            "pUseCombine": 1.0}
    space = {"pSortMB": [25.0, 50.0, 100.0, 200.0, 400.0],
             "pSortFactor": [5.0, 10.0, 25.0, 50.0]}

    def ask(svc):
        return [
            svc.probe({**best, "pUseCombine": 0.0}),
            svc.probe({**best, "pNumReducers": 2 * best["pNumReducers"]}),
            svc.sweep("pNumReducers", [1.0, 2.0, 4.0, 8.0, 16.0],
                      base={k: v for k, v in best.items() if k != "pNumReducers"}),
            svc.grid(space),
        ]

    with WhatIfService(evaluator) as svc:
        got = [f.result(timeout=120) for f in ask(svc)]
    with JWhatIfService(JChunkedEvaluator(P, S, C, chunk=64)) as jsvc:
        want = [f.result(timeout=120) for f in ask(jsvc)]
    for r, jr in zip(got, want):
        _assert_bitwise(r, evaluator.evaluate(r.overrides))
        assert r.best()[0] == jr.best()[0]
        assert r.best()[2] == jr.best()[2]
        np.testing.assert_allclose(r.total_cost, jr.total_cost, rtol=1e-12)


def test_phase_query_matches_reference(evaluator):
    space = {"pSortMB": [25.0, 50.0, 100.0, 200.0],
             "pNumReducers": [4.0, 8.0, 16.0, 32.0]}
    cols = space_block(space, 0, space_size(space))
    with WhatIfService(evaluator) as svc:
        r = svc.phase_query(cols, phase="shuffle", total_max=2.0e3).result(60)
    with JWhatIfService(JChunkedEvaluator(P, S, C, chunk=64)) as jsvc:
        jr = jsvc.phase_query(cols, phase="shuffle", total_max=2.0e3).result(60)
    np.testing.assert_allclose(r.objective, np.asarray(jr.objective), rtol=1e-12)
    np.testing.assert_array_equal(r.feasible, jr.feasible)
    assert r.best()[0] == jr.best()[0] and r.best()[2] == jr.best()[2]
    with WhatIfService(evaluator) as svc, pytest.raises(KeyError):
        svc.phase_query(cols, phase="nope")


def test_invalid_probe_exact_fallback_and_best_raises(evaluator):
    with WhatIfService(evaluator) as svc:
        hatch = svc.probe(INVALID).result(60)
        plain = svc.submit(INVALID).result(60)
    assert hatch.exact.all() and np.isfinite(hatch.total_cost).all()
    assert hatch.total_cost[0] == evaluator.exact_cost(INVALID)
    with pytest.raises(InvalidGridError):
        plain.best()
