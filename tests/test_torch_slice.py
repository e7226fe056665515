"""The job-tuning loop end to end, the port against the JAX package, at a
small size on the CPU: profile on the engine (kernel combine on), fit the
Table-3 factors, tune on the model (coordinate descent, grid search), ask
the what-if service, simulate the tuned job on a cluster.
"""

import dataclasses

import numpy as np
import pytest

from repro.core.hadoop import params as j_params
from repro.core.hadoop import simulator as j_sim
from repro.mapreduce import JOBS as J_JOBS
from repro.mapreduce import MapReduceEngine as JEngine
from repro.mapreduce import make_input as j_make_input
from repro.mapreduce import profiler as j_profiler
from repro.search import ChunkedEvaluator as JChunkedEvaluator
from repro.search import WhatIfService as JWhatIfService
from repro.search import coordinate_descent_ev as j_coordinate_descent_ev
from repro.search import grid_search_ev as j_grid_search_ev
from repro_torch.core.hadoop import params as t_params
from repro_torch.core.hadoop.simulator import SimConfig, simulate_job
from repro_torch.mapreduce import JOBS, MapReduceEngine
from repro_torch.mapreduce import profiler as t_profiler
from repro_torch.search import (
    ChunkedEvaluator,
    WhatIfService,
    coordinate_descent_ev,
    grid_search_ev,
)

MiB = j_params.MiB
N = 24_000
SPACE = {
    "pSortMB": [0.25, 0.5, 1.0, 2.0, 4.0],
    "pSortFactor": [3, 5, 10, 20],
    "pNumReducers": [1, 2, 4, 8, 16],
    "pUseCombine": [0.0, 1.0],
}


def to_port(obj):
    return getattr(t_params, type(obj).__name__)(**dataclasses.asdict(obj))


def _strip_times(jc) -> dict:
    d = dataclasses.asdict(jc)
    for side in ("maps", "reduces"):
        for c in d[side]:
            c.pop("times")
    d.pop("output")
    return d


@pytest.fixture(scope="module")
def loop():
    job = J_JOBS["wordcount"]
    default = j_params.HadoopParams(
        pNumMappers=4, pNumReducers=2, pUseCombine=True, pSortMB=0.25,
        pSortFactor=3, pSplitSize=N / 4 * job.pair_width, pTaskMem=8 * MiB)
    probes = [default, default.replace(pSortMB=1.0),
              default.replace(pNumReducers=8, pSortFactor=8)]
    keys, values = j_make_input(job, N, seed=1)
    t_runs, j_runs = [], []
    for hp in probes:
        jr = j_profiler.run_measured(job, hp, N, seed=1)
        tr = t_profiler.run_measured(JOBS["wordcount"], to_port(hp), N, seed=1,
                                     use_kernel_combine=True, device="cpu")
        # identical observations for both fits: the reference's wall times
        t_runs.append(dataclasses.replace(tr, wall_s=jr.wall_s,
                                          phase_times=dict(jr.phase_times)))
        j_runs.append(jr)
    return dict(job=job, default=default, keys=keys, values=values,
                t_runs=t_runs, j_runs=j_runs)


def test_1_engine_with_kernel_combine_matches_reference_engine(loop):
    hp = loop["default"]
    jc = JEngine(hp, loop["job"]).run_job(loop["keys"], loop["values"])
    tc = MapReduceEngine(to_port(hp), JOBS["wordcount"], use_kernel_combine=True,
                         device="cpu").run_job(loop["keys"], loop["values"])
    assert _strip_times(tc) == _strip_times(jc)
    np.testing.assert_array_equal(tc.output[0], jc.output[0])
    np.testing.assert_allclose(tc.output[1], jc.output[1], rtol=1e-5)
    for tr, jr in zip(loop["t_runs"], loop["j_runs"]):
        assert _strip_times(tr.counters) == _strip_times(jr.counters)
        assert dataclasses.asdict(tr.stats) == dataclasses.asdict(jr.stats)


@pytest.fixture(scope="module")
def fitted(loop):
    t_costs = t_profiler.fit_cost_factors(loop["t_runs"])
    j_costs = j_profiler.fit_cost_factors(loop["j_runs"])
    for f, want in dataclasses.asdict(j_costs).items():
        assert getattr(t_costs, f) == pytest.approx(want, rel=1e-12, abs=0), f
    # from here on both sides get the same (stats, costs)
    stats = loop["j_runs"][0].stats
    ev = ChunkedEvaluator(to_port(loop["default"]), to_port(stats),
                          to_port(j_costs), chunk=1 << 10, device="cpu")
    jev = JChunkedEvaluator(loop["default"], stats, j_costs, chunk=1 << 10)
    return dict(stats=stats, costs=j_costs, ev=ev, jev=jev)


def test_2_tuning_matches_reference(fitted):
    got = coordinate_descent_ev(fitted["ev"], SPACE)
    want = j_coordinate_descent_ev(fitted["jev"], SPACE)
    assert got.best_assignment == want.best_assignment
    assert got.evaluations == want.evaluations
    assert got.best_cost == pytest.approx(want.best_cost, rel=1e-9)
    g_grid = grid_search_ev(fitted["ev"], SPACE)
    j_grid = j_grid_search_ev(fitted["jev"], SPACE)
    assert g_grid.best_assignment == j_grid.best_assignment
    assert g_grid.evaluations == j_grid.evaluations
    assert g_grid.best_cost == pytest.approx(j_grid.best_cost, rel=1e-9)


def test_3_service_answers_match_reference(fitted):
    best = coordinate_descent_ev(fitted["ev"], SPACE).best_assignment

    def ask(svc):
        return [
            svc.probe({**best, "pUseCombine": 0.0}),
            svc.probe({**best, "pNumReducers": 2 * best["pNumReducers"]}),
            svc.sweep("pNumReducers", [1.0, 2.0, 4.0, 8.0, 16.0],
                      base={k: v for k, v in best.items()
                            if k != "pNumReducers"}),
            svc.grid({"pSortMB": SPACE["pSortMB"],
                      "pSortFactor": SPACE["pSortFactor"]}),
        ]

    with WhatIfService(fitted["ev"]) as svc:
        got = [f.result(timeout=120) for f in ask(svc)]
    with JWhatIfService(fitted["jev"]) as jsvc:
        want = [f.result(timeout=120) for f in ask(jsvc)]
    for r, jr in zip(got, want):
        i, cost, a = r.best()
        ji, jcost, ja = jr.best()
        assert (i, a) == (ji, ja)
        assert cost == pytest.approx(jcost, rel=1e-9)
        seq = fitted["ev"].evaluate(r.overrides)
        assert r.total_cost.tobytes() == seq.total_cost.tobytes()
    assert ({k: svc.summary()[k] for k in ("chunks", "shared_chunks")}
            == {k: jsvc.summary()[k] for k in ("chunks", "shared_chunks")})


def test_4_simulated_makespan_matches_reference(loop, fitted):
    best = coordinate_descent_ev(fitted["ev"], SPACE)
    hp = best.apply(to_port(loop["default"])).replace(
        pNumNodes=8, pNumMappers=64, pNumReducers=16)
    j_hp = j_params.HadoopParams(**dataclasses.asdict(hp))
    for kw in (dict(seed=7), dict(seed=7, straggler_prob=0.1),
               dict(seed=7, node_failures=((0.3, 3),))):
        got = simulate_job(hp, to_port(fitted["stats"]), to_port(fitted["costs"]),
                           SimConfig(**kw))
        want = j_sim.simulate_job(j_hp, fitted["stats"], fitted["costs"],
                                  j_sim.SimConfig(**kw))
        assert got.makespan == want.makespan
        assert got.num_speculative_launched == want.num_speculative_launched
