"""The port's gradient tuning, Hadoop-first wrappers, ``whatif``/``tuner``
aliases and ``api`` facade against the JAX package's, on the CPU in
float64.

Tolerances, each stated where it is used:

* ``gradient_descent_ev``: the same int/bool assignment and the same
  number of evaluations; float axes and cost at rtol 1e-6 (the relaxed
  descent runs through float32 AdamW arithmetic, as in the reference).
* ``build_relaxed_objective``: value and gradient at rtol 1e-9 against
  ``jax.value_and_grad``.
* What goes through the evaluator (wrappers, aliases, ``api.model`` /
  ``sweep`` / ``tune``): the reference's numbers at rtol 1e-12, and the
  port's own direct calls exactly.
"""

import dataclasses
import json
import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as j_api
import repro_torch.api as api
from repro.core import tuner as j_tuner
from repro.core import whatif as j_whatif
from repro.core.hadoop import params as j_params
from repro.search import ChunkedEvaluator as JChunkedEvaluator
from repro.search import gradient_descent_ev as j_gradient_descent_ev
from repro.search.strategies import build_relaxed_objective as j_build_relaxed_objective
from repro.spec import JobSpec as JJobSpec
from repro_torch.calib import Observation, calibrate
from repro_torch.compat import has_cuda
from repro_torch.core import tuner, whatif
from repro_torch.core.hadoop import params as t_params
from repro_torch.search import (
    ChunkedEvaluator,
    Evaluator,
    NotDifferentiableError,
    cached_evaluator,
    coordinate_descent,
    coordinate_descent_ev,
    gradient_descent_ev,
    grid_search,
    grid_search_ev,
    random_search,
    random_search_ev,
)
from repro_torch.search.strategies import build_relaxed_objective
from repro_torch.spec import JobSpec

MiB = j_params.MiB
CPU = "cpu"
MANIFEST = Path(__file__).resolve().parents[1] / "src/repro_torch/spec/manifest.json"

# examples/calibrate_and_tune.py's tuning start point and space
N = 120_000
EXAMPLE_P = j_params.HadoopParams(
    pNumMappers=4, pNumReducers=2, pUseCombine=True, pSortMB=0.25,
    pSortFactor=3, pSplitSize=N / 4 * 400, pTaskMem=8 * MiB)
EXAMPLE_S = j_params.ProfileStats(sMapSizeSel=0.8, sReduceSizeSel=0.5)
EXAMPLE_SPACE = {
    "pSortMB": [0.25, 0.5, 1.0, 2.0, 4.0],
    "pSortFactor": [3, 5, 8, 16],
    "pNumReducers": [2, 4, 8],
    "pUseCombine": [0.0, 1.0],
}
# tests/test_calib.py's gradient-search space and evaluator
CALIB_P = j_params.HadoopParams(pNumNodes=8, pNumMappers=64, pSplitSize=128 * MiB)
CALIB_SPACE = {
    "pSortMB": [16.0, 64.0, 256.0],
    "pSortFactor": [5.0, 20.0, 100.0],
    "pNumReducers": [4.0, 16.0, 64.0],
}
# chip_smoke.py's phase-4 space: 7 axes, 120,000 configurations, at
# wordcount's Hadoop defaults with factors of a least-squares fit's size
SMOKE_P = j_params.HadoopParams(pNumMappers=4, pNumReducers=8, pUseCombine=True,
                                pSortMB=100.0, pSplitSize=128 * MiB)
SMOKE_S = j_params.ProfileStats(sMapPairsSel=4.0, sCombinePairsSel=0.0157,
                                sCombineSizeSel=0.0157)
SMOKE_C = j_params.CostFactors(
    cHdfsReadCost=3.7e-14, cMapCPUCost=1.6e-7, cSortCPUCost=4.6e-8,
    cMergeCPUCost=2.25e-7, cReduceCPUCost=2.8e-7, cCombineCPUCost=3e-6,
    cPartitionCPUCost=8.6e-9)
SMOKE_SPACE = {
    "pSortMB": [25.0, 50.0, 75.0, 100.0, 150.0, 200.0, 300.0, 400.0, 600.0, 800.0],
    "pSortFactor": [3, 5, 8, 10, 15, 20, 25, 50, 75, 100],
    "pNumReducers": [1, 2, 4, 8, 12, 16, 24, 32, 48, 64],
    "pUseCombine": [0.0, 1.0],
    "pIsIntermCompressed": [0.0, 1.0],
    "pSpillPerc": [0.5, 0.6, 0.7, 0.8, 0.9, 0.95],
    "pSortRecPerc": [0.02, 0.05, 0.1, 0.15, 0.2],
}
CASES = {
    "example": (EXAMPLE_P, EXAMPLE_S, EXAMPLE_SPACE),
    "calib": (CALIB_P, EXAMPLE_S, CALIB_SPACE),
    "smoke": (SMOKE_P, SMOKE_S, SMOKE_SPACE),
}
_INT_KINDS = ("int", "bool")


def to_port(obj):
    return getattr(t_params, type(obj).__name__)(**dataclasses.asdict(obj))


def _evaluators(p, s, chunk=256):
    c = SMOKE_C if p is SMOKE_P else j_params.CostFactors()
    return (JChunkedEvaluator(p, s, c, chunk=chunk),
            ChunkedEvaluator(to_port(p), to_port(s), to_port(c), chunk=chunk,
                             device=CPU))


def _assert_same_tuning(got, want, space, ev):
    ps = ev.param_space
    assert got.evaluations == want.evaluations
    assert got.best_assignment.keys() == want.best_assignment.keys()
    for k, v in want.best_assignment.items():
        if ps[k].kind in _INT_KINDS:
            assert got.best_assignment[k] == v, k
        else:
            assert got.best_assignment[k] == pytest.approx(v, rel=1e-6), k
    assert got.best_cost == pytest.approx(want.best_cost, rel=1e-6)
    assert got.exact == want.exact


# ------------------------------------------------------- gradient search


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradient_descent_ev_matches_reference(case):
    p, s, space = CASES[case]
    j_ev, t_ev = _evaluators(p, s)
    want = j_gradient_descent_ev(j_ev, space)
    got = gradient_descent_ev(t_ev, space)
    _assert_same_tuning(got, want, space, t_ev)
    assert len(got.history) == len(want.history)
    for (ga, gc), (wa, wc) in zip(got.history, want.history):
        assert gc == pytest.approx(wc, rel=1e-6)
        for k in wa:
            assert ga[k] == pytest.approx(wa[k], rel=1e-6), k


def test_gradient_descent_reports_the_evaluators_cost_bit_for_bit():
    _, t_ev = _evaluators(*CASES["example"][:2])
    res = gradient_descent_ev(t_ev, EXAMPLE_SPACE)
    again = t_ev.evaluate({k: [v] for k, v in res.best_assignment.items()})
    assert res.best_cost == float(again.total_cost[0])


def test_build_relaxed_objective_value_and_grad_match_jax():
    j_ev, t_ev = _evaluators(*CASES["example"][:2])
    j_raw, _, j_keys = j_build_relaxed_objective(j_ev, EXAMPLE_SPACE)
    t_raw, axes, keys = build_relaxed_objective(t_ev, EXAMPLE_SPACE)
    assert keys == j_keys
    rng = np.random.default_rng(2)
    for _ in range(3):
        u = {k: float(rng.normal(0.0, 1.5)) for k in keys}
        j_val, j_grad = jax.value_and_grad(j_raw)(
            {k: jnp.asarray(v) for k, v in u.items()})
        leaves = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
                  for k, v in u.items()}
        t_val = t_raw(leaves)
        # pUseCombine enters only through comparisons: no gradient path
        t_grad = torch.autograd.grad(t_val, [leaves[k] for k in keys],
                                     allow_unused=True, materialize_grads=True)
        np.testing.assert_allclose(float(t_val.detach()), float(j_val), rtol=1e-9)
        np.testing.assert_allclose([float(g) for g in t_grad],
                                   [float(j_grad[k]) for k in keys], rtol=1e-9)


class _NoGrad(Evaluator):
    """A Hadoop evaluator that declares no differentiable objective."""

    def __init__(self, ev):
        self.ev, self.chunk, self.base_cfg = ev, ev.chunk, ev.base_cfg

    def evaluate(self, overrides):
        return self.ev.evaluate(overrides)

    def exact_cost(self, assignment):
        return self.ev.exact_cost(assignment)


def test_gradient_falls_back_loudly_on_a_non_differentiable_evaluator(caplog):
    _, t_ev = _evaluators(*CASES["calib"][:2])
    ev = _NoGrad(t_ev)
    with pytest.raises(NotDifferentiableError):
        ev.grad_objective()
    with caplog.at_level(logging.WARNING, logger="repro_torch.search.strategies"):
        res = gradient_descent_ev(ev, CALIB_SPACE)
    msgs = [r.getMessage() for r in caplog.records]
    assert any("falling back" in m and "coordinate" in m for m in msgs), msgs
    ref = coordinate_descent_ev(ev, CALIB_SPACE)
    assert (res.best_assignment, res.best_cost, res.evaluations) == \
        (ref.best_assignment, ref.best_cost, ref.evaluations)


def test_gradient_descent_quality_against_coordinate_descent():
    # the twin of tests/test_calib.py's quality test
    _, ev = _evaluators(*CASES["calib"][:2])
    coord = coordinate_descent_ev(ev, CALIB_SPACE)
    grad = gradient_descent_ev(ev, CALIB_SPACE)
    assert np.isfinite(grad.best_cost)
    assert grad.best_cost <= coord.best_cost * 1.05
    assert grad.evaluations <= 20
    ok, _ = ev.param_space.validity_mask({
        k: np.atleast_1d(np.asarray(v)) for k, v in grad.best_assignment.items()})
    assert bool(np.all(ok))
    for k, vals in CALIB_SPACE.items():
        assert min(vals) - 1e-9 <= grad.best_assignment[k] <= max(vals) + 1e-9


# ------------------------------------------- Hadoop-first wrappers, aliases


@pytest.mark.parametrize("name", ["grid", "random", "descent"])
def test_hadoop_first_wrappers_equal_the_ev_forms_and_the_reference(name):
    p, s, space = CASES["calib"]
    c = j_params.CostFactors()
    tp, ts, tc = to_port(p), to_port(s), to_port(c)
    ev = ChunkedEvaluator(tp, ts, tc, device=CPU)
    wrap, ev_form, j_wrap = {
        "grid": (grid_search, grid_search_ev, j_tuner.grid_search),
        "random": (random_search, random_search_ev, j_tuner.random_search),
        "descent": (coordinate_descent, coordinate_descent_ev,
                    j_tuner.coordinate_descent),
    }[name]
    kw = {"samples": 64} if name == "random" else {}
    got = wrap(tp, ts, tc, space, device=CPU, **kw)
    direct = ev_form(ev, space, **kw)
    assert (got.best_assignment, got.best_cost, got.evaluations) == \
        (direct.best_assignment, direct.best_cost, direct.evaluations)
    assert getattr(tuner, wrap.__name__) is wrap
    want = j_wrap(p, s, c, space, **kw)
    assert got.best_assignment == want.best_assignment
    assert got.best_cost == pytest.approx(want.best_cost, rel=1e-12)
    assert got.evaluations == want.evaluations


def test_whatif_aliases_match_the_reference():
    p, s, _ = CASES["calib"]
    c = j_params.CostFactors()
    tp, ts, tc = to_port(p), to_port(s), to_port(c)
    over = {"pSortMB": [16.0, 64.0, 256.0], "pNumReducers": 8.0}
    got = whatif.evaluate_grid(tp, ts, tc, over, device=CPU)
    want = j_whatif.evaluate_grid(p, s, c, over)
    np.testing.assert_allclose(got.total_cost, want.total_cost, rtol=1e-12)
    got = whatif.evaluate_product_grid(tp, ts, tc, CALIB_SPACE, chunk=16,
                                       device=CPU)
    want = j_whatif.evaluate_product_grid(p, s, c, CALIB_SPACE, chunk=16)
    np.testing.assert_allclose(got.total_cost, want.total_cost, rtol=1e-12)
    queries = [{"pSortMB": 64.0}, {"pSortFactor": [5.0, 20.0]}]
    got = whatif.evaluate_queries(tp, ts, tc, queries, device=CPU)
    want = j_whatif.evaluate_queries(p, s, c, queries)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.total_cost, w.total_cost, rtol=1e-12)


def test_cached_evaluator_keys_on_device_and_dtype():
    p, s, c = (to_port(x) for x in (CALIB_P, EXAMPLE_S, j_params.CostFactors()))
    a = cached_evaluator(p, s, c, 64, CPU)
    assert cached_evaluator(p, s, c, 64, CPU) is a
    b = cached_evaluator(p, s, c, 64, CPU, torch.float32)
    assert b is not a and b.dtype == torch.float32 and a.dtype == torch.float64
    assert a.base_cfg["pSortMB"].dtype == torch.float64
    assert b.base_cfg["pSortMB"].dtype == torch.float32
    if not has_cuda():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cached_evaluator(p, s, c, 64)


# ----------------------------------------------------------------- api


def test_api_surface_matches_the_port_manifest():
    import repro_torch.cloud as cloud
    import repro_torch.cluster.network as network
    import repro_torch.spec as spec
    from repro_torch.cloud import cloud_space
    from repro_torch.cluster import cluster_space
    from repro_torch.search.tpu import TPU_AXIS_NAMES

    manifest = json.loads(MANIFEST.read_text())
    assert sorted(api.__all__) == manifest["repro_torch.api"]
    assert sorted(spec.__all__) == manifest["repro_torch.spec"]
    assert sorted(cloud.__all__) == manifest["repro_torch.cloud"]
    assert sorted(network.__all__) == manifest["repro_torch.cluster.network"]
    for mod in (api, spec, cloud, network):
        for name in mod.__all__:
            assert getattr(mod, name, None) is not None, name
    assert list(spec.hadoop_space().names) == manifest["axes"]["hadoop"]
    assert list(cluster_space().names) == manifest["axes"]["cluster"]
    assert list(cloud_space().names) == manifest["axes"]["cloud"]
    assert list(TPU_AXIS_NAMES) == manifest["axes"]["tpu"]
    # the reference's verbs, every one of them, and its spec, cloud and
    # network surfaces
    j_manifest = json.loads((MANIFEST.parents[2] / "repro/spec/manifest.json")
                            .read_text())
    assert manifest["repro_torch.api"] == sorted(j_api.__all__)
    for name in ("spec", "cloud", "cluster.network"):
        assert manifest[f"repro_torch.{name}"] == j_manifest[f"repro.{name}"], name
    for name in ("cluster", "cloud", "tpu"):
        assert manifest["axes"][name] == j_manifest["axes"][name], name


def test_api_registers_only_hadoop_and_names_the_roadmap_for_the_rest():
    # every backend of the reference is registered now (the TPU step model
    # last): nothing is left for the ROADMAP to name, and the "tpu" backend
    # needs its model and shape, as the reference's does
    assert list(api.available_models()) == sorted(j_api.available_models())
    assert list(api.available_models()) == ["cloud", "cluster", "hadoop", "tpu"]
    assert not hasattr(api, "_PENDING")
    with pytest.raises(TypeError, match="needs cfg="):
        api.get_evaluator("tpu")
    with pytest.raises(KeyError, match="unknown cost model"):
        api.get_evaluator("nope")
    ev = api.get_evaluator(JobSpec(), device=CPU)
    assert isinstance(ev, api.CostModel)
    assert api.get_evaluator(ev) is ev


def _specs():
    p, s, _ = CASES["example"]
    j_spec = JJobSpec(params=p, stats=s)
    return j_spec, JobSpec(to_port(p), to_port(s), to_port(j_spec.costs))


def test_api_model_and_sweep_match_the_reference():
    j_spec, t_spec = _specs()
    got = api.model(t_spec, {"pSortMB": 2.0}, device=CPU)
    want = j_api.model(j_spec, {"pSortMB": 2.0})
    np.testing.assert_allclose(np.asarray(got.total_cost),
                               np.asarray(want.total_cost), rtol=1e-12)
    got = api.model(t_spec, device=CPU)
    want = j_api.model(j_spec)
    np.testing.assert_allclose(np.asarray(got.total_cost),
                               np.asarray(want.total_cost), rtol=1e-12)
    over = {"pSortMB": [0.5, 1.0, 2.0]}
    got = api.sweep(t_spec, over, device=CPU)
    want = j_api.sweep(j_spec, over)
    np.testing.assert_allclose(np.asarray(got.total_cost),
                               np.asarray(want.total_cost), rtol=1e-12)


@pytest.mark.parametrize("strategy", ["grid", "descent", "gradient", "topk"])
def test_api_tune_equals_the_direct_call_and_the_reference(strategy):
    j_spec, t_spec = _specs()
    got = api.tune(t_spec, EXAMPLE_SPACE, strategy=strategy, device=CPU)
    ev = ChunkedEvaluator.from_spec(t_spec, device=CPU)
    space = ev.param_space.grid(EXAMPLE_SPACE)
    direct = {"grid": grid_search_ev, "descent": coordinate_descent_ev,
              "gradient": gradient_descent_ev}.get(strategy)
    want = j_api.tune(j_spec, EXAMPLE_SPACE, strategy=strategy)
    if direct is None:       # topk: the ranking
        from repro_torch.search import search_topk

        d = search_topk(ev, space, k=10)
        assert [e.index for e in got.entries] == [e.index for e in d.entries]
        assert [e.index for e in got.entries] == [e.index for e in want.entries]
        return
    d = direct(ev, space)
    assert (got.best_assignment, got.best_cost, got.evaluations) == \
        (d.best_assignment, d.best_cost, d.evaluations)
    _assert_same_tuning(got, want, space, ev)


def test_api_tune_validates_the_space_first():
    _, t_spec = _specs()
    with pytest.raises(ValueError, match="strategy"):
        api.tune(t_spec, EXAMPLE_SPACE, strategy="annealing", device=CPU)
    with pytest.raises(KeyError):
        api.tune(t_spec, {"pNoSuchKnob": [1.0]}, device=CPU)
    with pytest.raises(ValueError):
        api.tune(t_spec, {"pSpillPerc": [0.5, 1.5]}, device=CPU)


def test_api_calibrate_equals_the_direct_call():
    _, t_spec = _specs()
    obs = [Observation(spec=t_spec.replace(pSortMB=mb, pSortFactor=8.0),
                       cost=cost)
           for mb, cost in ((1.0, 3.0), (2.0, 2.5), (4.0, 2.2))]
    names = ["cMapCPUCost", "cLocalIOCost"]
    got = api.calibrate(obs, names, steps=30, device=CPU)
    want = calibrate(obs, names, steps=30, device=CPU)
    assert got == want
