"""The port's cloud layer against the JAX package's, on the CPU in float64.

Contracts (the reference's own, from ``tests/test_cloud.py``):

* ``spot_inflation`` and ``dollars_for`` values and gradients against
  ``jax.grad`` at 1e-12, the ``rate = 0`` and quantum boundaries included;
* the elastic DES (spot reclamation, the queue and predicted autoscalers),
  ``bill_workload``, ``wave_columns`` and ``predicted_extra_nodes`` bit for
  bit; the destrace swimlane event for event;
* the wave rollout's cloud columns (reclaim inflation, the extra capacity
  block, billed seconds) at rtol 1e-9; wave dollars against DES dollars on
  contention-free rows at rtol 1e-3;
* ``CloudEvaluator``: ``evaluate``, top-k, the strategies, the what-if
  service and ``api.tune`` against the reference's; ``ProvisioningReport``
  and ``pareto_front``.

Sizes: at most 8 jobs and 16 scenarios per case.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as j_api
import repro.cloud as j_cloud
import repro.cluster as j_cluster
import repro.cluster.vector_sim as j_vs
import repro.search as j_search
import repro_torch.api as t_api
import repro_torch.cloud as t_cloud
import repro_torch.cluster as t_cluster
import repro_torch.cluster.vector_sim as t_vs
import repro_torch.search as t_search
from repro_torch.compat import has_cuda
from repro_torch.search.evaluator import ExactCostUnavailable, NotDifferentiableError
from repro_torch.spec import ProvisioningReport

CPU = "cpu"
RTOL = 1e-9
PRICE = 0.36


def _side(cluster, cloud):
    ns = {n: getattr(cluster, n) for n in cluster.__all__}
    ns.update({n: getattr(cloud, n) for n in cloud.__all__})
    return types.SimpleNamespace(**ns)


J = _side(j_cluster, j_cloud)
T = _side(t_cluster, t_cloud)
SIDES = (J, T)


def _clean(m):
    return m.SimConfig(speculative_execution=False)


def _grad_t(fn, *xs, **kw):
    ts = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in xs]
    out = fn(*ts, **kw)
    gs = torch.autograd.grad(out.sum(), ts)
    return out.detach().numpy(), [g.numpy() for g in gs]


def _grad_j(fn, *xs, **kw):
    args = [jnp.asarray(x, dtype=jnp.float64) for x in xs]
    val = np.asarray(fn(*args, **kw))
    gs = jax.grad(lambda *a: fn(*a, **kw).sum(),
                  argnums=tuple(range(len(xs))))(*args)
    return val, [np.asarray(g) for g in gs]


# ---------------------------------------------------------------- pricing


@pytest.mark.parametrize("rate,dur", [
    (0.0, 30.0), (1e-4, 30.0), (1e-2, 30.0), (3e-3, 45.0), (0.0, 0.0),
    ([0.0, 1e-3, 5e-2], [30.0, 0.5, 120.0])])
def test_spot_inflation_values_and_grads_match_jax(rate, dur):
    got, g_t = _grad_t(t_cloud.spot_inflation, rate, dur)
    want, g_j = _grad_j(j_cloud.spot_inflation, rate, dur)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
        assert np.isfinite(a).all()


@pytest.mark.parametrize("quantum", [0.0, 3600.0, 60.0])
@pytest.mark.parametrize("span", [1800.0, 3600.0, [100.0, 7201.0]])
def test_dollars_for_values_and_grads_match_jax(quantum, span):
    counts, prices = [2.0, 3.0], [0.30, 0.1]
    got, g_t = _grad_t(t_cloud.dollars_for, span, counts, prices,
                       billing_quantum=quantum)
    want, g_j = _grad_j(j_cloud.dollars_for, span, counts, prices,
                        billing_quantum=quantum)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)
    # a quantum given as a tensor takes the guarded ceil path
    tq = t_cloud.dollars_for(torch.tensor(span, dtype=torch.float64), counts,
                             prices, billing_quantum=torch.tensor(quantum))
    np.testing.assert_allclose(tq.numpy(), want, rtol=1e-12)


def test_fleet_helpers_match_the_reference():
    for args in [(10.0, 4, 2, 3), (3.0, 4, 2, 3), (100.0, 4, 2, 3),
                 (9.0, 4, 0, 3), (9.0, 4, 2, 0)]:
        assert t_cloud.predicted_extra_nodes(*args) \
            == j_cloud.predicted_extra_nodes(*args)
    assert t_cloud.AUTOSCALE_POLICIES == j_cloud.AUTOSCALE_POLICIES
    for kw in [dict(policy="queue", max_extra_nodes=2, high_water=1.0,
                    reclaim_rate=2e-3, billing_quantum=60.0), {}]:
        cols = []
        for m in SIDES:
            cc = m.ClusterConfig(num_nodes=4, node_classes=(
                m.NodeClass(2, 1.0, 0.10, spot=True), m.NodeClass(2, 1.0, 0.40)))
            cols.append(m.wave_columns(m.ElasticFleet(**kw), cc))
        assert cols[0].keys() == cols[1].keys()
        for k in cols[0]:
            np.testing.assert_array_equal(cols[1][k], cols[0][k])
    with pytest.raises(ValueError):
        t_cloud.ElasticFleet(policy="sometimes")
    with pytest.raises(ValueError):
        t_cloud.ElasticFleet(reclaim_rate=-1.0)


def test_pareto_front_matches_the_reference():
    rng = np.random.default_rng(0)
    c = rng.random(16)
    q = rng.random(16)
    c[3] = np.inf
    np.testing.assert_array_equal(t_cloud.pareto_front(c, q),
                                  j_cloud.pareto_front(c, q))
    with pytest.raises(ValueError):
        t_cloud.pareto_front([1.0], [1.0, 2.0])


# ------------------------------------------------------------ DES elasticity


def _elastic_case(m, case):
    cl = m.default_job_classes()
    spot_cc = m.ClusterConfig(num_nodes=4, node_classes=(
        m.NodeClass(2, 1.0, 0.10, spot=True), m.NodeClass(2, 1.0, 0.40)))
    if case == "spot":
        tr = m.rescale(m.poisson_trace(cl, 8, seed=2), 0.1)
        el = m.ElasticFleet(reclaim_rate=0.05, provision_latency=10.0, seed=1)
        return tr, spot_cc, el
    if case == "queue":
        tr = m.rescale(m.poisson_trace(cl, 8, seed=6), 0.5)
        el = m.ElasticFleet(policy="queue", max_extra_nodes=2, high_water=2.0,
                            provision_latency=5.0, billing_quantum=60.0)
        return tr, m.ClusterConfig(num_nodes=2), el
    if case == "predicted":
        tr = m.rescale(m.poisson_trace(cl, 8, seed=7), 0.5)
        el = m.ElasticFleet(policy="predicted", max_extra_nodes=2,
                            provision_latency=3.0, extra_hourly_price=0.5)
        return tr, m.ClusterConfig(num_nodes=2), el
    tr = m.rescale(m.poisson_trace(cl, 8, seed=2), 0.1)
    el = m.ElasticFleet(policy="queue", max_extra_nodes=1, high_water=2.0,
                        provision_latency=5.0, reclaim_rate=0.05, seed=1)
    return tr, spot_cc, el


@pytest.mark.parametrize("case", ["spot", "queue", "predicted", "spot_queue"])
def test_elastic_des_and_bill_match_the_reference(case):
    out = []
    for m in SIDES:
        tr, cc, el = _elastic_case(m, case)
        res = m.simulate_workload(tr, cc, _clean(m), elastic=el)
        bill = m.bill_workload(res, cc, elastic=el)
        window = (min(j.submit_time for j in res.jobs), res.makespan)
        out.append((res, bill, m.bill_workload(res, cc, elastic=el,
                                               window=window)))
    (j_res, j_bill, j_win), (t_res, t_bill, t_win) = out
    assert dataclasses.astuple(t_res) == dataclasses.astuple(j_res)
    assert t_bill == j_bill and t_win == j_win
    if case in ("spot", "spot_queue"):
        assert t_res.num_reclaimed > 0


def test_bill_refuses_an_unfinished_workload():
    tr, cc, el = _elastic_case(T, "spot")
    res = T.simulate_workload(tr, cc, _clean(T), elastic=el)
    with pytest.raises(ValueError, match="unfinished"):
        T.bill_workload(res, cc, elastic=el, window=(0.0, float("inf")))


def test_destrace_renders_the_reference_swimlane():
    from repro.obs.destrace import workload_trace as j_trace
    from repro_torch.obs import workload_trace as t_trace

    events = []
    for m, fn in ((J, j_trace), (T, t_trace)):
        tr, cc, el = _elastic_case(m, "spot_queue")
        res = m.simulate_workload(tr, cc, _clean(m), elastic=el)
        events.append(fn(tr, res, cc).events())
    # the tracer names its own process after the package; the rest is equal
    for evs, pkg in zip(events, ("repro", "repro_torch")):
        assert evs[0]["name"] == "process_name" and evs[0]["args"] == {"name": pkg}
    assert events[1][1:] == events[0][1:]
    instants = {e["name"] for e in events[1] if e.get("ph") == "i"}
    assert {"reclaim", "provisioned"} <= instants


# ------------------------------------------------------- the wave rollout


def _cloud_batch(seed, b=12):
    rng = np.random.default_rng(seed)
    cols = J.pack_trace(J.poisson_trace(J.default_job_classes(), 8, rate=1.0,
                                        seed=3))
    sp = rng.choice([0.0, 1.0, 2.0], b)
    od = rng.choice([1.0, 2.0, 4.0], b)
    n = sp + od
    rate = rng.choice([0.05, 0.2], b)
    tile = lambda a: np.tile(a, (b, 1))
    return {
        "arrival": tile(cols["arrival"]) / rate[:, None],
        "n_maps": tile(cols["n_maps"]), "n_reds": tile(cols["n_reds"]),
        "map_cost": tile(cols["map_cost"]), "red_work": tile(cols["red_work"]),
        "shuffle": tile(cols["shuffle"]) * ((n - 1) / n)[:, None],
        "queue": tile(cols["queue"]),
        "policy": rng.choice([0.0, 1.0, 2.0, 3.0], b),
        "slowstart": rng.choice([0.05, 0.8], b),
        "map_slots": np.stack([sp * 2, od * 2], 1),
        "red_slots": np.stack([sp * 2, od * 2], 1),
        "speedup": np.ones((b, 2)),
        "reclaim_rate": np.stack([np.where(sp > 0, rng.choice([0.0, 2e-3], b),
                                           0.0), np.zeros(b)], 1),
        "autoscale": rng.choice([0.0, 1.0, 2.0], b),
        "high_water": rng.choice([0.0, 2.0], b),
        "provision_latency": rng.choice([0.0, 5.0], b),
        "extra_map_slots": np.full(b, 4.0),
        "extra_red_slots": np.full(b, 2.0),
        "billing_quantum": rng.choice([0.0, 60.0], b),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simulate_batch_cloud_columns_match_the_reference(seed):
    scen = _cloud_batch(seed)
    got = t_vs.simulate_batch(scen, device=CPU)
    want = j_vs.simulate_batch(scen)
    assert set(got) == set(want) and "extra_billed_s" in got
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == w.dtype, k
        if k == "converged":
            np.testing.assert_array_equal(got[k], w)
        else:
            np.testing.assert_allclose(got[k], w, rtol=RTOL, err_msg=k)


def test_unconverged_cloud_rows_bill_inf():
    scen = _cloud_batch(4, b=4)
    got = t_vs.simulate_batch(scen, n_steps=2, device=CPU)
    want = j_vs.simulate_batch(scen, n_steps=2)
    assert not got["converged"].any()
    np.testing.assert_array_equal(got["extra_billed_s"],
                                  np.asarray(want["extra_billed_s"]))
    assert np.isinf(got["extra_billed_s"]).all()


# ---------------------------------------------------------- the evaluator


def _small_ev(m, **kw):
    kw.setdefault("n_jobs", 8)
    kw.setdefault("n_seeds", 1)
    kw.setdefault("chunk", 8)
    kw.setdefault("sim", _clean(m))
    if m is T:
        kw.setdefault("device", CPU)
    return m.CloudEvaluator(m.default_job_classes(), **kw)


@pytest.fixture(scope="module")
def evaluators():
    kw = lambda m: dict(n_seeds=2, base_rate=0.05, elastic=m.ElasticFleet(
        max_extra_nodes=2, provision_latency=5.0, billing_quantum=60.0))
    return _small_ev(J, **kw(J)), _small_ev(T, **kw(T))


def _same_result(got, want):
    for k, w in want.outputs.items():
        np.testing.assert_allclose(got.outputs[k], np.asarray(w), rtol=RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(got.total_cost, np.asarray(want.total_cost),
                               rtol=RTOL)


@pytest.mark.parametrize("overrides", [
    {"pOnDemandNodes": np.array([2.0, 0.0, 0.0, 4.0]),
     "pSpotNodes": np.array([0.0, 0.0, 0.0, 2.0]),
     "spotReclaimRate": np.array([0.0, 0.0, 1e-3, 1e-3])},
    {"pOnDemandNodes": np.array([1.0, 2.0, 1.0]),
     "pSpotNodes": np.array([3.0, 2.0, 1.0]),
     "autoscalePolicy": np.array([1.0, 2.0, 1.0]),
     "autoscaleHighWater": 2.0, "sloLatency": 200.0},
    {"pOnDemandNodes": np.array([2.0, 4.0]), "pNumRacks": np.array([2.0, 4.0]),
     "crossRackBw": 0.5, "schedPolicy": np.array([1.0, 3.0])},
], ids=["mask", "autoscale_slo", "topology_policy"])
def test_cloud_evaluator_matches_the_reference(evaluators, overrides):
    j_ev, t_ev = evaluators
    _same_result(t_ev.evaluate(overrides), j_ev.evaluate(overrides))


def test_cloud_evaluator_search_service_and_report(evaluators):
    j_ev, t_ev = evaluators
    space = {"pOnDemandNodes": [1.0, 2.0, 4.0], "pSpotNodes": [0.0, 2.0]}
    want = j_search.search_topk(j_ev, space, k=3)
    got = t_search.search_topk(t_ev, space, k=3)
    assert [e.index for e in got.entries] == [e.index for e in want.entries]
    np.testing.assert_allclose([e.cost for e in got.entries],
                               [e.cost for e in want.entries], rtol=RTOL)
    a = j_search.coordinate_descent_ev(j_ev, space)
    b = t_search.coordinate_descent_ev(t_ev, space)
    assert b.best_assignment == a.best_assignment
    np.testing.assert_allclose(b.best_cost, a.best_cost, rtol=RTOL)
    with t_search.WhatIfService(t_ev) as svc:
        r = svc.sweep("pOnDemandNodes", [1.0, 2.0, 4.0]).result(timeout=120)
    seq = t_ev.evaluate(r.overrides)
    assert r.total_cost.tobytes() == seq.total_cost.tobytes()
    rep = t_ev.report({"pOnDemandNodes": np.array([1.0, 2.0, 4.0])})
    assert isinstance(rep, ProvisioningReport)
    j_rep = j_ev.report({"pOnDemandNodes": np.array([1.0, 2.0, 4.0])})
    for f in dataclasses.fields(rep):
        np.testing.assert_allclose(getattr(rep, f.name),
                                   np.asarray(getattr(j_rep, f.name)), rtol=RTOL)
    assert rep is not None and \
        t_cloud.provisioning_report(seq.outputs).valid is seq.outputs["valid"]


def test_cloud_exact_cost_contract_matches_the_reference(evaluators):
    j_ev, t_ev = evaluators
    for a in ({"pOnDemandNodes": 2.0, "pSpotNodes": 2.0},
              {"pOnDemandNodes": 4.0, "sloLatency": 1e4},
              {"pOnDemandNodes": 0.0, "pSpotNodes": 0.0}):
        assert t_ev.exact_cost(a) == j_ev.exact_cost(a)
    with pytest.raises(t_cloud.SloUnmetError):
        t_ev.exact_cost({"pOnDemandNodes": 2, "sloLatency": 1e-6})
    assert issubclass(t_cloud.SloUnmetError, ExactCostUnavailable)
    with pytest.raises(KeyError):
        t_ev.exact_cost({"nope": 1.0})
    with pytest.raises(NotDifferentiableError):
        t_ev.grad_objective()


def test_wave_dollars_match_des_dollars_contention_free():
    # light load, no reclamation: the two backends bill the same window
    ev = _small_ev(T, base_rate=0.02, on_demand_price=PRICE, spot_price=0.09)
    r = ev.evaluate({"pOnDemandNodes": np.array([2.0]),
                     "pSpotNodes": np.array([2.0])})
    exact = ev.exact_cost({"pOnDemandNodes": 2, "pSpotNodes": 2})
    assert np.isclose(float(r.outputs["c_dollarsPerJob"][0]), exact, rtol=1e-3)


def test_api_tune_on_the_cloud_backend_matches_the_reference():
    space = {"pOnDemandNodes": [1.0, 2.0, 4.0], "pSpotNodes": [0.0, 2.0],
             "sloLatency": [300.0]}
    kw = dict(n_jobs=6, n_seeds=1, chunk=8, slo_target=0.5)
    want = j_api.tune("cloud", space, strategy="grid", sim=_clean(J), **kw)
    got = t_api.tune("cloud", space, strategy="grid", sim=_clean(T),
                     device=CPU, **kw)
    assert got.best_assignment == want.best_assignment
    np.testing.assert_allclose(got.best_cost, want.best_cost, rtol=RTOL)
    rep = t_api.sweep("cloud", {"pOnDemandNodes": [1.0, 2.0]}, device=CPU,
                      n_jobs=6, n_seeds=1, chunk=8)
    assert isinstance(rep, ProvisioningReport)
    assert np.asarray(rep.dollars_per_job).shape == (2,)


@pytest.mark.skipif(has_cuda(), reason="checks the refusal without a card")
def test_cloud_evaluator_raises_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.CloudEvaluator(n_jobs=4, n_seeds=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_api.get_evaluator("cloud", n_jobs=4, n_seeds=1)


def test_spot_planning_example_runs_on_the_cpu():
    import runpy
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples/torch_spot_planning.py"
    main = runpy.run_path(str(path), run_name="example")["main"]
    out = main(["--device", CPU, "--smoke"])
    assert out["front"].any()
    assert np.isfinite(out["tuned"].best_cost) and np.isfinite(out["exact"])
