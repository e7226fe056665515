"""The port's cluster layer against the JAX package's, on the CPU in float64.

Contracts (the reference's own, from ``tests/test_cluster.py`` and
``tests/test_network_dag.py``):

* the network model: ``per_reducer_shuffle``, ``max_min_rates`` and
  ``flow_rates`` equal; ``effective_bandwidth`` values and gradients
  against ``jax.grad`` at 1e-12; the job model's topology hook likewise;
* workload traces, ``task_costs`` and the multi-job DES bit for bit, every
  ``JobStats`` field, record and online episode equal, for every policy;
* ``simulate_batch`` (the batched torch rollout) against the reference's
  vmapped ``while_loop``: per-job ``finish``/``latency`` and the summary
  columns at rtol 1e-9, ``converged`` exact, for every policy and for the
  DAG and topology columns; independent of how often the host reads the
  loop flag and of how the rows are split over devices;
* the port's wave against the port's DES at rtol 1e-3 on contention-free
  rows; ``ClusterEvaluator``'s ``evaluate``, top-k, strategies, the what-if
  service and ``api.tune`` against the reference's.

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
import repro.cluster as j_cluster
import repro.cluster.network as j_network
import repro.cluster.vector_sim as j_vs
import repro.core.hadoop.model as j_model
import repro.core.hadoop.params as j_params
import repro.search as j_search
import repro_torch.api as t_api
import repro_torch.cluster as t_cluster
import repro_torch.cluster.network as t_network
import repro_torch.cluster.vector_sim as t_vs
import repro_torch.core.hadoop.model as t_model
import repro_torch.core.hadoop.params as t_params
import repro_torch.search as t_search
from repro_torch.compat import has_cuda
from repro_torch.search.evaluator import NotDifferentiableError

CPU = "cpu"
RTOL = 1e-9
SCHEDULERS = ("fifo", "fair", "fair_preempt", "capacity")


def _side(cluster, params):
    ns = {n: getattr(cluster, n) for n in cluster.__all__}
    ns.update(HadoopParams=params.HadoopParams, ProfileStats=params.ProfileStats,
              CostFactors=params.CostFactors, MiB=params.MiB)
    return types.SimpleNamespace(**ns)


J = _side(j_cluster, j_params)
T = _side(t_cluster, t_params)
SIDES = (J, T)


def _clean(m):
    return m.SimConfig(speculative_execution=False)


def _noisy(m):
    return m.SimConfig(seed=11, task_time_jitter=0.2, straggler_prob=0.1)


def _big_small(m):
    """One big job hogging the cluster, one small job behind it — the
    canonical preemption scenario (two classes = two queues)."""
    big = m.JobClass("batch", m.HadoopParams(pNumMappers=64, pNumReducers=8,
                                             pSplitSize=64 * m.MiB),
                     m.ProfileStats(), m.CostFactors())
    small = m.JobClass("adhoc", m.HadoopParams(pNumMappers=4, pNumReducers=1,
                                               pSplitSize=64 * m.MiB),
                       m.ProfileStats(), m.CostFactors())
    return m.WorkloadTrace((m.JobArrival(0, big, 0.0),
                            m.JobArrival(1, small, 30.0)))


def _dag_chain(m, kinds=("barrier", "slowstart")):
    by = {c.name: c for c in m.default_job_classes()}
    dag = m.dag_from_templates(
        "chain", [by["wordcount"], by["sort"], by["filter"]],
        [(0, 1, kinds[0]), (1, 2, kinds[1])])
    return m.dag_trace(dag, n_instances=2, inter_arrival=5.0)


def _arrival_tuples(tr):
    return [(a.job_id, a.klass.name, a.submit_time, a.klass.n_maps,
             a.klass.n_reduces, a.deps) for a in tr.arrivals]


def scenario_for(m, trace, cc, rate, *, policy=0.0, queue_frac=None):
    """Wave-model scenario mirroring ``cc`` (one row), as the reference's
    ``tests/test_cluster.py`` builds it."""
    cols = m.pack_trace(trace)
    n = cc.num_nodes
    fleet = sorted(cc.node_classes, key=lambda nc: -nc.speedup) \
        or [m.NodeClass(n, 1.0)]
    scen = {
        "arrival": (cols["arrival"] / rate)[None, :],
        "n_maps": cols["n_maps"][None, :],
        "n_reds": cols["n_reds"][None, :],
        "map_cost": cols["map_cost"][None, :],
        "red_work": cols["red_work"][None, :],
        "shuffle": (cols["shuffle"] * (n - 1) / n)[None, :],
        "queue": cols["queue"][None, :],
        "map_slots": np.array(
            [[float(nc.count * cc.map_slots_per_node) for nc in fleet]]),
        "red_slots": np.array(
            [[float(nc.count * cc.reduce_slots_per_node) for nc in fleet]]),
        "speedup": np.array([[nc.speedup for nc in fleet]]),
        "policy": np.array([float(policy)]),
        "slowstart": np.array([cc.reduce_slowstart]),
    }
    if queue_frac is not None:
        scen["queue_frac"] = np.array([queue_frac], dtype=np.float64)
    return scen


def _planner_batch(seed=0, b=12, n_jobs=8, policies=(0.0, 1.0, 2.0, 3.0),
                   hetero=True):
    """A planner-shaped batch of ``b`` rows (nodes, slots, slowstart, load,
    policy, fleet mix), built from one packed trace with numpy."""
    rng = np.random.default_rng(seed)
    cols = J.pack_trace(J.poisson_trace(J.default_job_classes(), n_jobs,
                                        rate=1.0, seed=3))
    nodes = rng.choice([2.0, 4.0, 8.0], b)
    mpn = rng.choice([1.0, 2.0], b)
    rpn = rng.choice([1.0, 2.0], b)
    slow = rng.choice([0.05, 0.8], b)
    rate = rng.choice([0.05, 0.1, 0.2], b)
    pol = rng.choice(policies, b)
    tile = lambda a: np.tile(a, (b, 1))
    frac = (nodes - 1.0) / nodes
    scen = {
        "arrival": tile(cols["arrival"]) / rate[:, None],
        "n_maps": tile(cols["n_maps"]), "n_reds": tile(cols["n_reds"]),
        "map_cost": tile(cols["map_cost"]), "red_work": tile(cols["red_work"]),
        "shuffle": tile(cols["shuffle"]) * frac[:, None],
        "queue": tile(cols["queue"]), "policy": pol, "slowstart": slow,
    }
    if hetero:
        fast = np.minimum(rng.choice([0.0, 1.0, 2.0], b), nodes)
        spd = np.where(fast > 0, rng.choice([1.5, 2.0], b), 1.0)
        scen["map_slots"] = np.stack([fast * mpn, (nodes - fast) * mpn], 1)
        scen["red_slots"] = np.stack([fast * rpn, (nodes - fast) * rpn], 1)
        scen["speedup"] = np.stack([spd, np.ones(b)], 1)
    else:
        scen["map_slots"] = nodes * mpn
        scen["red_slots"] = nodes * rpn
    return scen


def _assert_batch_equal(got, want, rtol=RTOL):
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == w.dtype, (k, got[k].dtype, w.dtype)
        assert got[k].shape == w.shape, k
        if k == "converged":
            np.testing.assert_array_equal(got[k], w)
        else:
            np.testing.assert_allclose(got[k], w, rtol=rtol, err_msg=k)


def _grad_t(fn, *xs):
    ts = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in xs]
    out = fn(*ts)
    gs = torch.autograd.grad(out, ts)
    return float(out.detach()), [float(g) for g in gs]


def _grad_j(fn, *xs):
    args = [jnp.asarray(x, dtype=jnp.float64) for x in xs]
    val = float(fn(*args))
    gs = jax.grad(fn, argnums=tuple(range(len(xs))))(*args)
    return val, [float(g) for g in gs]


# ------------------------------------------------------------------ network


def test_per_reducer_shuffle_and_task_costs_match_the_reference():
    for jj, tt in zip(J.default_job_classes(), T.default_job_classes()):
        assert jj.name == tt.name
        assert j_cluster.task_costs(jj) == t_cluster.task_costs(tt)
        assert j_cluster.shuffle_full(jj) == t_cluster.shuffle_full(tt)
        assert (j_cluster.stage_output_bytes(jj)
                == t_cluster.stage_output_bytes(tt))
    for net, red in [(123.0, 0), (123.0, 7), (0.5, 1)]:
        assert (t_network.per_reducer_shuffle(net, red)
                == j_network.per_reducer_shuffle(net, red))


@pytest.mark.parametrize("usages,caps", [
    ([{"a": 1.0}, {"a": 1.0}, {"b": 1.0}], {"a": 1.0, "b": 5.0}),
    ([{"a": 1.0, "b": 1.0}, {"b": 1.0}], {"a": 0.4, "b": 2.0}),
    ([{"x": 2.0}, {}], {"x": float("inf")}),
])
def test_max_min_rates_match_the_reference(usages, caps):
    assert t_network.max_min_rates(usages, caps) \
        == j_network.max_min_rates(usages, caps)


@pytest.mark.parametrize("racks,bw,osub,dst", [
    (2, 1.0, 2.0, [0, 2, 4, 6]), (4, 0.5, 2.0, [0, 1, 2, 3, 5]),
    (1, float("inf"), 1.0, [0, 1]), (3, 2.0, 1.0, [0])])
def test_flow_rates_match_the_reference(racks, bw, osub, dst):
    jt = j_network.Topology(num_racks=racks, cross_rack_bw=bw, oversub=osub)
    tt = t_network.Topology(num_racks=racks, cross_rack_bw=bw, oversub=osub)
    assert tt.is_flat == jt.is_flat and tt.rack_capacity == jt.rack_capacity
    assert t_network.flow_rates(tt, dst, 8) == j_network.flow_rates(jt, dst, 8)
    with pytest.raises(ValueError):
        t_network.Topology(num_racks=0)


@pytest.mark.parametrize("racks,bw,osub,flows", [
    (4.0, 2.0, 2.0, 8.0),        # contended
    (4.0, 1.0, 2.0, 4.0),        # flows == racks: the max(F/R, 1) tie
    (1.0, 0.5, 1.0, 8.0),        # one rack: flat
    (2.0, 100.0, 1.0, 1.0),      # share > 1: capped at nominal
    (3.0, 0.7, 1.5, 0.0),        # no flows
    (4.0, 0.5, 1.0, 6.0),        # oversubscription at its floor
])
def test_effective_bandwidth_values_and_grads_match_jax(racks, bw, osub, flows):
    got, g_t = _grad_t(t_network.effective_bandwidth, racks, bw, osub, flows)
    want, g_j = _grad_j(j_network.effective_bandwidth, racks, bw, osub, flows)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-12, atol=1e-12)
    assert all(np.isfinite(g_t))


def test_effective_bandwidth_inf_uplink_and_batched_columns():
    inf = float("inf")
    assert float(t_network.effective_bandwidth(4.0, inf, 1.0, 8.0)) == 1.0
    cols = [torch.tensor([1.0, 4.0, 4.0]), torch.tensor([inf, 0.5, 2.0]),
            torch.tensor([1.0, 2.0, 2.0]), torch.tensor([8.0, 8.0, 2.0])]
    got = t_network.effective_bandwidth(*[c.double() for c in cols])
    want = j_network.effective_bandwidth(*[jnp.asarray(c.numpy(), jnp.float64)
                                           for c in cols])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


@pytest.mark.parametrize("topo", [
    {"pNumRacks": 1.0},
    {"pNumRacks": 4.0, "crossRackBw": 0.5, "oversubscription": 2.0},
    {"pNumRacks": 2.0, "crossRackBw": 1e9},
    {"pNumRacks": 4.0, "crossRackBw": 0.5, "nFlows": 3.0},
])
def test_job_model_topology_hook_matches_the_reference(topo):
    from repro_torch.core.hadoop.model import pack_config as t_pack

    hp = dict(pNumMappers=16, pNumReducers=8, pNumNodes=8)
    j_cfg = j_model.pack_config(j_params.HadoopParams(**hp),
                                j_params.ProfileStats(), j_params.CostFactors())
    t_cfg = t_pack(t_params.HadoopParams(**hp), t_params.ProfileStats(),
                   t_params.CostFactors(), device=CPU)
    keys = sorted(topo)

    def j_fn(*xs):
        cfg = dict(j_cfg, **dict(zip(keys, xs)))
        return j_model.job_model_jnp(cfg)["j_totalCost"]

    def t_fn(*xs):
        cfg = dict(t_cfg, **dict(zip(keys, xs)))
        return t_model.job_model_torch(cfg)["j_totalCost"]

    xs = [topo[k] for k in keys]
    got, g_t = _grad_t(t_fn, *xs)
    want, g_j = _grad_j(j_fn, *xs)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-12, atol=1e-300)
    flat = float(t_model.job_model_torch(dict(t_cfg))["j_totalCost"])
    if topo["pNumRacks"] == 1.0:
        assert got == flat                       # racks 1 = the flat network


# ------------------------------------------------------------------ workload


@pytest.mark.parametrize("kind", ["poisson", "bursty", "replayed", "dag",
                                  "rescaled"])
def test_traces_match_the_reference_bit_for_bit(kind):
    def make(m):
        cl = m.default_job_classes()
        if kind == "poisson":
            return m.poisson_trace(cl, 8, rate=0.5, seed=7)
        if kind == "bursty":
            return m.bursty_trace(cl, n_bursts=2, burst_size=4, burst_gap=60.0,
                                  seed=2)
        if kind == "replayed":
            return m.replayed_trace([0.0, 3.5, 3.5, 10.0], cl, seed=1)
        if kind == "dag":
            return _dag_chain(m)
        return m.rescale(m.poisson_trace(cl, 6, seed=4), 0.3)

    assert _arrival_tuples(make(T)) == _arrival_tuples(make(J))
    t_cols = t_cluster.pack_trace(make(T))
    for k, v in j_cluster.pack_trace(make(J)).items():
        np.testing.assert_array_equal(t_cols[k], v)


def test_dag_report_matches_the_reference():
    reports = []
    for m in SIDES:
        tr = _dag_chain(m)
        res = m.simulate_workload(tr, m.ClusterConfig(num_nodes=4),
                                  m.SimConfig(seed=1))
        reports.append(m.dag_report(tr, res))
    t_rep, j_rep = reports[1], reports[0]
    for f in dataclasses.fields(t_rep):
        np.testing.assert_array_equal(np.asarray(getattr(t_rep, f.name)),
                                      np.asarray(getattr(j_rep, f.name)))
    assert float(t_rep.critical_path_s) <= float(t_rep.makespan_s)


# ---------------------------------------------------------------------- DES


def _des_case(m, case):
    cl = m.default_job_classes()
    tr = m.rescale(m.poisson_trace(cl, 8, rate=1.0, seed=1), 0.1)
    if case in SCHEDULERS:
        return tr, m.ClusterConfig(num_nodes=4, scheduler=case,
                                   preempt_timeout=5.0), _noisy(m), None
    if case == "heterogeneous":
        return tr, m.ClusterConfig(node_classes=(m.NodeClass(2, 2.0),
                                                 m.NodeClass(2, 1.0))), \
            _noisy(m), None
    if case == "failure":
        return tr, m.ClusterConfig(num_nodes=3), \
            m.SimConfig(seed=3, node_failures=((15.0, 1),)), None
    if case == "topology":
        return tr, m.ClusterConfig(
            num_nodes=8, topology=m.Topology(num_racks=4, cross_rack_bw=0.5,
                                             oversub=2.0)), _clean(m), None
    if case == "big_small_capacity":
        return _big_small(m), m.ClusterConfig(
            num_nodes=2, scheduler="capacity", preempt_timeout=0.0,
            capacities=(("adhoc", 1.0), ("batch", 1.0))), _clean(m), None
    if case == "dag":
        return _dag_chain(m), m.ClusterConfig(num_nodes=4, scheduler="fair"), \
            _noisy(m), None
    raise AssertionError(case)


@pytest.mark.parametrize("case", list(SCHEDULERS) + [
    "heterogeneous", "failure", "topology", "big_small_capacity", "dag"])
def test_des_matches_the_reference_bit_for_bit(case):
    results = []
    for m in SIDES:
        tr, cc, sc, el = _des_case(m, case)
        results.append(m.simulate_workload(tr, cc, sc, elastic=el))
    j_res, t_res = results
    assert dataclasses.astuple(t_res) == dataclasses.astuple(j_res)
    assert t_res.p95_latency == j_res.p95_latency
    assert [j.queueing_delay for j in t_res.jobs] == \
        [j.queueing_delay for j in j_res.jobs]


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_flat_topology_is_the_flat_network_on_the_port(sched):
    tr = T.rescale(T.poisson_trace(T.default_job_classes(), 8, seed=5), 0.2)
    ref = T.simulate_workload(tr, T.ClusterConfig(num_nodes=6, scheduler=sched),
                              _noisy(T))
    for topo in (T.Topology.flat(), T.Topology(num_racks=3)):
        got = T.simulate_workload(
            tr, T.ClusterConfig(num_nodes=6, scheduler=sched, topology=topo),
            _noisy(T))
        assert dataclasses.astuple(got) == dataclasses.astuple(ref)


def test_single_job_trace_reproduces_the_ports_simulate_job():
    from repro_torch.core.hadoop.simulator import simulate_job

    jc = T.default_job_classes()[1]
    tr = T.WorkloadTrace((T.JobArrival(0, jc, 0.0),))
    cc = T.ClusterConfig.from_params(jc.params)
    sc = _noisy(T)
    res = T.simulate_workload(tr, cc, sc)
    single = simulate_job(jc.params, jc.stats, jc.costs, sc)
    assert res.makespan == single.makespan


# ------------------------------------------------------- the wave rollout


@pytest.mark.parametrize("policy", [0.0, 1.0, 2.0, 3.0])
@pytest.mark.parametrize("hetero", [False, True], ids=["homog", "hetero"])
def test_simulate_batch_matches_the_reference(policy, hetero):
    scen = _planner_batch(seed=int(policy) + 10 * hetero, policies=(policy,),
                          hetero=hetero)
    if policy == 3.0:
        scen["queue_frac"] = np.tile([0.25] * 4, (12, 1))
    got = t_vs.simulate_batch(scen, device=CPU)
    want = j_vs.simulate_batch(scen)
    _assert_batch_equal(got, want)
    assert got["converged"].all()


def test_simulate_batch_mixed_policies_match_the_reference():
    scen = _planner_batch(seed=5, b=16)
    _assert_batch_equal(t_vs.simulate_batch(scen, device=CPU),
                        j_vs.simulate_batch(scen))


@pytest.mark.parametrize("case", ["topology", "dag", "dag_topology",
                                  "truncated"])
def test_simulate_batch_columns_match_the_reference(case):
    n_steps = None
    if case in ("topology", "truncated"):
        scen = _planner_batch(seed=7, b=8, policies=(0.0, 1.0))
        scen.update(topo_racks=np.array([1.0, 2.0, 4.0, 4.0] * 2),
                    topo_cross_bw=np.array([np.inf, 1.0, 0.5, 1e9] * 2),
                    topo_oversub=np.array([1.0, 2.0, 2.0, 1.0] * 2))
        n_steps = 4 if case == "truncated" else None
    else:
        cols = J.pack_trace(_dag_chain(J))
        b = 6
        tile = lambda a: np.tile(a, (b, 1))
        nodes = np.array([2.0, 4.0, 8.0, 2.0, 4.0, 8.0])
        scen = {k: tile(v) for k, v in cols.items()}
        scen.update(map_slots=nodes * 2.0, red_slots=nodes * 2.0,
                    policy=np.array([0.0, 1.0, 0.0, 1.0, 2.0, 3.0]),
                    slowstart=np.full(b, 0.05))
        if case == "dag_topology":
            scen.update(topo_racks=np.full(b, 2.0),
                        topo_cross_bw=np.full(b, 0.5),
                        topo_oversub=np.full(b, 2.0))
    got = t_vs.simulate_batch(scen, n_steps=n_steps, device=CPU)
    want = j_vs.simulate_batch(scen, n_steps=n_steps)
    _assert_batch_equal(got, want)
    if case == "truncated":
        assert not got["converged"].all()
        assert np.isinf(got["p95_latency"][got["converged"] == 0]).all()


@pytest.mark.parametrize("check_every", [1, 3, 64])
def test_rollout_does_not_depend_on_how_often_the_flag_is_read(check_every):
    scen = _planner_batch(seed=2, b=10)
    scen["autoscale"] = np.tile([0.0, 1.0], 5)
    scen["extra_map_slots"] = np.full(10, 4.0)
    scen["extra_red_slots"] = np.full(10, 2.0)
    scen["reclaim_rate"] = np.tile([[1e-3, 0.0]], (10, 1))
    base = t_vs.simulate_batch(scen, device=CPU, check_every=8)
    got = t_vs.simulate_batch(scen, device=CPU, check_every=check_every)
    for k, v in base.items():
        assert got[k].tobytes() == v.tobytes(), k


def test_rollout_split_over_devices_equals_one_device():
    scen = _planner_batch(seed=4, b=7)               # 7 rows over 3 devices
    one = t_vs.simulate_batch(scen, device=CPU)
    split = t_vs.simulate_batch(scen, devices=[CPU] * 3)
    for k, v in one.items():
        assert split[k].tobytes() == v.tobytes(), k


def test_simulate_batch_counts_its_rounds():
    from repro_torch.obs import observe

    scen = _planner_batch(seed=1, b=4)
    n_steps = t_vs.estimate_steps(scen)
    assert n_steps == j_vs.estimate_steps(scen)
    with observe() as ob:
        t_vs.simulate_batch(scen, device=CPU, check_every=1)
    snap = ob.registry.snapshot()
    assert snap["vector_sim.scenarios"] == 4
    assert 0 < snap["vector_sim.rounds"] < n_steps


def test_allocation_primitives_follow_jnp_clip():
    # jnp.clip(x, lo, hi) with hi < lo returns hi; so must the port's
    x = torch.tensor([[-1.0, 0.5, 3.0]], dtype=torch.float64)
    hi = torch.tensor([[-2.0, 0.25, 5.0]], dtype=torch.float64)
    want = np.asarray(jnp.clip(jnp.asarray(x.numpy()), 0.0,
                               jnp.asarray(hi.numpy())))
    np.testing.assert_array_equal(t_vs._clip(x, 0.0, hi).numpy(), want)
    np.testing.assert_array_equal(
        torch.clamp(x, min=torch.zeros_like(x), max=hi).numpy(), want)
    # torch.round and jnp.round both round half to even
    half = np.array([0.5, 1.5, 2.5, -0.5, -1.5])
    np.testing.assert_array_equal(torch.round(torch.from_numpy(half)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(half))))
    # the batched helpers against the reference's per-row ones under vmap
    rng = np.random.default_rng(0)
    demand = rng.integers(0, 6, (5, 7)).astype(np.float64)
    cap = rng.integers(0, 20, 5).astype(np.float64)
    free = rng.integers(0, 6, (5, 3)).astype(np.float64)
    onehot = np.eye(3)[rng.integers(0, 3, (5, 7))]
    qf = np.tile([0.5, 0.25, 0.25], (5, 1))
    buckets = rng.integers(0, 4, (5, 7, 3)).astype(np.float64)
    t = lambda a: torch.from_numpy(a)
    pairs = [
        (t_vs._prefix(t(demand), t(cap)), jax.vmap(j_vs._prefix)(demand, cap)),
        (t_vs._waterfill(t(demand), t(cap)),
         jax.vmap(j_vs._waterfill)(demand, cap)),
        (t_vs._capacity_fill(t(demand), t(cap), t(onehot), t(qf)),
         jax.vmap(j_vs._capacity_fill)(demand, cap, onehot, qf)),
        (t_vs._by_class(t(demand), t(free)),
         jax.vmap(j_vs._by_class)(demand, free)),
        (t_vs._take_rev(t(demand), t(buckets)),
         jax.vmap(j_vs._take_rev)(demand, buckets)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("values", [
    [], [7.0], [3.0, 1.0, 2.0], [1.0, np.inf, np.inf], [5.0, 5.0, 1.0, 9.0],
    list(np.linspace(0.0, 10.0, 21))])
@pytest.mark.parametrize("q", [0.0, 50.0, 95.0, 100.0])
def test_latency_quantile_matches_the_reference(values, q):
    got = t_vs.latency_quantile(torch.tensor(values, dtype=torch.float64), q)
    want = j_vs.latency_quantile(jnp.asarray(values, dtype=jnp.float64), q)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wave_agrees_with_the_ports_des_contention_free():
    # the reference's own contract, held on the port: serialized and
    # uncontended FIFO rows, and the big/small kill-and-requeue scenario
    # under both preemptive policies, at rtol 1e-3
    tr = T.poisson_trace(T.default_job_classes(), 8, rate=1.0, seed=1)
    for nodes, rate in [(4, 0.002), (64, 0.1)]:
        cc = T.ClusterConfig(num_nodes=nodes)
        des = T.simulate_workload(T.rescale(tr, rate), cc, _clean(T))
        out = T.simulate_batch(scenario_for(T, tr, cc, rate), device=CPU)
        assert out["converged"][0] == 1.0
        np.testing.assert_allclose(out["finish"][0],
                                   [j.finish for j in des.jobs], rtol=1e-3)
    bs = _big_small(T)
    for pol, sched in [(2, "fair_preempt"), (3, "capacity")]:
        cc = T.ClusterConfig(num_nodes=2, scheduler=sched, preempt_timeout=0.0)
        des = T.simulate_workload(bs, cc, _clean(T))
        assert des.num_preempted > 0
        out = T.simulate_batch(scenario_for(T, bs, cc, 1.0, policy=pol,
                                            queue_frac=[0.5, 0.5]), device=CPU)
        np.testing.assert_allclose(out["finish"][0],
                                   [j.finish for j in des.jobs], rtol=1e-3)


@pytest.mark.skipif(has_cuda(), reason="checks the refusal without a card")
def test_entry_points_raise_without_a_card():
    scen = _planner_batch(b=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_vs.simulate_batch(scen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.ClusterEvaluator(n_jobs=4, n_seeds=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_api.get_evaluator("cluster", n_jobs=4, n_seeds=1)


# ---------------------------------------------------------- the evaluator

EV_KW = dict(n_jobs=8, n_seeds=2, chunk=8, base_rate=0.05)


@pytest.fixture(scope="module")
def evaluators():
    return (J.ClusterEvaluator(J.default_job_classes(), **EV_KW),
            T.ClusterEvaluator(T.default_job_classes(), device=CPU, **EV_KW))


def _same_result(got, want):
    for k, w in want.outputs.items():
        np.testing.assert_allclose(got.outputs[k], np.asarray(w), rtol=RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(got.total_cost, np.asarray(want.total_cost),
                               rtol=RTOL)


@pytest.mark.parametrize("overrides", [
    {"pNumNodes": np.array([0.0, 2.0, 4.0, 8.0, 16.0])},
    {"pNumNodes": np.array([4.0, 8.0, 8.0]),
     "schedPolicy": np.array([1.0, 2.0, 3.0]),
     "pNumFastNodes": np.array([0.0, 2.0, 4.0]), "fastSpeedup": 2.0},
    {"pMaxMapsPerNode": np.array([0.0, 2.0]),
     "pNumRacks": np.array([2.0, 4.0]), "crossRackBw": 0.5,
     "oversubscription": 2.0},
    {"arrivalRate": np.array([0.02, 0.1, -1.0]), "schedFair": 1.0,
     "pReduceSlowstart": np.array([0.05, 0.8, 0.5])},
], ids=["nodes", "fleet_policy", "slots_topology", "load"])
def test_cluster_evaluator_matches_the_reference(evaluators, overrides):
    j_ev, t_ev = evaluators
    _same_result(t_ev.evaluate(overrides), j_ev.evaluate(overrides))


def test_cluster_evaluator_search_and_service(evaluators):
    j_ev, t_ev = evaluators
    space = {"pNumNodes": [2.0, 4.0, 8.0], "schedFair": [0.0, 1.0]}
    want = j_search.search_topk(j_ev, space, k=3)
    got = t_search.search_topk(t_ev, space, k=3)
    assert [e.index for e in got.entries] == [e.index for e in want.entries]
    np.testing.assert_allclose([e.cost for e in got.entries],
                               [e.cost for e in want.entries], rtol=RTOL)
    for j_fn, t_fn in [(j_search.grid_search_ev, t_search.grid_search_ev),
                       (j_search.coordinate_descent_ev,
                        t_search.coordinate_descent_ev)]:
        a, b = j_fn(j_ev, space), t_fn(t_ev, space)
        assert b.best_assignment == a.best_assignment
        assert b.evaluations == a.evaluations
        np.testing.assert_allclose(b.best_cost, a.best_cost, rtol=RTOL)
    rows = {"pNumNodes": np.array([2.0, 4.0, 8.0]),
            "schedPolicy": np.array([0.0, 2.0, 3.0])}
    with t_search.WhatIfService(t_ev) as svc:
        answers = [svc.submit(rows).result(timeout=120),
                   svc.probe({"pNumNodes": 6.0}).result(timeout=120)]
    for r in answers:
        seq = t_ev.evaluate(r.overrides)
        assert r.total_cost.tobytes() == seq.total_cost.tobytes()
        for k, v in seq.outputs.items():
            assert r.outputs[k].tobytes() == v.tobytes(), k


def test_cluster_exact_cost_and_errors_match_the_reference(evaluators):
    j_ev, t_ev = evaluators
    for a in ({"pNumNodes": 4.0}, {"pNumNodes": 2.0, "schedPolicy": 2.0},
              {"pNumNodes": 0.0}):
        assert t_ev.exact_cost(a) == j_ev.exact_cost(a)
    with pytest.raises(NotDifferentiableError):
        t_ev.grad_objective()
    with pytest.raises(KeyError, match="unknown config key"):
        t_ev.exact_cost({"pNope": 1.0})
    dead = T.ClusterEvaluator(
        T.default_job_classes(), n_jobs=6, n_seeds=1, chunk=8, base_rate=0.2,
        device=CPU, sim=T.SimConfig(speculative_execution=False,
                                    node_failures=((1.0, 0), (1.0, 1))))
    with pytest.raises(T.UnfinishedWorkloadError, match="never finished"):
        dead.exact_cost({"pNumNodes": 2.0})


def test_api_tune_on_the_cluster_backend_matches_the_reference():
    space = {"pNumNodes": [2.0, 4.0], "schedPolicy": [0.0, 1.0, 2.0]}
    kw = dict(n_jobs=6, n_seeds=1, chunk=8, base_rate=0.05)
    want = j_api.tune("cluster", space, strategy="grid", **kw)
    got = t_api.tune("cluster", space, strategy="grid", device=CPU, **kw)
    assert got.best_assignment == want.best_assignment
    np.testing.assert_allclose(got.best_cost, want.best_cost, rtol=RTOL)
    top = t_api.tune("cluster", space, strategy="topk", k=3, device=CPU, **kw)
    assert top.best().cost == got.best_cost


def test_cluster_evaluator_splits_chunks_over_devices():
    kw = dict(n_jobs=6, n_seeds=2, chunk=6, base_rate=0.05)
    one = T.ClusterEvaluator(T.default_job_classes(), device=CPU, **kw)
    four = T.ClusterEvaluator(T.default_job_classes(), devices=[CPU] * 4, **kw)
    assert four.chunk == 8 and one.chunk == 6
    rows = {"pNumNodes": np.array([2.0, 4.0, 8.0, 3.0, 5.0])}
    a, b = one.evaluate(rows), four.evaluate(rows)
    for k, v in a.outputs.items():
        assert b.outputs[k].tobytes() == v.tobytes(), k


def test_capacity_planning_example_runs_on_the_cpu():
    import runpy
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples/torch_capacity_planning.py"
    main = runpy.run_path(str(path), run_name="example")["main"]
    out = main(["--device", CPU, "--smoke"])
    assert np.isfinite(out["plan"].best_cost)
    assert out["top"].best().cost == out["plan"].best_cost
    assert np.isfinite(out["exact"]) and np.isfinite(out["baseline"])
