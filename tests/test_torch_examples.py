"""The six example twins of the main path (``examples/torch_*.py``), each
run shortened (``main(["--device", "cpu", "--smoke"])``) and held against
the reference's library calls on the same inputs.  The reference's own
scripts do their work at import, so they are not run.

* ``torch_quickstart``: the closed-form job model equal to the reference's
  (the same pure-Python oracle), the engine's counters and profile equal
  to the reference engine's on the same records;
* ``torch_job_tuning``: on the twin's measured profile and fitted factors,
  the reference's evaluator, coordinate descent, grid search, service and
  task simulator give the same answers (costs at rtol 1e-9);
* ``torch_phase_whatif``: the report, the tuned configuration, the sweep
  and both phase queries equal to ``repro.api``'s (rtol 1e-9);
* ``torch_calibrate_and_tune``: on the twin's observations, the
  reference's ``api.calibrate`` (fitted values at rtol 1e-6, as
  ``tests/test_torch_calib.py`` holds them) and both tunings;
* ``torch_serve_requests``: the reference ``Server`` on the twin's weights
  gives the same greedy tokens and the same serving counters;
* ``torch_train_e2e``: the reference's parameter count, the first loss
  equal to the reference's ``loss_fn`` on the same weights and batch (rtol
  1e-5), and the resumed run equal bit for bit to the uninterrupted one;
* ``torch_tpu_tuning`` (``--smoke``): its ranking equal to the ranking of
  the reference's ``examples/tpu_tuning.py``, whose work at import is the
  step model's arithmetic, so it runs here.
"""

import dataclasses
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as j_api
from repro.calib import Observation as JObservation
from repro.configs import get_config as j_get_config
from repro.core.hadoop import ref as j_ref
from repro.core.hadoop import params as j_params
from repro.core.hadoop.simulator import simulate_job as j_simulate_job
from repro.mapreduce import JOBS as J_JOBS
from repro.mapreduce import MapReduceEngine as JMapReduceEngine
from repro.mapreduce import make_input as j_make_input
from repro.mapreduce.profiler import profile_job as j_profile_job
from repro.models import lm as j_lm
from repro.runtime.serve_loop import Request as JRequest
from repro.runtime.serve_loop import Server as JServer
from repro.search import ChunkedEvaluator as JChunkedEvaluator
from repro.search import WhatIfService as JWhatIfService
from repro.search import coordinate_descent_ev as j_coordinate_descent_ev
from repro.search import grid_search_ev as j_grid_search_ev
from repro.spec import JobSpec as JJobSpec
from repro_torch.launch.steps import init_params
from repro_torch.models.weights import jax_leaf_names

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
SMOKE = ["--device", "cpu", "--smoke"]
RTOL = 1e-9


def _example(name):
    return runpy.run_path(str(EXAMPLES / f"torch_{name}.py"), run_name="example")


def _j(obj, cls):
    """A port dataclass (HadoopParams, ProfileStats, CostFactors) as the
    reference's."""
    return cls(**dataclasses.asdict(obj))


def _j_spec(spec):
    return JJobSpec(params=_j(spec.params, j_params.HadoopParams),
                    stats=_j(spec.stats, j_params.ProfileStats),
                    costs=_j(spec.costs, j_params.CostFactors))


def _to_reference(cfg, j_cfg, model):
    """The port's parameters in the reference's pytree (groups restacked)."""
    shapes = jax.eval_shape(lambda k: j_lm.init(k, j_cfg), jax.random.PRNGKey(0))
    leaves, treedef = jax.tree.flatten(shapes)

    class Slot:
        def __init__(self, i, g=None):
            self.i, self.g, self.shape = i, g, leaves[i].shape

        def __getitem__(self, g):
            return Slot(self.i, g)

    slots = jax_leaf_names(cfg, jax.tree.unflatten(
        treedef, [Slot(i) for i in range(len(leaves))]))
    parts: dict[int, dict] = {}
    for name, p in model.named_parameters():
        s = slots[name]
        parts.setdefault(s.i, {})[s.g] = p.detach().float().numpy()
    out = []
    for i, leaf in enumerate(leaves):
        got = parts[i]
        arr = got[None] if None in got else np.stack([got[g] for g in range(len(got))])
        assert arr.shape == leaf.shape, (i, arr.shape, leaf.shape)
        out.append(jnp.asarray(arr, leaf.dtype))
    return jax.tree.unflatten(treedef, out)


# ------------------------------------------------------------------ quickstart

def test_quickstart_twin_matches_reference():
    mod = _example("quickstart")
    out = mod["main"](SMOKE)
    hp = _j(mod["HP"], j_params.HadoopParams)
    stats = _j(mod["STATS"], j_params.ProfileStats)
    assert out["total"] == j_ref.job_model(hp, stats, j_params.CostFactors()).totalCost
    for sort_mb, (spills, total) in out["whatif"].items():
        w = j_ref.job_model(hp.replace(pSortMB=sort_mb), stats, j_params.CostFactors())
        assert (spills, total) == (w.map.numSpills, w.totalCost)
    assert out["best"] == min(
        (j_ref.job_model(hp.replace(pNumReducers=r), stats, j_params.CostFactors())
         .totalCost, r) for r in (4, 8, 16, 32, 64))
    job = J_JOBS["wordcount"]
    hp_small = _j(out["hp_small"], j_params.HadoopParams)
    keys, values = j_make_input(job, out["n"])
    jc = JMapReduceEngine(hp_small, job).run_job(keys, values)
    for a, b in zip(out["jc"].maps, jc.maps):
        assert (a.numSpills, a.spillBufferPairs, a.numMergePasses) == \
            (b.numSpills, b.spillBufferPairs, b.numMergePasses)
    want = j_profile_job(jc, job, hp_small)
    for f, v in dataclasses.asdict(want).items():
        np.testing.assert_allclose(getattr(out["measured"], f), v, rtol=1e-12, err_msg=f)


# ------------------------------------------------------------------ job tuning

def test_job_tuning_twin_matches_reference():
    mod = _example("job_tuning")
    out = mod["main"](SMOKE)
    hp0 = _j(out["hp0"], j_params.HadoopParams)
    stats = _j(out["stats"], j_params.ProfileStats)
    costs = _j(out["costs"], j_params.CostFactors)
    ev = JChunkedEvaluator(hp0, stats, costs, chunk=1 << 10)
    tuned = j_coordinate_descent_ev(ev, mod["SPACE"])
    exhaustive = j_grid_search_ev(ev, mod["SPACE"])
    assert out["tuned"].best_assignment == tuned.best_assignment
    np.testing.assert_allclose(out["tuned"].best_cost, tuned.best_cost, rtol=RTOL)
    assert out["tuned"].evaluations == tuned.evaluations
    np.testing.assert_allclose(out["exhaustive"].best_cost, exhaustive.best_cost, rtol=RTOL)
    with JWhatIfService(ev) as svc:
        futures = {label: mod["ask"](svc, kind, a)
                   for label, (kind, a) in mod["queries"](tuned.best_assignment).items()}
        answers = {label: f.result() for label, f in futures.items()}
    for label, r in answers.items():
        got = out["answers"][label].best()
        want = r.best()
        np.testing.assert_allclose(got[1], want[1], rtol=RTOL, err_msg=label)
        assert got[2] == want[2], label
    sim_hp = _j(out["tuned"].apply(out["hp0"]), j_params.HadoopParams).replace(
        pNumNodes=8, pNumMappers=64, pNumReducers=16)
    for label, sc in mod["SIMS"]:
        from repro.core.hadoop.simulator import SimConfig as JSimConfig

        want = j_simulate_job(sim_hp, stats, costs, JSimConfig(**dataclasses.asdict(sc)))
        got = out["sims"][label]
        assert got.makespan == want.makespan, label
        assert (got.num_speculative_launched, got.num_failure_reruns) == \
            (want.num_speculative_launched, want.num_failure_reruns)


# ------------------------------------------------------------------ phase what-if

def test_phase_whatif_twin_matches_reference():
    mod = _example("phase_whatif")
    out = mod["main"](SMOKE)
    spec = _j_spec(out["spec"])
    rep = j_api.model(spec, {"pSortMB": 100.0, "pSortFactor": 10.0})
    for phase in type(rep.phases).names():
        np.testing.assert_allclose(np.asarray(out["report"].phases[phase]),
                                   np.asarray(rep.phases[phase]), rtol=RTOL, err_msg=phase)
    np.testing.assert_allclose(np.asarray(out["report"].total_cost),
                               np.asarray(rep.total_cost), rtol=RTOL)
    tuned = j_api.tune(spec, out["space"], strategy="descent")
    assert out["tuned"].best_assignment == tuned.best_assignment
    np.testing.assert_allclose(out["tuned"].best_cost, tuned.best_cost, rtol=RTOL)
    swept = j_api.sweep(spec, out["grid"])
    np.testing.assert_allclose(np.asarray(out["swept"].total_cost),
                               np.asarray(swept.total_cost), rtol=RTOL)
    budget = float(np.percentile(np.asarray(swept.total_cost), 40))
    np.testing.assert_allclose(out["budget"], budget, rtol=RTOL)
    with j_api.serve(spec) as svc:
        best = svc.phase_query(out["grid"], phase="shuffle", total_max=budget).result().best()
        free = svc.phase_query(out["grid"], phase="shuffle").result().best()
    for got, want in ((out["best"], best), (out["unconstrained"], free)):
        np.testing.assert_allclose(got[1], want[1], rtol=RTOL)
        assert got[2] == want[2]


# ------------------------------------------------------------- calibrate + tune

def test_calibrate_and_tune_twin_matches_reference():
    mod = _example("calibrate_and_tune")
    out = mod["main"](SMOKE)
    obs = [JObservation(spec=_j_spec(o.spec), cost=o.cost) for o in out["observations"]]
    report = j_api.calibrate(obs, steps=out["steps"])
    assert set(out["report"].fitted) == set(report.fitted)
    for k, v in report.fitted.items():
        np.testing.assert_allclose(out["report"].fitted[k], v, rtol=1e-6, err_msg=k)
    spec = _j_spec(out["spec"])
    for strategy, got in (("gradient", out["grad"]), ("descent", out["coord"])):
        want = j_api.tune(spec, mod["SPACE"], strategy=strategy)
        np.testing.assert_allclose(got.best_cost, want.best_cost, rtol=1e-6)
        for k, v in want.best_assignment.items():
            np.testing.assert_allclose(got.best_assignment[k], v, rtol=1e-6, err_msg=k)


# ------------------------------------------------------------------ serving

def test_serve_requests_twin_matches_reference():
    out = _example("serve_requests")["main"](SMOKE)
    cfg = out["cfg"]
    j_cfg = j_get_config("gemma2-9b").smoke()
    server = JServer(j_cfg, _to_reference(cfg, j_cfg, out["model"]), max_len=128)
    reqs = [JRequest(rid=r.rid, prompt=list(r.prompt), max_new_tokens=r.max_new_tokens)
            for r in out["done"]]
    server.generate(reqs)
    assert [len(r.generated) for r in out["done"]] == [len(r.generated) for r in reqs]
    assert out["stats"] == dict(server.stats)     # both read before the batch
    want = server.throughput_batch(out["prompts"], new_tokens=out["new_tokens"])
    np.testing.assert_array_equal(np.asarray(out["batch"]["output"]),
                                  np.asarray(want["output"]))


# ------------------------------------------------------------------ training

@pytest.fixture
def e2e(tmp_path):
    mod = _example("train_e2e")
    return mod, mod["main"](SMOKE + ["--ckpt-dir", str(tmp_path / "ckpt"),
                                     "--log", str(tmp_path / "log.jsonl")])


def test_train_e2e_twin_resumes_bit_for_bit_and_matches_reference(e2e):
    mod, out = e2e
    assert out["equal"] and out["resumed_at"] == 4
    assert [r["step"] for r in out["out"]["log"]][-1] == out["steps"] - 1
    for k, p in out["uninterrupted"]["params"].items():
        assert torch.equal(out["out"]["params"][k], p), k
    cfg = out["cfg"]
    j_cfg = j_get_config("granite-3-8b").replace(
        name="granite-13m", n_layers=4, d_model=256, n_heads=8, n_kv_heads=4,
        head_dim=32, d_ff=1024, vocab_size=2048, dtype="float32")
    shapes = jax.eval_shape(lambda k: j_lm.init(k, j_cfg), jax.random.PRNGKey(0))
    assert out["n_params"] == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    # the first logged loss against the reference's loss_fn on the same
    # initial weights (the Trainer's seed) and batch
    model = init_params(torch.Generator().manual_seed(0), cfg, device="cpu",
                        param_dtype=torch.float32)
    from repro.data import PipelineConfig as JPipelineConfig
    from repro.data import TokenPipeline as JTokenPipeline

    batch = JTokenPipeline(JPipelineConfig(vocab_size=2048, seq_len=64,
                                           global_batch=8)).batch(0)
    loss, _ = j_lm.loss_fn(_to_reference(cfg, j_cfg, model), j_cfg,
                           {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(out["first_log"][0]["loss"], float(loss), rtol=1e-5)


def test_tpu_tuning_twin_ranks_as_the_reference_example(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)       # neither script finds dry-run artifacts
    ref = runpy.run_path(str(EXAMPLES / "tpu_tuning.py"), run_name="example")
    out = _example("tpu_tuning")["main"](["--smoke"])
    assert list(out) == ["starcoder2-7b"]
    rows = out["starcoder2-7b"]["rows"]
    assert rows == ref["tune"]("starcoder2-7b", "train_4k")
    assert len(rows) == 10 and out["starcoder2-7b"]["measured"] == {}
    h100 = _example("tpu_tuning")["main"](["--smoke", "--hw", "h100_sxm"])
    assert [r[0] for r in h100["starcoder2-7b"]["rows"]] != [] and \
        h100["starcoder2-7b"]["rows"] != rows
