"""The port's step-model tuner (``repro_torch.search.tpu``) against the
reference's ``repro.search.tpu`` on the CPU: ``TpuEvaluator.evaluate`` over
``mesh_space(256)`` x ``n_micro`` (every output column and validity mask
equal), the shardability predicates' reasons, ``tune_tpu``'s top 10 in
order, ``api.tune("tpu", ...)`` against the direct call (and ``hw=``), the
refusal of a gradient objective, and the axis names both manifests freeze.
The evaluator is numpy on the host, as in the reference, so equality is
exact.
"""

import json
from pathlib import Path

import numpy as np
import pytest

import repro.api as j_api
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.search import tpu as j_tpu
from repro_torch import api
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.core.tpu_model import TpuCostFactors, TpuParams
from repro_torch.search import NotDifferentiableError, TpuEvaluator, mesh_space, tune_tpu
from repro_torch.search.grid import space_block, space_size
from repro_torch.search.tpu import TPU_AXIS_NAMES

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("compute_s", "memory_s", "collective_s", "total_s", "overlap_s", "valid")


def _evaluators(arch, shape_name, **kw):
    j_kw = dict(kw)
    if "base" in kw:
        j_kw["base"] = j_tpu.TpuParams(**vars(kw["base"]))
    return (TpuEvaluator(get_config(arch), SHAPES[shape_name], **kw),
            j_tpu.TpuEvaluator(j_get_config(arch), J_SHAPES[shape_name], **j_kw))


def _grid(n_chips=256):
    space = mesh_space(n_chips)
    assert space == j_tpu.mesh_space(n_chips)
    return space_block(space, 0, space_size(space))


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_evaluate_over_mesh_space_equals_the_reference(arch, shape_name):
    ev, j_ev = _evaluators(arch, shape_name, n_chips=256)
    cols = _grid()
    got, want = ev.evaluate(cols), j_ev.evaluate(cols)
    for f in FIELDS:
        np.testing.assert_array_equal(got.outputs[f], want.outputs[f], err_msg=f)
    np.testing.assert_array_equal(got.total_cost, want.total_cost)
    assert got.outputs["valid"].any() and not got.outputs["valid"].all()


@pytest.mark.parametrize("arch", ["gemma2-9b", "deepseek-moe-16b", "mamba2-130m"])
def test_swept_ep_remat_and_base_equal_the_reference(arch):
    base = TpuParams(dp=8, tp=32, n_micro=4, remat=False)
    ev, j_ev = _evaluators(arch, "train_4k", base=base, objective="total_s")
    rows = {"tp": [1.0, 8.0, 16.0, 16.0], "ep": [1.0, 1.0, 16.0, 4.0],
            "remat": [0.0, 1.0, 1.0, 0.0], "n_micro": [1.0, 8.0, 2.0, 4.0]}
    got, want = ev.evaluate(rows), j_ev.evaluate(rows)
    for f in FIELDS:
        np.testing.assert_array_equal(got.outputs[f], want.outputs[f], err_msg=f)
    np.testing.assert_array_equal(got.total_cost, want.total_cost)


@pytest.mark.parametrize("n_chips", [None, 256, 512])
def test_predicate_reasons_equal_the_reference(n_chips):
    ev, j_ev = _evaluators("granite-3-8b", "prefill_32k", n_chips=n_chips)
    ps, j_ps = ev.param_space, j_ev.param_space
    assert list(ps.names) == list(j_ps.names) == list(TPU_AXIS_NAMES)
    assert [(p.name, p.doc) for p in ps.predicates] == \
        [(p.name, p.doc) for p in j_ps.predicates]
    cols = {**_grid(), "remat": 1.0, "ep": 1.0}
    cols = {k: np.broadcast_to(np.asarray(v, dtype=np.float64), cols["dp"].shape)
            for k, v in cols.items()}
    ok, reasons = ps.validity_mask(cols)
    j_ok, j_reasons = j_ps.validity_mask(cols)
    np.testing.assert_array_equal(ok, j_ok)
    assert set(reasons) == set(j_reasons)
    for name in reasons:
        np.testing.assert_array_equal(reasons[name], j_reasons[name], err_msg=name)


def _top(res):
    return [(e.cost, dict(e.assignment)) for e in res.entries]


@pytest.mark.parametrize("arch,shape_name", [("starcoder2-7b", "train_4k"),
                                             ("gemma2-9b", "train_4k"),
                                             ("granite-3-8b", "train_4k"),
                                             ("moonshot-v1-16b-a3b", "train_4k"),
                                             ("recurrentgemma-9b", "decode_32k"),
                                             ("seamless-m4t-large-v2", "prefill_32k")])
def test_tune_tpu_top10_equals_the_reference(arch, shape_name):
    got = tune_tpu(get_config(arch), SHAPES[shape_name])
    want = j_tpu.tune_tpu(j_get_config(arch), J_SHAPES[shape_name])
    assert len(got.entries) == 10
    assert _top(got) == _top(want)
    h100 = tune_tpu(get_config(arch), SHAPES[shape_name],
                    costs=TpuCostFactors.for_hw("h100_sxm"))
    assert len(h100.entries) == 10 and np.isfinite([e.cost for e in h100.entries]).all()


def test_api_tune_tpu_equals_the_direct_call():
    cfg, shape = get_config("gemma2-9b"), SHAPES["train_4k"]
    space = mesh_space(256)
    direct = tune_tpu(cfg, shape)
    via = api.tune("tpu", space, strategy="topk", k=10, exact_fallback=False,
                   cfg=cfg, shape=shape, n_chips=256)
    assert _top(via) == _top(direct)
    j_via = j_api.tune("tpu", space, strategy="topk", k=10, exact_fallback=False,
                       cfg=j_get_config("gemma2-9b"), shape=J_SHAPES["train_4k"],
                       n_chips=256)
    assert _top(via) == _top(j_via)
    # hw= picks the hardware table; it and costs= exclude each other
    h = api.tune("tpu", space, strategy="topk", k=10, exact_fallback=False,
                 cfg=cfg, shape=shape, n_chips=256, hw="h100_sxm")
    assert _top(h) == _top(tune_tpu(cfg, shape, costs=TpuCostFactors.for_hw("h100_sxm")))
    assert api.get_evaluator("tpu", cfg=cfg, shape=shape, hw="h100_sxm").costs == \
        TpuCostFactors.for_hw("h100_sxm")
    with pytest.raises(TypeError, match="not both"):
        api.get_evaluator("tpu", cfg=cfg, shape=shape, hw="h100_sxm",
                          costs=TpuCostFactors())
    best = api.tune("tpu", space, cfg=cfg, shape=shape, n_chips=256,
                    exact_fallback=False)
    assert best.best_cost == direct.entries[0].cost


def test_grad_objective_raises():
    ev, _ = _evaluators("stablelm-1.6b", "train_4k")
    with pytest.raises(NotDifferentiableError, match="no differentiable relaxation"):
        ev.grad_objective()


def test_axis_names_equal_both_manifests():
    port = json.loads((ROOT / "src/repro_torch/spec/manifest.json").read_text())
    ref = json.loads((ROOT / "src/repro/spec/manifest.json").read_text())
    assert list(TPU_AXIS_NAMES) == port["axes"]["tpu"] == ref["axes"]["tpu"] \
        == list(j_tpu.TPU_AXIS_NAMES)
    assert "tpu" in api.available_models()
