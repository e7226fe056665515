"""The port's serving step factories and dry-run against the reference, on
the CPU at smoke width (``.smoke()`` configs, fp32, a few tokens):

* ``make_prefill_step`` / ``make_decode_step`` against the reference's
  ``repro.launch.steps`` on the same weights (``from_jax_params``), logits
  within 1e-4, for a dense, a MoE and the enc-dec config;
* ``run_cell`` on a (4, 2) mesh of fake ranks for train, prefill and
  decode: ``ok``, and no process group left open;
* its argument bytes a device equal the arithmetic over the reference's own
  partition specs and ``jax.eval_shape`` tree (no compile; the configs are
  fp32, so both packages store every leaf in fp32);
* its FLOPs at a 1 x 1 mesh against the reference's
  ``hlo_totals(jit(step).lower(...).compile().as_text())["dot_flops"]``:
  within 5 % for prefill and decode (equal, in fact).  For train the port
  counts more: ``torch.utils.checkpoint`` recomputes each layer's whole
  forward (its ``mm`` and ``bmm``) in the backward, where XLA keeps only
  part of the reference's rematerialised scan group; the reference's count
  lies between the port's without remat and with it, and the ratio is
  printed;
* every preset traces (a flag ``set_flags`` refuses would come back
  ``skip(...)``); the ``inplace-cache`` presets' cells equal their
  ``baseline`` and ``moe-shardmap`` twins; nothing is written under
  ``artifacts/dryrun``;
* the census holds a serving step's parameters once (the gathered module)
  and a train step's arguments and module both;
* ``dryrun_mapreduce`` at a small size: the all-to-all bytes are the
  arithmetic, and Eq. 90's prediction equals the reference's.

The reference's ``repro/launch/dryrun*.py`` set ``XLA_FLAGS`` when imported,
so this file reads them as text and never imports them.
"""

import ast
import functools
import math
import os
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as j_get_config
from repro.configs import shapes as j_shapes
from repro.core.hadoop import params as j_params
from repro.core.hadoop import ref as j_ref
from repro.core.roofline import hlo_totals as j_hlo_totals
from repro.launch import sharding as j_shd
from repro.launch import steps as j_steps
from repro.models import encdec as j_ed
from repro.models import lm as j_lm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun, dryrun_mapreduce, steps
from repro_torch.launch.mesh import world
from repro_torch.models.encdec import EncDec
from repro_torch.models.lm import LM
from repro_torch.models.opt_flags import OptFlags
from repro_torch.models.weights import from_jax_params

ROOT = Path(__file__).resolve().parents[1]
DENSE, MOE, ENCDEC = "gemma2-9b", "deepseek-moe-16b", "seamless-m4t-large-v2"
TOL = dict(rtol=1e-4, atol=1e-4)
MESH = {"data": 4, "model": 2}
ONE = {"data": 1, "model": 1}
KINDS = {"train": (32, 8), "prefill": (32, 8), "decode": (32, 8)}


def _shape(kind):
    S, B = KINDS[kind]
    return ShapeSpec(kind, S, B, kind), j_shapes.ShapeSpec(kind, S, B, kind)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x)


# -------------------------------------------------------- the step factories

@pytest.mark.parametrize("name", [DENSE, MOE, ENCDEC])
def test_step_factories_match_the_reference(name):
    cfg, j_cfg = get_config(name).smoke(), j_get_config(name).smoke()
    init_fn = j_ed.init_encdec if cfg.is_encdec else j_lm.init
    params = jax.tree.map(np.asarray, init_fn(jax.random.PRNGKey(3), j_cfg))
    model = from_jax_params(cfg, params, device="cpu")
    rng = np.random.default_rng(4)
    B, P, max_len = 2, 12, 24
    prompt = rng.integers(0, cfg.vocab_size, (B, P))
    toks = rng.integers(0, cfg.vocab_size, (3, B, 1))
    batch = {"inputs": prompt}
    if cfg.is_encdec:
        batch["src_embeds"] = rng.standard_normal((B, 16, cfg.d_model), dtype=np.float32)
    j_pre = jax.jit(j_steps.make_prefill_step(j_cfg, max_len=max_len))
    j_dec = jax.jit(j_steps.make_decode_step(j_cfg))
    pre, dec = steps.make_prefill_step(cfg, max_len=max_len), steps.make_decode_step(cfg)

    want = j_pre(params, {k: jnp.asarray(v) for k, v in batch.items()})
    got = pre(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want) == {"logits", "caches", "pos"}
    np.testing.assert_allclose(_np(got["logits"]), np.asarray(want["logits"]), **TOL)
    assert int(got["pos"]) == int(want["pos"]) == P
    j_caches, j_pos, caches, pos = want["caches"], want["pos"], got["caches"], got["pos"]
    for tok in toks:
        w = j_dec(params, {"token": jnp.asarray(tok, jnp.int32), "caches": j_caches,
                           "pos": j_pos})
        g = dec(model, {"token": torch.from_numpy(tok), "caches": caches, "pos": pos})
        assert set(g) == set(w) == {"logits", "caches"}
        np.testing.assert_allclose(_np(g["logits"]), np.asarray(w["logits"]), **TOL)
        j_caches, caches = w["caches"], g["caches"]
        j_pos, pos = j_pos + 1, pos + 1


# ------------------------------------------------------------------ run_cell

@pytest.fixture(scope="module")
def cells():
    """run_cell at smoke width on (4, 2) and (1, 1) meshes of fake ranks."""
    out = {}
    for name in (DENSE, MOE, ENCDEC):
        for kind in KINDS:
            for label, mesh in (("4x2", MESH), ("1x1", ONE)):
                out[name, kind, label] = dryrun.run_cell(
                    get_config(name).smoke(), _shape(kind)[0], False, mesh=mesh)
    return out


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("name", [DENSE, MOE, ENCDEC])
def test_run_cell_on_a_fake_mesh_is_ok_and_closes_its_group(cells, name, kind):
    cell = cells[name, kind, "4x2"]
    assert cell["status"] == "ok", cell["status"]
    assert not dist.is_initialized()
    assert (cell["mesh"], cell["chips"], cell["hw"]) == ("4x2", 8, "tpu_v5e")
    assert cell["flops_source"] == "FlopCounterMode"
    assert cell["tp_compute"] == "model"
    for key in ("memory", "cost", "collectives", "roofline"):
        assert key in cell
    r = cell["roofline"]
    assert r["model_flops"] > 0 and r["bound"] in ("compute", "memory", "collective")
    for term in ("compute_s", "memory_s", "collective_s"):
        assert math.isfinite(r[term]) and r[term] > 0, term
    mem = cell["memory"]
    assert 0 < mem["argument_size_in_bytes"] < mem["peak_memory_in_bytes"]
    # every rank gathers its model shards of the parameters over the data
    # axis: all-gathers; the compute over the model axis all-reduces (the
    # row-parallel outputs), and a train step its gradients over the 4 data
    # ranks
    kinds = set(cell["collectives"]["by_kind"])
    assert kinds == {"all-gather", "all-reduce"}
    # one device runs no collective
    assert cells[name, kind, "1x1"]["collectives"]["total_bytes"] == 0.0


def _duck(mesh):
    return SimpleNamespace(axis_names=tuple(mesh), devices=np.empty(tuple(mesh.values())))


def _ref_local_bytes(spec_tree, shape_tree, sizes):
    total = 0
    leaves = jax.tree.leaves(shape_tree)
    specs = jax.tree.leaves(spec_tree, is_leaf=lambda x: isinstance(x, j_shd.P))
    assert len(leaves) == len(specs)
    for leaf, spec in zip(leaves, specs):
        n = np.dtype(leaf.dtype).itemsize
        for d, size in enumerate(leaf.shape):
            entry = spec[d] if d < len(spec) else None
            axes = entry if isinstance(entry, tuple) else (entry,)
            n *= -(-size // math.prod(sizes[a] for a in axes if a is not None))
        total += n
    return total


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("name", [DENSE, MOE, ENCDEC])
def test_argument_bytes_equal_the_reference_arithmetic(cells, name, kind):
    j_cfg = j_get_config(name).smoke()
    shape, j_shape = _shape(kind)
    mesh = _duck(MESH)
    params = jax.eval_shape(functools.partial(j_steps.init_params, cfg=j_cfg),
                            jax.random.PRNGKey(0))
    specs = j_shapes.input_specs(j_cfg, j_shape)
    want = _ref_local_bytes(j_shd.param_pspecs(j_cfg, params, mesh), params, MESH)
    want += _ref_local_bytes(j_shd.input_pspecs(j_cfg, j_shape, specs, mesh), specs, MESH)
    if kind == "train":
        opt = jax.eval_shape(j_adamw_init, params)
        want += _ref_local_bytes(j_shd.opt_pspecs(j_cfg, opt, mesh), opt, MESH)
    # the port's enc-dec caches also carry ``cross_pos`` (one int32, made at
    # prefill so that a captured decode step makes no tensor from a host int)
    extra = 4 if (kind == "decode" and j_cfg.is_encdec) else 0
    assert cells[name, kind, "4x2"]["memory"]["argument_size_in_bytes"] == want + extra


@functools.lru_cache(maxsize=None)
def _ref_dot_flops(name, kind, n_micro):
    j_cfg = j_get_config(name).smoke()
    _, j_shape = _shape(kind)
    params = jax.eval_shape(functools.partial(j_steps.init_params, cfg=j_cfg),
                            jax.random.PRNGKey(0))
    specs = j_shapes.input_specs(j_cfg, j_shape)
    if kind == "train":
        step = j_steps.make_train_step(j_cfg, JAdamWConfig(), n_micro)
        lowered = jax.jit(step).lower(params, jax.eval_shape(j_adamw_init, params), specs)
    else:
        step = (j_steps.make_prefill_step(j_cfg, max_len=j_shape.seq_len)
                if kind == "prefill" else j_steps.make_decode_step(j_cfg))
        lowered = jax.jit(step).lower(params, specs)
    return j_hlo_totals(lowered.compile().as_text())["dot_flops"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("name", [DENSE, MOE, ENCDEC])
def test_serving_flops_at_one_device_match_the_reference_hlo(cells, name, kind):
    got = cells[name, kind, "1x1"]["cost"]["flops"]
    want = _ref_dot_flops(name, kind, 1)
    assert abs(got / want - 1) < 0.05, (got, want)


@pytest.mark.parametrize("name", [DENSE, MOE, ENCDEC])
def test_train_flops_beside_the_reference_hlo(cells, name, monkeypatch):
    cell = cells[name, "train", "1x1"]
    got = cell["cost"]["flops"]
    want = _ref_dot_flops(name, "train", cell["n_microbatches"])
    for cls in (LM, EncDec):
        loss_fn = cls.loss_fn
        monkeypatch.setattr(cls, "loss_fn",
                            lambda self, b, f=loss_fn, **kw: f(self, b, remat=False))
    no_remat = dryrun.run_cell(get_config(name).smoke(), _shape("train")[0], False,
                               mesh=ONE)["cost"]["flops"]
    print(f"{name} train FLOPs: port {got:.4g} (no remat {no_remat:.4g}), reference HLO "
          f"{want:.4g}; port / reference {got / want:.3f}")
    assert no_remat < got
    assert no_remat <= want * 1.05 and want <= got


def test_refused_presets_come_back_skipped():
    cfg, (shape, _) = get_config(MOE).smoke(), _shape("train")
    # the port takes every flag of the reference's presets: cache_update is
    # what its decode step already does, and since the compute splits over
    # model (ROADMAP.md item 24) the shardmap presets trace
    for opt in ("inplace-cache", "inplace-cache+moe", "moe-shardmap", "moe-shardmap+flash"):
        cell = dryrun.run_cell(cfg, shape, False, opt=opt, mesh=MESH)
        assert cell["status"] == "ok" and cell["tp_compute"] == "model", cell["status"]
    assert not dist.is_initialized()
    # a preset the port takes traces on the production mesh's refactoring
    cell = dryrun.run_cell(cfg, shape, False, opt="moe-gather+dp64+loss")
    assert (cell["status"], cell["mesh"], cell["chips"]) == ("ok", "64x4", 256)
    # a flag set_flags refuses comes back skipped
    refused = OptFlags(bf16_collectives=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(dryrun.OPT_PRESETS, "bf16-collectives", refused)
        cell = dryrun.run_cell(cfg, shape, False, opt="bf16-collectives", mesh=MESH)
    assert cell["status"].startswith("skip(opt bf16-collectives:"), cell["status"]
    assert "not read by the port" in cell["status"]
    # the reference's skip rule
    long = ShapeSpec("long_500k", 524_288, 1, "decode")
    assert dryrun.run_cell(get_config(DENSE).smoke(), long, False, mesh=MESH)[
        "status"].startswith("skip(") or get_config(DENSE).supports_long_context


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("opt,twin", [("inplace-cache", "baseline"),
                                      ("inplace-cache+moe", "moe-shardmap")])
def test_inplace_cache_presets_equal_their_twins(opt, twin, kind):
    """cache_update="inplace" selects what the port already does, so each
    preset's cell is its twin's but for the preset's name and trace time."""
    cfg, shape = get_config(MOE).smoke(), _shape(kind)[0]
    got, want = (dryrun.run_cell(cfg, shape, False, opt=o, mesh=MESH) for o in (opt, twin))
    assert got["status"] == "ok", got["status"]
    drop = ("opt", "trace_s")
    assert ({k: v for k, v in got.items() if k not in drop}
            == {k: v for k, v in want.items() if k not in drop})


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("name", [DENSE, MOE, ENCDEC])
def test_census_counts_the_parameters_once(cells, name, kind):
    """A decode step copies the placed parameters into its module and then
    holds only the module: at one device what it holds above its arguments
    is its transients, a small part of the parameters.  A train step holds
    its arguments and the gathered module both."""
    mem = cells[name, kind, "1x1"]["memory"]
    above = mem["peak_memory_in_bytes"] - mem["argument_size_in_bytes"]
    if kind == "train":
        assert above >= mem["gathered_module_bytes"], mem
    else:
        assert 0 < above < mem["gathered_module_bytes"] / 4, mem


def test_presets_are_the_reference_names():
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    names = next(node.value for node in ast.walk(tree)
                 if isinstance(node, ast.AnnAssign)
                 and getattr(node.target, "id", "") == "OPT_PRESETS")
    want = [ast.literal_eval(k) for k in names.keys]
    assert list(dryrun.OPT_PRESETS) == want and len(want) == 25


def test_refuses_an_open_process_group():
    with world(device="cpu"):
        with pytest.raises(RuntimeError, match="already open"):
            dryrun.run_cell(get_config(DENSE).smoke(), _shape("decode")[0], False,
                            mesh=ONE)
    assert not dist.is_initialized()


def test_main_writes_its_own_directory_only(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert dryrun.DEFAULT_OUT == os.path.join("artifacts", "dryrun_torch")
    with pytest.raises(SystemExit, match="reference"):
        dryrun.main(["--out", "artifacts/dryrun"])
    dryrun.main(["--arch", "mamba2-130m", "--shape", "decode_32k", "--mesh", "single"])
    assert not (tmp_path / "artifacts" / "dryrun").exists()
    written = sorted(p.name for p in (tmp_path / "artifacts" / "dryrun_torch").iterdir())
    assert written == ["mamba2-130m__decode_32k__single.json",
                       "mamba2-130m__decode_32k__single.ops.json.gz"]
    assert not dist.is_initialized()


def test_mapreduce_shuffle_bytes_and_eq90():
    pairs, keys = 256, 1024
    out = dryrun_mapreduce.run(pairs, keys)
    assert out["status"] == "ok" and out["pairs"] == pairs * 16
    # each rank sends its dense (16, key_space / 16) fp32 blocks; the
    # reducers' blocks are gathered back in rank order
    assert out["collectives"]["by_kind"] == {"all-to-all": keys * 4.0,
                                             "all-gather": keys * 4.0}
    hp = j_params.HadoopParams(pNumNodes=16, pNumMappers=16, pNumReducers=16,
                               pSplitSize=pairs * 12.0, pUseCombine=True)
    st = j_params.ProfileStats(sInputPairWidth=12.0, sMapPairsSel=4.0, sMapSizeSel=4.0,
                               sCombinePairsSel=0.25, sCombineSizeSel=0.25)
    want = j_ref.job_model(hp, st, j_params.CostFactors()).netTransferSize
    assert out["paper_eq90_net_bytes"] == want
    assert not dist.is_initialized()
