"""The port's Trainer, checkpoints, stragglers and cross-pod compression
against the JAX package, on the CPU.

* The twins of the 15 tests of ``tests/test_fault_tolerance.py``:
  checkpoint round trip, keep-N, CRC skip, async save, invisible partial
  writes, bf16 and int leaves; the kill at step 12 resumed to 20 equal bit
  for bit to an uninterrupted run; elastic restore onto DTensor
  placements; the stateless pipeline; straggler detection and the LATE
  heuristic; ``crosspod_reduce`` (unchanged without a pod axis, and int8
  and bf16 on two gloo ranks).
* Checkpoints read across the two packages both ways, bf16 and int leaves
  included, and the reference Trainer's own checkpoint read by the port.
* The Trainer against the reference Trainer: both start from the
  reference's initial parameters and AdamW state (the reference's run of 0
  steps writes them; the port reads that checkpoint and carries it into
  its own layout), then train stablelm-1.6b ``.smoke()`` at global batch
  4, seq 32: losses at rtol 1e-5, every parameter within a tenth of the
  learning rate (``tests/test_torch_training.py``'s tolerances).
* At one rank the Trainer's step is ``make_train_step``'s bit for bit.
* One spawned gloo world of 2 ranks (subprocess, ``timeout=``): dp 2
  against dp 1, an elastic resume of a world-of-1 checkpoint onto dp 2
  placements, and ``crosspod_reduce`` int8 and bf16.
* ``TrainerConfig(grad_compression=...)`` and ``set_flags`` refuse what no
  reference code reads, naming why; ``compress_grads`` and the straggler
  detector are pinned to the reference.
"""

import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_config as j_get_config
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import compress as j_compress
from repro.runtime import StragglerDetector as JStragglerDetector
from repro.runtime import Trainer as JTrainer
from repro.runtime import TrainerConfig as JTrainerConfig
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import PipelineConfig, TokenPipeline
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh, make_mesh, make_production_mesh, world
from repro_torch.models import opt_flags
from repro_torch.models.weights import jax_leaf_names
from repro_torch.optim import AdamWConfig, compress
from repro_torch.runtime import StragglerDetector, Trainer, TrainerConfig, should_speculate
from repro_torch.runtime.crosspod import crosspod_reduce

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
LR = 1e-3


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((8, 16), generator=g),
            "nested": {"b": torch.arange(5, dtype=torch.int32)}}


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


def _tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _tree_equal(a[k], b[k])
    else:
        _equal(a, b)


# ------------------------------------------------------------- checkpoints

def test_checkpoint_roundtrip(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    cm.save(3, t)
    restored, manifest = cm.restore(t)
    assert manifest["step"] == 3
    _tree_equal(t, restored)


def test_checkpoint_keep_n_and_latest(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, _tree(s))
    assert cm.all_steps() == [3, 4]
    _, manifest = cm.restore(_tree())
    assert manifest["step"] == 4


def test_checkpoint_skips_corrupt(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=5)
    cm.save(1, _tree(1))
    cm.save(2, _tree(2))
    # corrupt the newest checkpoint's first leaf (sorted keys: nested.b)
    path = os.path.join(str(tmp_path), "step_000000002", "leaf_00000.npy")
    np.save(path, np.load(path) + 1)
    restored, manifest = cm.restore(_tree())
    assert manifest["step"] == 1  # the CRC check rejected step 2
    _tree_equal(restored, _tree(1))


def test_checkpoint_async(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    t = _tree()
    want = {"w": t["w"].clone(), "nested": {"b": t["nested"]["b"].clone()}}
    cm.save(7, t, blocking=False)
    t["w"].add_(1.0)        # the caller's next in-place update races no write
    cm.wait()
    restored, manifest = cm.restore(t)
    assert manifest["step"] == 7
    _tree_equal(want, restored)
    assert cm.stats["save"]["bytes"] == 8 * 16 * 4 + 5 * 4


def test_checkpoint_async_error_surfaces_at_wait(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"w": torch.ones(3)}, blocking=False)
    cm.wait()
    shutil.rmtree(str(tmp_path))
    open(str(tmp_path), "w").close()        # the directory is now a file
    cm.save(2, {"w": torch.ones(3)}, blocking=False)
    with pytest.raises(OSError):
        cm.wait()
    cm.wait()                               # raised once


def test_checkpoint_partial_write_is_invisible(tmp_path):
    """A .tmp directory (a crash mid-save) is never restored."""
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, _tree(1))
    os.makedirs(os.path.join(str(tmp_path), "step_000000009.tmp"))
    restored, manifest = cm.restore(_tree())
    assert manifest["step"] == 1


def test_checkpoint_bf16_and_int_leaves(tmp_path):
    """bf16 serving weights, int and bool leaves round-trip exactly."""
    cm = CheckpointManager(str(tmp_path))
    t = {"w_bf16": torch.linspace(-2, 2, 64, dtype=torch.bfloat16).reshape(8, 8),
         "step": torch.tensor(7, dtype=torch.int32),
         "flags": torch.tensor([True, False])}
    cm.save(1, t)
    restored, manifest = cm.restore(t)
    _tree_equal(t, restored)
    assert [m["dtype"] for m in manifest["leaves"]] == ["bool", "int32", "bfloat16"]


# ------------------------------------------------ checkpoints across packages

def _j_tree():
    return {"w_bf16": jnp.linspace(-2, 2, 64, dtype=jnp.bfloat16).reshape(8, 8),
            "step": jnp.asarray(7, jnp.int32),
            "flags": jnp.asarray([True, False]),
            "nested": {"w": jnp.arange(12, dtype=jnp.float32).reshape(3, 4) / 7,
                       "ids": jnp.arange(5, dtype=jnp.int32) - 2}}


def _as_torch(x) -> torch.Tensor:
    a = np.asarray(x)
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def test_port_reads_a_checkpoint_the_reference_wrote(tmp_path):
    t = _j_tree()
    JCheckpointManager(str(tmp_path)).save(4, t)
    restored, manifest = CheckpointManager(str(tmp_path)).restore(t)
    assert manifest["step"] == 4
    _tree_equal(restored, jax.tree.map(_as_torch, t))


def test_reference_reads_a_checkpoint_the_port_wrote(tmp_path):
    t = _j_tree()
    CheckpointManager(str(tmp_path)).save(5, jax.tree.map(_as_torch, t))
    restored, manifest = JCheckpointManager(str(tmp_path)).restore(t)
    assert manifest["step"] == 5
    for a, b in zip(jax.tree.leaves(t), jax.tree.leaves(restored)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


# ------------------------------------------------------ kill/resume trainer

def _tcfg(tmp, **kw):
    base = dict(global_batch=4, seq_len=32, ckpt_dir=str(tmp), ckpt_every=5,
                async_ckpt=False, log_every=1, device=CPU,
                opt=AdamWConfig(peak_lr=LR, warmup_steps=5, total_steps=40))
    return TrainerConfig(**{**base, **kw})


def _make_trainer(tmp, **kw):
    return Trainer(get_config("stablelm-1.6b").smoke(), _tcfg(tmp, **kw))


def test_kill_resume_bitwise_identical(tmp_path):
    """Crash at step 12 (after a save at step 9), auto-resume, and compare
    against an uninterrupted run: final params must be bit-identical."""
    ref = _make_trainer(tmp_path / "a").run(20, resume=False)
    crashy = _make_trainer(tmp_path / "b", fail_at_step=12)
    with pytest.raises(RuntimeError, match="injected failure"):
        crashy.run(20, resume=False)
    assert CheckpointManager(str(tmp_path / "b")).all_steps() == [4, 9]
    resumed_tr = _make_trainer(tmp_path / "b")
    resumed = resumed_tr.run(20, resume=True)
    assert [r["step"] for r in resumed_tr.metrics_log] == list(range(10, 20))
    _tree_equal(ref["params"], resumed["params"])
    _tree_equal(ref["opt"], resumed["opt"])
    assert ref["final_loss"] == resumed["final_loss"]


def test_resumed_run_without_steps_restores_and_keeps_its_checkpoint(tmp_path):
    first = _make_trainer(tmp_path, ckpt_every=0).run(3, resume=False)
    stamp = os.path.getmtime(tmp_path / "step_000000002" / "manifest.json")
    again = _make_trainer(tmp_path, ckpt_every=0)
    out = again.run(3, resume=True)
    assert again.metrics_log == [] and np.isnan(out["final_loss"])
    _tree_equal(first["params"], out["params"])
    assert os.path.getmtime(tmp_path / "step_000000002" / "manifest.json") == stamp


def test_trainer_step_is_make_train_step_at_one_rank(tmp_path):
    cfg = get_config("stablelm-1.6b").smoke()
    tcfg = _tcfg(tmp_path, ckpt_every=0, n_microbatches=2)
    out = Trainer(cfg, tcfg).run(2, resume=False)
    model = steps.init_params(torch.Generator().manual_seed(0), cfg, device=CPU,
                              param_dtype=torch.float32)
    state = {"m": {k: torch.zeros_like(p) for k, p in model.named_parameters()},
             "v": {k: torch.zeros_like(p) for k, p in model.named_parameters()},
             "count": torch.zeros((), dtype=torch.int32)}
    step = steps.make_train_step(cfg, tcfg.opt, 2)
    pipe = TokenPipeline(PipelineConfig(cfg.vocab_size, 32, 4))
    for i in range(2):
        model, state, metrics = step(model, state, pipe.batch(i))
    _tree_equal({k: p.detach() for k, p in model.named_parameters()}, out["params"])
    _tree_equal(state, out["opt"])
    assert out["final_loss"] == float(metrics["loss"])


def test_elastic_reshard(tmp_path):
    """Save from a plain layout, restore onto DTensor placements on a
    (data, model) mesh: the elastic path (``distribute_tensor``)."""
    cm = CheckpointManager(str(tmp_path))
    t = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    cm.save(1, t)
    with world(CPU):
        mesh = make_host_mesh(1, 1, device=CPU)
        shardings = shd.named(mesh, {"w": shd.P("data", "model")})
        restored, _ = cm.restore(t, shardings=shardings)
        assert restored["w"].placements == shardings["w"].placements
        assert restored["w"].device_mesh is mesh
        _equal(restored["w"].full_tensor(), t["w"])


def test_meshes_need_their_ranks():
    with pytest.raises(RuntimeError, match="need 256 ranks, have 0"):
        make_production_mesh()
    with world(CPU):
        mesh = make_host_mesh(1, 1, device=CPU)
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
        with pytest.raises(RuntimeError, match="need 512 ranks, have 1"):
            make_production_mesh(multi_pod=True, factor=(64, 4), device=CPU)
        with pytest.raises(RuntimeError, match="need 2 ranks"):
            make_mesh((2,), ("pod",), device=CPU)
    with pytest.raises(ValueError, match="256"):
        make_production_mesh(factor=(8, 8))


# ----------------------------------------------------------- data pipeline

def test_pipeline_stateless_and_host_invariant():
    base = PipelineConfig(vocab_size=512, seq_len=64, global_batch=8, seed=3)
    p1 = TokenPipeline(base)
    b1 = p1.batch(10)
    np.testing.assert_array_equal(b1["inputs"], p1.batch(10)["inputs"])
    assert not np.array_equal(p1.batch(11)["inputs"], b1["inputs"])
    hosts = [TokenPipeline(PipelineConfig(vocab_size=512, seq_len=64, global_batch=8,
                                          seed=3, num_hosts=4, host_index=i)
                           ).batch(10)["inputs"] for i in range(4)]
    np.testing.assert_array_equal(np.concatenate(hosts, 0), b1["inputs"])


def test_pipeline_has_learnable_structure():
    p = TokenPipeline(PipelineConfig(vocab_size=512, seq_len=200, global_batch=4))
    toks = p.batch(0)["inputs"]
    assert np.array_equal(toks[:, 97 * 2], toks[:, 97])


# -------------------------------------------------------------- stragglers

def test_straggler_detector_flags_outlier():
    det = StragglerDetector(warmup=3, sigmas=3.0)
    times = [0.100, 0.101, 0.099, 0.102, 0.100, 0.100, 0.500, 0.101]
    flagged = [det.observe("h0", t) for t in times]
    assert flagged[6] is True
    assert sum(flagged) == 1


def test_straggler_detector_matches_reference():
    rng = np.random.default_rng(0)
    times = np.abs(rng.normal(0.1, 0.01, 64))
    times[[20, 41]] = 1.0
    ours, ref = StragglerDetector(), JStragglerDetector()
    for i, t in enumerate(times):
        w = f"h{i % 3}"
        assert ours.observe(w, float(t)) == ref.observe(w, float(t))
    assert ours.fleet_stats() == ref.fleet_stats()


def test_should_speculate_late_heuristic():
    assert should_speculate(0.1, 1.0, 0.2, remaining_work=50, est_fresh_time=60)
    assert not should_speculate(0.1, 1.0, 0.2, remaining_work=1, est_fresh_time=60)
    assert not should_speculate(1.0, 1.0, 0.2, remaining_work=50, est_fresh_time=60)


def test_trainer_straggler_hook(tmp_path):
    tr = _make_trainer(tmp_path)
    for t in [0.1] * 6 + [2.0]:
        tr.stragglers.observe("host0", t)
    mean, _ = tr.stragglers.fleet_stats()
    assert mean < 0.2  # the outlier did not poison the EWMA


# ------------------------------------------------------ cross-pod compress

def test_crosspod_compression_int8_error_feedback():
    """Without a pod axis (or with one of size 1) the reduction is the
    identity: grads and the error state come back unchanged."""
    g = {"w": torch.linspace(-1, 1, 64).reshape(8, 8)}
    err = compress.compress_init(g, "int8")
    with world(CPU):
        for mesh in (make_host_mesh(1, 1, device=CPU),
                     make_mesh((1, 1), ("pod", "data"), device=CPU)):
            red, err2 = crosspod_reduce(g, err, mesh, method="int8")
            assert red is g and err2 is err


@pytest.mark.parametrize("method", ["none", "bf16", "int8"])
def test_compress_grads_matches_reference(method):
    rng = np.random.default_rng(1)
    arrs = {"a": rng.standard_normal((16, 8)).astype(np.float32),
            "b": (rng.standard_normal(33) * 1e-3).astype(np.float32)}
    g = {k: torch.from_numpy(v) for k, v in arrs.items()}
    err = compress.compress_init(g, method)
    j_g = {k: jnp.asarray(v) for k, v in arrs.items()}
    j_err = j_compress.compress_init(j_g, method)
    for _ in range(2):              # the error feedback carries over
        comp, err = compress.compress_grads(g, err, method)
        j_comp, j_err = j_compress.compress_grads(j_g, j_err, method)
        out = compress.decompress_grads(comp, g, method)
        j_out = j_compress.decompress_grads(j_comp, j_g, method)
        for k in arrs:
            np.testing.assert_allclose(out[k].numpy(), np.asarray(j_out[k]),
                                       rtol=1e-6, atol=1e-7)
            if method == "int8":
                np.testing.assert_array_equal(comp[k][0].numpy(),
                                              np.asarray(j_comp[k][0]))
                np.testing.assert_allclose(err[k].numpy(), np.asarray(j_err[k]),
                                           rtol=1e-6, atol=1e-7)


_WORLD = textwrap.dedent("""
    import shutil, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def rank_main(rank, world, port, tmp):
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.configs import get_config
        from repro_torch.launch import sharding as shd
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.optim import AdamWConfig, compress_init
        from repro_torch.runtime import Trainer, TrainerConfig
        from repro_torch.runtime.crosspod import crosspod_reduce
        cfg = get_config("stablelm-1.6b").smoke()
        out = {}

        def tcfg(d):
            return TrainerConfig(global_batch=4, seq_len=32, ckpt_dir=f"{tmp}/{d}",
                                 ckpt_every=0, async_ckpt=False, log_every=1,
                                 device="cpu", mesh_shape=(2, 1),
                                 opt=AdamWConfig(peak_lr=1e-3, warmup_steps=5,
                                                 total_steps=40))
        tr = Trainer(cfg, tcfg("dp2"))
        assert tr.dp == 2 and tr.data_rank == rank
        res = tr.run(3, resume=False)
        for k, v in res["params"].items():
            out["dp2/" + k] = v.numpy()
        out["dp2_losses"] = np.array([r["loss"] for r in tr.metrics_log])
        # elastic: a world-of-1 checkpoint (step 2) resumed onto dp 2
        tr = Trainer(cfg, tcfg("elastic"))
        res = tr.run(4, resume=True)
        assert [r["step"] for r in tr.metrics_log] == [3]
        for k, v in res["params"].items():
            out["elastic/" + k] = v.numpy()
        # a DTensor restored onto Shard(0) over data: half the rows a rank
        mesh = make_mesh((2, 1), ("data", "model"), device="cpu")
        cm = CheckpointManager(f"{tmp}/plain")
        w, _ = cm.restore({"w": None}, shardings=shd.named(mesh, {"w": shd.P("data", None)}))
        out["shard_rows"] = w["w"].to_local().numpy()
        # crosspod on a pod axis of 2
        pods = make_mesh((2,), ("pod",), device="cpu")
        g = {"w": torch.linspace(-1, 1, 64).reshape(8, 8)}
        red, err = crosspod_reduce(g, compress_init(g, "int8"), pods, method="int8")
        out["int8_same"] = red["w"].numpy()
        out["int8_err"] = err["w"].numpy()
        red_bf, _ = crosspod_reduce(g, None, pods, method="bf16")
        out["bf16_same"] = red_bf["w"].numpy()
        g2 = {"w": g["w"] * (1 + rank)}
        red2, _ = crosspod_reduce(g2, compress_init(g2, "int8"), pods, method="int8")
        out["int8_mean"] = red2["w"].numpy()
        red3, _ = crosspod_reduce(g2, None, pods, method="bf16")
        out["bf16_mean"] = red3["w"].numpy()
        np.savez(f"{tmp}/rank{rank}.npz", **out)
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        import socket
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        mp.spawn(rank_main, args=(2, port, sys.argv[1]), nprocs=2, join=True)
        print("OK")
""")


def test_two_gloo_ranks_dp_elastic_and_crosspod(tmp_path):
    """dp 2 == dp 1; a world-of-1 checkpoint resumed onto dp 2 placements
    continues as the world of 1 does; int8 and bf16 cross-pod reductions."""
    cfg = get_config("stablelm-1.6b").smoke()
    tc = dict(global_batch=4, seq_len=32, ckpt_every=0, async_ckpt=False, log_every=1,
              device=CPU, opt=AdamWConfig(peak_lr=LR, warmup_steps=5, total_steps=40))
    one = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "dp1"), **tc))
    dp1 = one.run(3, resume=False)
    shutil.copytree(tmp_path / "dp1", tmp_path / "elastic")
    four = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "dp1"), **tc)).run(4)
    CheckpointManager(str(tmp_path / "plain")).save(
        0, {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)})

    script = tmp_path / "world.py"
    script.write_text(_WORLD)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(script), str(tmp_path)], env=env,
                          cwd=str(tmp_path), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK" in proc.stdout
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in (0, 1)]
    # the mean of two half-batch means is the full batch's mean (every
    # mask is 1); only the summation order differs from one rank
    np.testing.assert_allclose(ranks[0]["dp2_losses"],
                               [r["loss"] for r in one.metrics_log], rtol=1e-5)
    for k, p in dp1["params"].items():
        for r in ranks:
            np.testing.assert_allclose(r["dp2/" + k], p.numpy(), rtol=1e-5,
                                       atol=LR / 10, err_msg=k)
            np.testing.assert_allclose(r["elastic/" + k], four["params"][k].numpy(),
                                       rtol=1e-5, atol=LR / 10, err_msg=k)
    rows = np.arange(64, dtype=np.float32).reshape(8, 8)
    np.testing.assert_array_equal(ranks[0]["shard_rows"], rows[:4])
    np.testing.assert_array_equal(ranks[1]["shard_rows"], rows[4:])
    g = np.linspace(-1, 1, 64, dtype=np.float32).reshape(8, 8)
    for r in ranks:
        np.testing.assert_allclose(r["int8_same"], g, atol=2e-2)
        np.testing.assert_allclose(r["int8_same"] + r["int8_err"], g, atol=1e-6)
        np.testing.assert_allclose(r["bf16_same"], g, atol=1e-2)
        np.testing.assert_allclose(r["int8_mean"], 1.5 * g, atol=2e-2)
        np.testing.assert_allclose(r["bf16_mean"], 1.5 * g, atol=1e-2)
    np.testing.assert_array_equal(ranks[0]["int8_mean"], ranks[1]["int8_mean"])


# --------------------------------------------- the Trainer against the reference

def test_trainer_matches_reference_trainer(tmp_path):
    j_cfg, cfg = j_get_config("stablelm-1.6b").smoke(), get_config("stablelm-1.6b").smoke()
    kw = dict(global_batch=4, seq_len=32, ckpt_every=0, async_ckpt=False, log_every=1)
    opt = dict(peak_lr=LR, warmup_steps=2, total_steps=10)
    ref = JTrainer(j_cfg, JTrainerConfig(ckpt_dir=str(tmp_path / "j"),
                                         opt=JAdamWConfig(**opt), **kw))
    ref.run(0, resume=False)        # writes the initial state as step -1
    # the port reads the reference's checkpoint in the reference's layout ...
    state, manifest = CheckpointManager(str(tmp_path / "j")).restore(
        {"params": ref._params_shape, "opt": ref._opt_shape})
    assert manifest["step"] == -1
    # ... and carries it into its own (layers unstacked, by parameter name)
    np_state = jax.tree.map(lambda t: t.numpy(), state)
    carried = {"params": jax_leaf_names(cfg, np_state["params"]),
               "opt": {"count": np_state["opt"]["count"],
                       "m": jax_leaf_names(cfg, np_state["opt"]["m"]),
                       "v": jax_leaf_names(cfg, np_state["opt"]["v"])}}
    carried = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), carried)
    CheckpointManager(str(tmp_path / "t")).save(-1, carried)

    port = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "t"), device=CPU,
                                      opt=AdamWConfig(**opt), **kw))
    got = port.run(3, resume=True)
    want = ref.run(3, resume=True)
    assert [r["step"] for r in port.metrics_log] == [r["step"] for r in ref.metrics_log]
    np.testing.assert_allclose([r["loss"] for r in port.metrics_log],
                               [r["loss"] for r in ref.metrics_log], rtol=1e-5)
    np.testing.assert_allclose([r["grad_norm"] for r in port.metrics_log],
                               [r["grad_norm"] for r in ref.metrics_log], rtol=1e-4)
    flat = jax_leaf_names(cfg, jax.tree.map(np.asarray, want["params"]))
    for k, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), flat[k], rtol=1e-5, atol=LR / 10,
                                   err_msg=k)
    assert int(got["opt"]["count"]) == int(want["opt"]["count"]) == 3


# ------------------------------------------------------------ refusals

def test_trainer_refuses_grad_compression():
    for method in ("bf16", "int8"):
        with pytest.raises(ValueError, match="never reads"):
            TrainerConfig(grad_compression=method, device=CPU)
    JTrainerConfig(grad_compression="bf16")    # the reference takes it


@pytest.mark.parametrize("field,value,why", [
    ("cache_update", "no-such-update", "not a cache update strategy"),
    ("bf16_collectives", True, "no code of the reference reads it"),
    ("moe_impl", "no-such-dispatch", "not a MoE dispatch"),
])
def test_set_flags_refusals_name_why(field, value, why):
    with pytest.raises(ValueError, match=why):
        opt_flags.set_flags(opt_flags.OptFlags(**{field: value}))
    assert opt_flags.get_flags() == opt_flags.OptFlags()
