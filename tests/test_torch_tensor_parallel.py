"""Tensor- and expert-parallel compute over the ``model`` axis against the
JAX package, on the CPU.

The reference's runs need placeholder devices, which ``XLA_FLAGS`` must
give before jax starts, so each of its meshes runs in a subprocess of its
own (``--xla_force_host_platform_device_count``); the port's runs need
ranks, so each world size is a ``torch.multiprocessing.spawn`` of gloo
ranks in a subprocess.  A module fixture first writes the initial states
(the reference Trainer's run of 0 steps, carried into the port's layout as
``tests/test_torch_trainer.py`` does, and the reference's ``init`` trees),
then starts the three reference meshes and the two port worlds together;
results come back in ``.npz`` files.  Every subprocess has a ``timeout``.

* The primitives of ``models/tensor_parallel.py`` on 2 gloo ranks: forward
  and backward of each against the math.
* The MoE at dp 2 (the repair): deepseek-moe-16b ``.smoke()`` with
  ``moe_capacity_factor`` 1.0, so that tokens drop: the port's Trainer at
  mesh (2, 1) against the reference's, ``einsum`` and ``shardmap``.
* The Trainer at mesh (1, 2) and (2, 2) against the reference's:
  stablelm-1.6b (dense), gemma2-9b (tied vocab-parallel embedding,
  softcaps), deepseek-moe-16b (``einsum`` and ``shardmap``, experts over
  ``model``), recurrentgemma-9b (RG-LRU width over ``model``, k/v
  replicated while q is sharded); losses at rtol 1e-5, parameters within a
  tenth of the learning rate.  No ``DTensor.full_tensor`` runs in the
  port's Trainer, and a rank's module holds local shapes.
* seamless-m4t-large-v2's enc-dec step: ``sharded_step`` on a seeded batch
  against the reference's ``make_train_step`` jitted with the rules'
  shardings, at (1, 2) and (2, 2).
* Serving at tp 2 on a (2, 2) mesh: the reference's prefill and decode
  steps jitted with the rules' in/out shardings under the activation
  policy, as its dry-run runs them, against the port's factories: gathered
  logits at 1e-4 (fp32), gemma2-9b and deepseek-moe-16b (``shardmap``
  under the policy: capacity per data shard, capacity factor 1.0 so that
  it matters).
* Serving over sequence-sharded caches (``SERVE_SEQ``): configs whose
  ``n_kv_heads % 2 != 0`` (recurrentgemma-9b's rings; gemma2-9b with one
  kv head, full and ring caches; starcoder2-7b with 3 q heads, q and ``o``
  replicated), whose rules put each cache's sequence over ``model``: every
  step's gathered logits, and each rank's caches after prefill and after
  the last step against the reference's restricted to the rank's shard,
  at 1e-4.  Two more cases install the sequence group by hand, over
  ("data", "model") (4 spans) and over ``data`` alone, which the rules
  never give.
* The dry-run on a fake 4 x 2 mesh: per-device FLOPs against one device's
  divided by the split, ``tp_compute``, the argument and output bytes
  under the rules.
"""

import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
LR = 1e-3
OPT = dict(peak_lr=LR, warmup_steps=2, total_steps=10)
TRAIN = dict(global_batch=4, seq_len=32, ckpt_every=0, async_ckpt=False, log_every=1)
STEPS = 3

# (case, arch, moe_impl, capacity factor or None)
MOE_DP = [("moe_einsum_cf1", "deepseek-moe-16b", "einsum", 1.0),
          ("moe_shardmap_cf1", "deepseek-moe-16b", "shardmap", 1.0)]
FAMILIES = [("dense", "stablelm-1.6b", "einsum", None),
            ("tied", "gemma2-9b", "einsum", None),
            ("moe_einsum", "deepseek-moe-16b", "einsum", None),
            ("moe_shardmap", "deepseek-moe-16b", "shardmap", None),
            ("rglru", "recurrentgemma-9b", "einsum", None)]
# serving at mesh (2, 2): (case, arch, moe_impl, capacity factor or None)
SERVE = [("serve_tied", "gemma2-9b", "einsum", None),
         ("serve_moe_shardmap", "deepseek-moe-16b", "shardmap", 1.0)]
SERVE_B, SERVE_S, SERVE_MAX, SERVE_STEPS = 4, 8, 16, 3
# serving over sequence-sharded caches at mesh (2, 2): (case, arch, config
# changes, global batch, the sequence axes installed by hand or None: the
# rules' own, sharding.cache_seq_axes).  The rules never put the sequence
# on ``data``: ``batch_axes`` gives () at B 1, not None, so ``_cache_rule``'s
# data branch is never taken, in either package.  The last two cases
# install the sequence group over ("data", "model") and over ``data`` by
# hand, to hold the port's merge over those groups against the reference's
# numbers; their caches are compared under that split.
SERVE_SEQ = [("serve_seq_rglru", "recurrentgemma-9b", {}, 4, None),
             ("serve_seq_tied", "gemma2-9b", {"n_kv_heads": 1}, 4, None),
             ("serve_seq_qrep", "starcoder2-7b", {"n_heads": 3, "n_kv_heads": 1}, 4, None),
             ("serve_seq_long", "recurrentgemma-9b", {}, 1, ["data", "model"]),
             ("serve_seq_data", "gemma2-9b", {}, 1, ["data"])]
# A prompt of 10 and caches of 32: full caches of 32 slots (spans of 16,
# or 8 over four ranks) and rings of the smoke window, 16 (spans of 8, or
# 4), so the prompt crosses a ring span and 10 decode steps (positions 10 to
# 19) pass the window and max_len / 2, wrap the ring and cross a full
# cache's span.
SEQ_S, SEQ_MAX, SEQ_STEPS = 10, 32, 10
ENCDEC = "seamless-m4t-large-v2"
ENC_B, ENC_SRC, ENC_T, ENC_STEPS = 4, 6, 8, 2

_COMMON = textwrap.dedent('''
    import json, shutil, sys
    import numpy as np

    SPEC = json.load(open(sys.argv[1]))
    TMP = SPEC["tmp"]

    def cfg_of(get_config, arch, cf, changes=None):
        cfg = get_config(arch).smoke()
        if cf is not None:
            cfg = cfg.replace(moe_capacity_factor=cf)
        return cfg.replace(**changes) if changes else cfg
''')

# ------------------------------------------------------ the reference side

_REF = _COMMON + textwrap.dedent('''
    import pickle
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.configs.shapes import ShapeSpec
    from repro.launch import sharding as shd
    from repro.launch import steps as jsteps
    from repro.models import act_sharding
    from repro.models.opt_flags import OptFlags, clear_flags, set_flags
    from repro.optim import AdamWConfig, adamw_init
    from repro.runtime import Trainer, TrainerConfig
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models.weights import jax_leaf_names

    def flat(cfg, tree):
        return jax_leaf_names(cfg, jax.tree.map(np.asarray, tree))

    def trainer(cfg, d, mesh):
        return Trainer(cfg, TrainerConfig(ckpt_dir=d, mesh_shape=tuple(mesh),
                                          opt=AdamWConfig(**SPEC["opt"]), **SPEC["train"]))

    def init_all():
        for case, arch, impl, cf in SPEC["cases"]:
            cfg = cfg_of(get_config, arch, cf)
            ref = trainer(cfg, f"{TMP}/init_{case}", (1, 1))
            ref.run(0, resume=False)           # the initial state, as step -1
            state, man = CheckpointManager(f"{TMP}/init_{case}").restore(
                {"params": ref._params_shape, "opt": ref._opt_shape})
            st = jax.tree.map(lambda t: t.numpy(), state)
            carried = {"params": jax_leaf_names(cfg, st["params"]),
                       "opt": {"count": st["opt"]["count"],
                               "m": jax_leaf_names(cfg, st["opt"]["m"]),
                               "v": jax_leaf_names(cfg, st["opt"]["v"])}}
            import torch
            carried = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), carried)
            CheckpointManager(f"{TMP}/port_{case}").save(-1, carried)
        trees = {}
        for case, arch, impl, cf in SPEC["serve"] + [[SPEC["encdec"], SPEC["encdec"], "einsum", None]]:
            cfg = cfg_of(get_config, arch, cf)
            trees[case] = jax.tree.map(np.asarray, jsteps.init_params(jax.random.PRNGKey(3), cfg))
        for case, arch, changes, B, seq in SPEC["serve_seq"]:
            cfg = cfg_of(get_config, arch, None, changes)
            trees[case] = jax.tree.map(np.asarray, jsteps.init_params(jax.random.PRNGKey(4), cfg))
        with open(f"{TMP}/trees.pkl", "wb") as f:
            pickle.dump(trees, f)

    def train(mesh):
        out = {}
        for case, arch, impl, cf in SPEC["cases_at"][str(mesh)]:
            cfg = cfg_of(get_config, arch, cf)
            # with "spread", the same run on one device too: the reference's
            # own difference between the two meshes
            for m, tag in [(mesh, "p")] + ([((1, 1), "p1")] if SPEC.get("spread") else []):
                d = f"{TMP}/ref_{case}_{m[0]}x{m[1]}"
                shutil.copytree(f"{TMP}/init_{case}", d)
                set_flags(OptFlags(moe_impl=impl))
                ref = trainer(cfg, d, m)
                res = ref.run(SPEC["steps"], resume=True)
                clear_flags()
                if tag == "p":
                    out[f"{case}/losses"] = np.array([r["loss"] for r in ref.metrics_log])
                for k, v in flat(cfg, res["params"]).items():
                    out[f"{case}/{tag}/{k}"] = v
        return out

    def encdec(mesh, devices):
        cfg = get_config(SPEC["encdec"]).smoke()
        with open(f"{TMP}/trees.pkl", "rb") as f:
            params = jax.tree.map(jnp.asarray, pickle.load(f)[SPEC["encdec"]])
        b = np.load(f"{TMP}/encdec_batch.npz")
        jm = Mesh(devices, ("data", "model"))
        opt = adamw_init(params)
        p_sh = shd.named(jm, shd.param_pspecs(cfg, params, jm))
        o_sh = shd.named(jm, shd.opt_pspecs(cfg, opt, jm))
        step = jsteps.make_train_step(cfg, AdamWConfig(**SPEC["opt"]), 1)
        out = {}
        for i in range(SPEC["enc_steps"]):
            batch = {k: jnp.asarray(b[f"{k}{i}"]) for k in ("src_embeds", "inputs", "targets")}
            b_sh = {k: NamedSharding(jm, P("data")) for k in batch}
            with jm:
                params, opt, metrics = jax.jit(
                    step, in_shardings=(p_sh, o_sh, b_sh),
                    out_shardings=(p_sh, o_sh, None))(params, opt, batch)
            out[f"encdec/loss{i}"] = np.asarray(metrics["loss"])
        for k, v in flat(cfg, params).items():
            out[f"encdec/p/{k}"] = v
        return out

    def serve(devices):
        jm = Mesh(devices, ("data", "model"))
        with open(f"{TMP}/trees.pkl", "rb") as f:
            trees = pickle.load(f)
        toks = np.load(f"{TMP}/serve_tokens.npz")
        out = {}
        B, S, M = SPEC["serve_shape"]
        for case, arch, impl, cf in SPEC["serve"]:
            cfg = cfg_of(get_config, arch, cf)
            set_flags(OptFlags(moe_impl=impl))
            params = jax.tree.map(jnp.asarray, trees[case])
            p_sh = shd.named(jm, shd.param_pspecs(cfg, params, jm))
            shape = ShapeSpec("serve", M, B, "prefill")
            act_sharding.set_policy(shd.activation_policy(cfg, shape, jm))
            prefill = jsteps.make_prefill_step(cfg, max_len=M)
            batch = {"inputs": jnp.asarray(toks["prompt"])}
            b_sh = shd.named(jm, shd.input_pspecs(cfg, shape, batch, jm))
            o_shape = jax.eval_shape(prefill, params, batch)
            o_sh = shd.named(jm, shd.output_pspecs(cfg, shape, o_shape, jm))
            with jm:
                res = jax.jit(prefill, in_shardings=(p_sh, b_sh), out_shardings=o_sh)(params, batch)
            out[f"{case}/logits0"] = np.asarray(res["logits"])
            decode = jsteps.make_decode_step(cfg)
            dshape = ShapeSpec("serve", M, B, "decode")
            caches, pos = res["caches"], res["pos"]
            for i in range(SPEC["serve_steps"]):
                batch = {"token": jnp.asarray(toks[f"token{i}"]), "caches": caches, "pos": pos}
                o_shape = jax.eval_shape(decode, params, batch)
                o_sh = shd.named(jm, shd.output_pspecs(cfg, dshape, o_shape, jm))
                with jm:
                    res = jax.jit(decode, out_shardings=o_sh)(params, batch)
                caches, pos = res["caches"], pos + 1
                out[f"{case}/logits{i + 1}"] = np.asarray(res["logits"])
            act_sharding.clear_policy()
            clear_flags()
        return out

    def port_order(caches):
        """The caches as the port's list of layers: the prefix, then for
        each group each pattern member's slice."""
        layers = [jax.tree.map(np.asarray, c) for c in caches["prefix"]]
        groups = caches["groups"]
        for g in range(jax.tree.leaves(groups)[0].shape[0] if groups else 0):
            layers += [jax.tree.map(lambda a: np.asarray(a[g]), m) for m in groups]
        return layers

    def dump_caches(out, tag, caches):
        for i, layer in enumerate(port_order(caches)):
            for leaf, a in layer.items():
                out[f"{tag}/{i}/{leaf}"] = a

    def serve_seq(devices):
        """The sequence-sharded cases: each step's logits, and the whole
        caches after prefill and after the last step (the rules' shardings
        keep each rank's span; np.asarray gathers them)."""
        jm = Mesh(devices, ("data", "model"))
        with open(f"{TMP}/trees.pkl", "rb") as f:
            trees = pickle.load(f)
        toks = np.load(f"{TMP}/serve_tokens.npz")
        out = {}
        S, M, steps = SPEC["seq_shape"]
        for case, arch, changes, B, seq in SPEC["serve_seq"]:
            cfg = cfg_of(get_config, arch, None, changes)
            params = jax.tree.map(jnp.asarray, trees[case])
            p_sh = shd.named(jm, shd.param_pspecs(cfg, params, jm))
            shape = ShapeSpec("serve", M, B, "prefill")
            act_sharding.set_policy(shd.activation_policy(cfg, shape, jm))
            prefill = jsteps.make_prefill_step(cfg, max_len=M)
            batch = {"inputs": jnp.asarray(toks["seq_prompt"][:B])}
            b_sh = shd.named(jm, shd.input_pspecs(cfg, shape, batch, jm))
            o_shape = jax.eval_shape(prefill, params, batch)
            o_sh = shd.named(jm, shd.output_pspecs(cfg, shape, o_shape, jm))
            with jm:
                res = jax.jit(prefill, in_shardings=(p_sh, b_sh), out_shardings=o_sh)(params, batch)
            out[f"{case}/logits0"] = np.asarray(res["logits"])
            dump_caches(out, f"{case}/cache0", res["caches"])
            decode = jsteps.make_decode_step(cfg)
            dshape = ShapeSpec("serve", M, B, "decode")
            caches, pos = res["caches"], res["pos"]
            batch = {"token": jnp.asarray(toks["seq_token0"][:B]), "caches": caches, "pos": pos}
            o_sh = shd.named(jm, shd.output_pspecs(cfg, dshape, jax.eval_shape(decode, params, batch), jm))
            step = jax.jit(decode, out_shardings=o_sh)
            for i in range(steps):
                batch = {"token": jnp.asarray(toks[f"seq_token{i}"][:B]), "caches": caches, "pos": pos}
                with jm:
                    res = step(params, batch)
                caches, pos = res["caches"], pos + 1
                out[f"{case}/logits{i + 1}"] = np.asarray(res["logits"])
            dump_caches(out, f"{case}/cache1", caches)
            act_sharding.clear_policy()
        return out

    if __name__ == "__main__":
        job = SPEC["job"]
        if job == "init":
            init_all()
        else:
            mesh = tuple(SPEC["mesh"])
            devices = np.array(jax.devices()[:mesh[0] * mesh[1]]).reshape(mesh)
            out = train(list(mesh))
            if SPEC.get("encdec_here"):
                out.update(encdec(mesh, devices))
            if SPEC.get("serve_here"):
                out.update(serve(devices))
                out.update(serve_seq(devices))
            np.savez(f"{TMP}/ref_{mesh[0]}x{mesh[1]}.npz", **out)
        print("OK")
''')

# ------------------------------------------------------------ the port side

_PORT = _COMMON + textwrap.dedent('''
    import pickle
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def primitives(rank, out):
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import tensor_parallel as tp
        x0 = torch.arange(6, dtype=torch.float64).reshape(2, 3) + 10 * rank
        with tp.model_group(make_mesh((1, 2), ("data", "model"), device="cpu")):
            w = torch.full((2, 3), float(rank + 1), dtype=torch.float64)
            for name, fn in (("copy", tp.copy_to_model), ("reduce", tp.reduce_from_model),
                             ("gather", tp.gather_from_model)):
                x = x0.clone().requires_grad_(True)
                y = fn(x)
                g = torch.autograd.grad((y * torch.ones_like(y).cumsum(-1) * (rank + 1)).sum(), x)[0]
                out[f"prim/{name}/y"], out[f"prim/{name}/g"] = y.detach().numpy(), g.numpy()
            out["prim/max"] = tp.max_from_model(x0 * (1 - 2 * rank)).numpy()
            out["prim/model_rank"] = np.array([tp.model_rank(), tp.model_size()])
        with tp.model_group(make_mesh((2, 1), ("data", "model"), device="cpu"), ("data",)):
            x = x0.clone().requires_grad_(True)
            y = tp.mean_over_batch(x)
            g = torch.autograd.grad((y * (rank + 1)).sum(), x)[0]
            out["prim/mean/y"], out["prim/mean/g"] = y.detach().numpy(), g.numpy()
            out["prim/counts"] = tp.batch_counts(torch.tensor([[rank, 7]])).numpy()
        assert tp.current() is None

    def trainers(rank, mesh, cases, out):
        from torch.distributed.tensor import DTensor
        from repro_torch.configs import get_config
        from repro_torch.models.opt_flags import OptFlags, clear_flags, set_flags
        from repro_torch.optim import AdamWConfig
        from repro_torch.runtime import Trainer, TrainerConfig

        def refuse(self, *a, **k):
            raise AssertionError("DTensor.full_tensor on the Trainer's path")

        keep, DTensor.full_tensor = DTensor.full_tensor, refuse
        try:
            for case, arch, impl, cf in cases:
                cfg = cfg_of(get_config, arch, cf)
                d = f"{TMP}/port_{case}_{mesh[0]}x{mesh[1]}_r{rank}"
                shutil.copytree(f"{TMP}/port_{case}", d)
                set_flags(OptFlags(moe_impl=impl))
                tr = Trainer(cfg, TrainerConfig(ckpt_dir=d, device="cpu", mesh_shape=tuple(mesh),
                                                opt=AdamWConfig(**SPEC["opt"]), **SPEC["train"]))
                res = tr.run(SPEC["steps"], resume=True)
                clear_flags()
                out[f"{case}/losses"] = np.array([r["loss"] for r in tr.metrics_log])
                for k, v in res["params"].items():
                    out[f"{case}/p/{k}"] = v.numpy()
                for k, p in tr.model.named_parameters():
                    out[f"{case}/local_shape/{k}"] = np.array(p.shape)
        finally:
            DTensor.full_tensor = keep

    def encdec(rank, mesh, out):
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.configs import get_config
        from repro_torch.launch import sharding as shd
        from repro_torch.launch.mesh import full_tensor, make_mesh
        from repro_torch.models.weights import empty, jax_leaf_names
        from repro_torch.optim import AdamWConfig
        from repro_torch.runtime.train_loop import sharded_step
        cfg = get_config(SPEC["encdec"]).smoke()
        dm = make_mesh(tuple(mesh), ("data", "model"), device="cpu")
        with open(f"{TMP}/trees.pkl", "rb") as f:
            whole = jax_leaf_names(cfg, pickle.load(f)[SPEC["encdec"]])
        names = dict(empty(cfg, device="meta", param_dtype=torch.float32).named_parameters())
        p_sh = shd.named(dm, shd.param_pspecs(cfg, names, dm))
        params = {k: distribute_tensor(torch.from_numpy(np.array(whole[k], np.float32)), dm,
                                       p_sh[k].placements, src_data_rank=None) for k in names}
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}   # noqa: E731
        count = distribute_tensor(torch.zeros((), dtype=torch.int32), dm,
                                  shd.placements(dm, shd.REPL), src_data_rank=None)
        opt = {"m": zeros(), "v": zeros(), "count": count}
        mr, dr = dm.get_local_rank("model"), dm.get_local_rank("data")
        model = empty(cfg, device="cpu", param_dtype=torch.float32, model=(mr, mesh[1]))
        b = np.load(f"{TMP}/encdec_batch.npz")
        rows = SPEC["enc_shape"][0] // mesh[0]
        for i in range(SPEC["enc_steps"]):
            batch = {k: torch.from_numpy(b[f"{k}{i}"][dr * rows:(dr + 1) * rows])
                     for k in ("src_embeds", "inputs", "targets")}
            params, opt, metrics = sharded_step(model, dm, params, opt, batch, n_microbatches=1,
                                                opt_cfg=AdamWConfig(**SPEC["opt"]))
            out[f"encdec/loss{i}"] = metrics["loss"].numpy()
        for k, p in params.items():
            out[f"encdec/p/{k}"] = full_tensor(p).numpy()

    def serve(rank, out):
        from repro_torch.configs import get_config
        from repro_torch.configs.shapes import ShapeSpec
        from repro_torch.launch import sharding as shd
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.steps import make_decode_step, make_prefill_step
        from repro_torch.models import act_sharding
        from repro_torch.models import tensor_parallel as tp
        from repro_torch.models.opt_flags import OptFlags, clear_flags, set_flags
        from repro_torch.models.weights import from_jax_params
        dm = make_mesh((2, 2), ("data", "model"), device="cpu")
        mr, dr = dm.get_local_rank("model"), dm.get_local_rank("data")
        with open(f"{TMP}/trees.pkl", "rb") as f:
            trees = pickle.load(f)
        toks = np.load(f"{TMP}/serve_tokens.npz")
        B, S, M = SPEC["serve_shape"]
        rows = slice(dr * B // 2, (dr + 1) * B // 2)
        for case, arch, impl, cf in SPEC["serve"]:
            cfg = cfg_of(get_config, arch, cf)
            set_flags(OptFlags(moe_impl=impl))
            model = from_jax_params(cfg, trees[case], device="cpu", model=(mr, 2))
            act_sharding.set_policy(shd.activation_policy(cfg, ShapeSpec("serve", M, B, "prefill"), dm))
            with tp.model_group(dm, ("data",)):
                res = make_prefill_step(cfg, M)(model, {"inputs": torch.from_numpy(toks["prompt"][rows])})
                out[f"{case}/vocab_shard"] = np.array(res["logits"].shape)
                out[f"{case}/logits0"] = tp.gather_from_model(res["logits"]).numpy()
                decode = make_decode_step(cfg)
                caches, pos = res["caches"], res["pos"]
                for i in range(SPEC["serve_steps"]):
                    res = decode(model, {"token": torch.from_numpy(toks[f"token{i}"][rows]),
                                         "caches": caches, "pos": pos})
                    caches, pos = res["caches"], pos + 1
                    out[f"{case}/logits{i + 1}"] = tp.gather_from_model(res["logits"]).numpy()
            act_sharding.clear_policy()
            clear_flags()

    def serve_seq(rank, out):
        """The sequence-sharded cases through the step factories: gathered
        logits, each rank's caches after prefill and after the last step."""
        from repro_torch.configs import get_config
        from repro_torch.configs.shapes import ShapeSpec
        from repro_torch.launch import sharding as shd
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.steps import make_decode_step, make_prefill_step
        from repro_torch.models import act_sharding
        from repro_torch.models import tensor_parallel as tp
        from repro_torch.models.weights import from_jax_params
        dm = make_mesh((2, 2), ("data", "model"), device="cpu")
        mr, dr = dm.get_local_rank("model"), dm.get_local_rank("data")
        with open(f"{TMP}/trees.pkl", "rb") as f:
            trees = pickle.load(f)
        toks = np.load(f"{TMP}/serve_tokens.npz")
        S, M, steps = SPEC["seq_shape"]
        for case, arch, changes, B, seq in SPEC["serve_seq"]:
            cfg = cfg_of(get_config, arch, None, changes)
            bax = shd.batch_axes(B, dm)
            axes = (bax,) if isinstance(bax, str) else tuple(bax or ())
            rows = slice(dr * B // 2, (dr + 1) * B // 2) if axes else slice(0, B)
            seq = tuple(seq) if seq else shd.cache_seq_axes(cfg, dm, B)
            model = from_jax_params(cfg, trees[case], device="cpu", model=(mr, 2))
            act_sharding.set_policy(shd.activation_policy(cfg, ShapeSpec("serve", M, B, "prefill"), dm))
            with tp.model_group(dm, axes, seq):
                out[f"{case}/seq_axes"] = np.array(tp.current().seq_axes)
                res = make_prefill_step(cfg, M)(model, {"inputs": torch.from_numpy(toks["seq_prompt"][rows])})
                out[f"{case}/logits0"] = tp.gather_from_model(res["logits"]).numpy()
                caches, pos = res["caches"], res["pos"]
                for i, layer in enumerate(caches):
                    for leaf, t in layer.items():
                        out[f"{case}/cache0/{i}/{leaf}"] = t.numpy().copy()
                decode = make_decode_step(cfg)
                for i in range(steps):
                    res = decode(model, {"token": torch.from_numpy(toks[f"seq_token{i}"][rows]),
                                         "caches": caches, "pos": pos})
                    caches, pos = res["caches"], pos + 1
                    out[f"{case}/logits{i + 1}"] = tp.gather_from_model(res["logits"]).numpy()
                for i, layer in enumerate(caches):
                    for leaf, t in layer.items():
                        out[f"{case}/cache1/{i}/{leaf}"] = t.numpy()
            act_sharding.clear_policy()

    def rank_main(rank, world, port):
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        torch.set_num_threads(1)
        out = {}
        if world == 2:
            primitives(rank, out)
            for mesh in ([2, 1], [1, 2]):
                trainers(rank, mesh, SPEC["cases_at"][str(mesh)], out)
            encdec(rank, [1, 2], out)
        else:
            trainers(rank, [2, 2], SPEC["cases_at"][str([2, 2])], out)
            encdec(rank, [2, 2], out)
            serve(rank, out)
            serve_seq(rank, out)
        np.savez(f"{TMP}/port_w{world}_r{rank}.npz", **out)
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        import socket
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        world = SPEC["world"]
        mp.spawn(rank_main, args=(world, port), nprocs=world, join=True)
        print("OK")
''')


def _spec(tmp, **kw) -> str:
    import json

    cases_at = {str([2, 1]): MOE_DP, str([1, 2]): FAMILIES, str([2, 2]): FAMILIES}
    spec = dict(tmp=str(tmp), opt=OPT, train=TRAIN, steps=STEPS, cases=MOE_DP + FAMILIES,
                cases_at=cases_at, serve=SERVE, serve_steps=SERVE_STEPS,
                serve_shape=[SERVE_B, SERVE_S, SERVE_MAX], serve_seq=SERVE_SEQ,
                seq_shape=[SEQ_S, SEQ_MAX, SEQ_STEPS], encdec=ENCDEC,
                enc_steps=ENC_STEPS, enc_shape=[ENC_B, ENC_SRC, ENC_T], **kw)
    name = "_".join(f"{k}{v}" for k, v in sorted(kw.items())).replace(" ", "")
    path = Path(tmp) / f"spec_{name}.json"
    path.write_text(json.dumps(spec))
    return str(path)


def _env(devices: int | None = None) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return env


def _finish(proc, what):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, f"{what}: {err[-4000:]}"
    assert "OK" in out, what


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    (tmp / "ref.py").write_text(_REF)
    (tmp / "port.py").write_text(_PORT)
    rng = np.random.default_rng(11)
    cfg = get_config(ENCDEC).smoke()
    np.savez(tmp / "encdec_batch.npz", **{
        f"{k}{i}": v for i in range(ENC_STEPS) for k, v in (
            ("src_embeds", rng.standard_normal((ENC_B, ENC_SRC, cfg.d_model)).astype(np.float32)),
            ("inputs", rng.integers(0, cfg.vocab_size, (ENC_B, ENC_T)).astype(np.int32)),
            ("targets", rng.integers(0, cfg.vocab_size, (ENC_B, ENC_T)).astype(np.int32)))})
    np.savez(tmp / "serve_tokens.npz",
             prompt=rng.integers(0, 256, (SERVE_B, SERVE_S)).astype(np.int32),
             **{f"token{i}": rng.integers(0, 256, (SERVE_B, 1)).astype(np.int32)
                for i in range(SERVE_STEPS)},
             seq_prompt=rng.integers(0, 256, (4, SEQ_S)).astype(np.int32),
             **{f"seq_token{i}": rng.integers(0, 256, (4, 1)).astype(np.int32)
                for i in range(SEQ_STEPS)})
    py = sys.executable
    init = subprocess.run([py, str(tmp / "ref.py"), _spec(tmp, job="init")], env=_env(1),
                          cwd=str(tmp), capture_output=True, text=True, timeout=600)
    assert init.returncode == 0, init.stderr[-4000:]
    procs = [
        (subprocess.Popen([py, str(tmp / "ref.py"), _spec(tmp, job="train", mesh=m, **extra)],
                          env=_env(m[0] * m[1]), cwd=str(tmp), stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True), f"reference {m}")
        for m, extra in (([2, 1], {"spread": 1}), ([1, 2], {"encdec_here": 1}),
                         ([2, 2], {"encdec_here": 1, "serve_here": 1}))]
    procs += [(subprocess.Popen([py, str(tmp / "port.py"), _spec(tmp, world=w)], env=_env(),
                                cwd=str(tmp), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True), f"port world {w}")
              for w in (2, 4)]
    try:
        for proc, what in procs:
            _finish(proc, what)
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
    out = {"ref": {m: dict(np.load(tmp / f"ref_{m}.npz")) for m in ("2x1", "1x2", "2x2")},
           "port": {(w, r): dict(np.load(tmp / f"port_w{w}_r{r}.npz"))
                    for w in (2, 4) for r in range(w)}}
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def _ranks(runs, world):
    return [runs["port"][world, r] for r in range(world)]


# ------------------------------------------------------------ primitives

def test_primitives_forward_and_backward_on_two_ranks(runs):
    x = [np.arange(6.0).reshape(2, 3) + 10 * r for r in (0, 1)]
    weight = np.ones((2, 3)).cumsum(-1)             # d loss / d y on rank r: w (r + 1)
    for r, got in enumerate(_ranks(runs, 2)):
        assert list(got["prim/model_rank"]) == [r, 2]
        np.testing.assert_array_equal(got["prim/copy/y"], x[r])
        np.testing.assert_array_equal(got["prim/copy/g"], weight * (1 + 2))
        np.testing.assert_array_equal(got["prim/reduce/y"], x[0] + x[1])
        np.testing.assert_array_equal(got["prim/reduce/g"], weight * (r + 1))
        np.testing.assert_array_equal(got["prim/gather/y"], np.concatenate(x, -1))
        full_w = np.ones((2, 6)).cumsum(-1) * (r + 1)
        np.testing.assert_array_equal(got["prim/gather/g"], full_w[:, 3 * r:3 * r + 3])
        np.testing.assert_array_equal(got["prim/max"], np.maximum(x[0], -x[1]))
        np.testing.assert_array_equal(got["prim/mean/y"], (x[0] + x[1]) / 2)
        np.testing.assert_array_equal(got["prim/mean/g"], np.full((2, 3), (1 + 2) / 2))
        np.testing.assert_array_equal(got["prim/counts"], [[[0, 7]], [[1, 7]]])


# --------------------------------------------------- Trainers, the reference

def _hold_trainer(ref, port_ranks, case, *, spread=False):
    """Losses at rtol 1e-5; every parameter within a tenth of the learning
    rate, widened, with ``spread``, elementwise by the reference's own
    difference between this mesh and one device."""
    want = ref[f"{case}/losses"]
    for got in port_ranks:
        np.testing.assert_allclose(got[f"{case}/losses"], want, rtol=1e-5, err_msg=case)
        names = [k[len(case) + 3:] for k in got if k.startswith(f"{case}/p/")]
        assert names and sorted(names) == sorted(
            k[len(case) + 3:] for k in ref if k.startswith(f"{case}/p/"))
        for k in names:
            w = ref[f"{case}/p/{k}"]
            atol = LR / 10 + (np.abs(w - ref[f"{case}/p1/{k}"]) if spread else 0.0)
            bad = np.abs(got[f"{case}/p/{k}"] - w) > atol + 1e-5 * np.abs(w)
            assert not bad.any(), (f"{case}: {k}: {int(bad.sum())} elements beyond "
                                   f"the bound, max |diff| "
                                   f"{float(np.abs(got[f'{case}/p/{k}'] - w).max()):.3e}")


@pytest.mark.parametrize("case", [c[0] for c in MOE_DP])
def test_moe_at_dp2_matches_the_reference_trainer_when_tokens_drop(runs, case):
    """Capacity factor 1.0 drops tokens: the port's routing over the global
    microbatch (counts gathered over the data axis) and its aux loss over
    global means give the reference's losses and parameters at (2, 1).

    One element of layer 0's q has a first-step gradient of ~1.8e-8, at
    AdamW's eps (1e-8), where the update's sign and size follow the
    gradient's rounding: the reference itself moves it by ~1.07e-4 (more
    than a tenth of the learning rate) between one device and two.  So the
    parameters are held within lr / 10 plus the reference's own difference
    between those two meshes, element by element."""
    _hold_trainer(runs["ref"]["2x1"], _ranks(runs, 2), case, spread=True)


@pytest.mark.parametrize("case", [c[0] for c in FAMILIES])
@pytest.mark.parametrize("mesh,world", [("1x2", 2), ("2x2", 4)])
def test_trainer_over_the_model_axis_matches_the_reference(runs, case, mesh, world):
    _hold_trainer(runs["ref"][mesh], _ranks(runs, world), case)


def test_a_rank_holds_its_model_shards_only(runs):
    cfg = get_config("stablelm-1.6b").smoke()
    for got in _ranks(runs, 2) + _ranks(runs, 4):
        q = got["dense/local_shape/layers.0.attn.q"]
        assert list(q) == [cfg.d_model, cfg.n_heads // 2, cfg.head_dim]
        assert list(got["dense/local_shape/lm_head"]) == [cfg.d_model, cfg.vocab_size // 2]
        assert list(got["dense/local_shape/layers.0.mlp.wi"]) == [cfg.d_model, cfg.d_ff // 2]
        experts = got["moe_shardmap/local_shape/layers.1.moe.experts.wi"]
        assert experts[0] == get_config("deepseek-moe-16b").smoke().n_experts // 2
        # recurrentgemma-9b: q split, its one kv head whole, the width split
        rg = get_config("recurrentgemma-9b").smoke()
        assert list(got["rglru/local_shape/layers.4.attn.k"]) == [rg.d_model, 1, rg.head_dim]
        assert list(got["rglru/local_shape/layers.4.attn.q"]) == [rg.d_model, rg.n_heads // 2,
                                                                   rg.head_dim]
        assert list(got["rglru/local_shape/layers.0.rglru.wa"]) == [rg.d_rnn, rg.d_rnn // 2]


@pytest.mark.parametrize("mesh,world", [("1x2", 2), ("2x2", 4)])
def test_encdec_sharded_step_matches_the_reference_step(runs, mesh, world):
    ref = runs["ref"][mesh]
    for got in _ranks(runs, world):
        for i in range(ENC_STEPS):
            np.testing.assert_allclose(got[f"encdec/loss{i}"], ref[f"encdec/loss{i}"],
                                       rtol=1e-5)
        keys = [k for k in ref if k.startswith("encdec/p/")]
        assert keys and len(keys) == len([k for k in got if k.startswith("encdec/p/")])
        for k in keys:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=LR / 10, err_msg=k)


# --------------------------------------------------------------- serving

SEQ_CASES = {c[0]: c for c in SERVE_SEQ}


@pytest.mark.parametrize("case", [c[0] for c in SERVE] + list(SEQ_CASES))
def test_serving_steps_at_tp2_match_the_reference(runs, case):
    ref = runs["ref"]["2x2"]
    B, steps = (SEQ_CASES[case][3], SEQ_STEPS) if case in SEQ_CASES else (SERVE_B, SERVE_STEPS)
    for r, got in enumerate(_ranks(runs, 4)):
        data_rank = r // 2
        rows = slice(data_rank * B // 2, (data_rank + 1) * B // 2) if B > 1 else slice(0, 1)
        if case not in SEQ_CASES:
            # the factories return the rank's vocab shard, where output_pspecs puts it
            assert list(got[f"{case}/vocab_shard"]) == [SERVE_B // 2, 1, 128]
        for i in range(steps + 1):
            np.testing.assert_allclose(got[f"{case}/logits{i}"], ref[f"{case}/logits{i}"][rows],
                                       rtol=1e-4, atol=1e-4, err_msg=f"{case} step {i}")


def _rank_shard(a, spec, coords):
    """Rank ``coords`` ({axis: index} on a (2, 2) mesh)'s shard of the
    whole array ``a`` placed by ``spec``: DTensor's split, each axis in turn."""
    from repro_torch.models.tensor_parallel import shard_span

    for d, entry in enumerate(spec):
        names = () if entry is None else ((entry,) if isinstance(entry, str) else entry)
        first, n = shard_span(a.shape[d], [2] * len(names), [coords[x] for x in names])
        a = a[(slice(None),) * d + (slice(first, first + n),)]
    return a


def test_serving_factories_refuse_sequence_sharded_caches(runs):
    """Named for what it held before the port served sequence-sharded
    caches (the factories raised).  Now: each rank's caches after prefill
    and after the last decode step, for every ``SERVE_SEQ`` case, equal the
    reference's output caches restricted to that rank's shard under
    ``output_pspecs`` (under the by-hand sequence axes for the last two
    cases) within 1e-4: which rank wrote which slot, every kv head on a rank
    whose span the sequence is, unwritten slots zero in both."""
    from repro_torch.launch import sharding as shd

    ref = runs["ref"]["2x2"]
    mesh = {"data": 2, "model": 2}
    for case, arch, changes, B, by_hand in SERVE_SEQ:
        cfg = get_config(arch).smoke().replace(**changes)
        want_seq = tuple(by_hand) if by_hand else shd.cache_seq_axes(cfg, mesh, B)
        assert want_seq and "data" not in shd.cache_seq_axes(cfg, mesh, B)
        for r, got in enumerate(_ranks(runs, 4)):
            coords = {"data": r // 2, "model": r % 2}
            assert tuple(got[f"{case}/seq_axes"]) == want_seq
            keys = [k for k in ref if k.startswith(f"{case}/cache")]
            assert keys and sorted(keys) == sorted(k for k in got if k.startswith(f"{case}/cache"))
            for k in keys:
                whole = ref[k]
                spec = list(shd.output_pspecs(cfg, ShapeSpec("serve", SEQ_MAX, B, "decode"),
                                              {"caches": [{k.rsplit("/", 1)[1]: whole}]},
                                              mesh)["caches"][0][k.rsplit("/", 1)[1]])
                if by_hand and k.endswith(("/k", "/v")):
                    spec[2] = tuple(by_hand)
                np.testing.assert_allclose(got[k], _rank_shard(whole, spec, coords),
                                           rtol=1e-4, atol=1e-4, err_msg=f"{k} on rank {r}")


# --------------------------------------------------------------- dry-run

MESH_4X2 = {"data": 4, "model": 2}
ONE = {"data": 1, "model": 1}


def _flops(arch, kind, mesh):
    seq, batch = (16, 8)
    cell = dryrun.run_cell(get_config(arch).smoke(), ShapeSpec(f"tp_{kind}", seq, batch, kind),
                           False, mesh=mesh)
    assert cell["status"] == "ok", cell["status"]
    return cell


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_dryrun_dense_flops_split_over_the_model_axis(kind):
    """stablelm-1.6b: every matmul (q, k, v, o, the MLP, the scores, the
    logits) splits over model, so the replicated share is 0 and a device of
    4 x 2 does one eighth of one device's FLOPs (its rows are a quarter)."""
    one, split = _flops("stablelm-1.6b", kind, ONE), _flops("stablelm-1.6b", kind, MESH_4X2)
    assert split["tp_compute"] == "model" and one["tp_compute"] == "model"
    np.testing.assert_allclose(split["cost"]["flops"] * 8, one["cost"]["flops"], rtol=1e-12)


def test_dryrun_replicated_share_of_an_ssm():
    """mamba2-130m: the rules replicate the SSM, so its FLOPs divide only by
    the data split; the tied logits (the last position's, prefill) split
    over model too."""
    cfg = get_config("mamba2-130m").smoke()
    one, split = _flops("mamba2-130m", "prefill", ONE), _flops("mamba2-130m", "prefill", MESH_4X2)
    logits = 2 * 8 * cfg.d_model * cfg.vocab_size
    want = (one["cost"]["flops"] - logits) / 4 + logits / 8
    np.testing.assert_allclose(split["cost"]["flops"], want, rtol=1e-12)
    assert split["tp_compute"] == "model"


def _local_nbytes(shape, itemsize, spec, sizes):
    """Bytes of rank 0's shard of a tensor placed by ``spec``."""
    n = itemsize
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        names = () if entry is None else ((entry,) if isinstance(entry, str) else entry)
        n *= -(-size // int(np.prod([sizes[a] for a in names])))
    return n


def test_dryrun_item_25_serving_cell_is_replicated():
    """Named for what it held before the port served sequence-sharded
    caches (the cell ran replicated).  Now recurrentgemma-9b's smoke
    prefill and decode cells at 4 x 2 split over ``model`` (its one kv
    head: the caches' sequence over ``model``).  Per device the k and v
    projections, whose weights the rules replicate and which every rank
    computes for its cache, divide by the data split only; the rest (q, o,
    the attention over a rank's heads or span, the RG-LRU's width, the
    MLP, the vocab-parallel logits) by 8.  The decode cell's argument bytes
    are the rules' shards of the parameters and inputs."""
    from torch.utils._pytree import tree_flatten

    from repro_torch.configs.shapes import input_specs
    from repro_torch.launch import sharding as shd
    from repro_torch.models.lm import layer_kinds
    from repro_torch.models.weights import empty

    cfg = get_config("recurrentgemma-9b").smoke()
    attn = sum(k == "local" for k in layer_kinds(cfg))
    for kind, tokens in (("prefill", 8 * 16), ("decode", 8)):
        one, split = _flops("recurrentgemma-9b", kind, ONE), _flops("recurrentgemma-9b", kind,
                                                                     MESH_4X2)
        assert split["tp_compute"] == "model" and one["tp_compute"] == "model"
        kv = 2 * 2 * tokens * cfg.d_model * cfg.n_kv_heads * cfg.head_dim * attn
        want = (one["cost"]["flops"] - kv) / 8 + kv / 4
        np.testing.assert_allclose(split["cost"]["flops"], want, rtol=1e-12, err_msg=kind)
    shape = ShapeSpec("tp_decode", 16, 8, "decode")
    params = {k: p for k, p in empty(cfg, device="meta").named_parameters()}
    p_specs = shd.param_pspecs(cfg, params, MESH_4X2)
    specs = input_specs(cfg, shape)
    b_specs = shd.input_pspecs(cfg, shape, specs, MESH_4X2)

    def leaves(tree):
        return tree_flatten(tree, is_leaf=lambda x: isinstance(x, shd.P))[0]

    want = sum(_local_nbytes(p.shape, p.element_size(), p_specs[k], MESH_4X2)
               for k, p in params.items())
    want += sum(_local_nbytes(t.shape, t.element_size(), sp, MESH_4X2)
                for t, sp in zip(leaves(specs), leaves(b_specs)))
    assert split["memory"]["argument_size_in_bytes"] == want
    train = _flops("recurrentgemma-9b", "train", MESH_4X2)
    assert train["tp_compute"] == "model"


def test_dryrun_long_context_cache_bytes_follow_the_rules():
    """A long_500k-style cell, B 1, on a fake 4 x 2 mesh: the rules shard
    each kv cache's sequence over ``model`` only (``batch_axes`` is () at
    B 1, not None, so not over ``data``), so the caches a device returns
    are a model-th of the whole; the recurrent state and the logits are
    split over ``model`` by width and vocab."""
    cfg = get_config("recurrentgemma-9b").smoke()
    shape = ShapeSpec("tp_long", 64, 1, "decode")
    one = dryrun.run_cell(cfg, shape, False, mesh=ONE)
    split = dryrun.run_cell(cfg, shape, False, mesh=MESH_4X2)
    assert split["status"] == "ok" and split["tp_compute"] == "model"
    assert one["memory"]["output_size_in_bytes"] == 2 * split["memory"]["output_size_in_bytes"]
