"""End-to-end training on the PyTorch port: a ~13M-parameter granite-family
model, with checkpointing, an injected mid-run crash, auto-resume, and the
resumed parameters equal bit for bit to an uninterrupted run (run here too).

This is the Trainer's full path (microbatches, atomic async checkpoints,
stateless data, sharded storage on a mesh of the process group's ranks)
at example scale; the attention forward runs through the
``flash_attention`` kernel on the card.

Run:  PYTHONPATH=src python examples/torch_train_e2e.py [--device cpu] [--smoke] [--fast]

It trains on the CUDA card unless ``--device cpu`` is given, under
``torch.use_deterministic_algorithms(True)`` so that the resumed run can
equal the uninterrupted one on the card.  300 steps of 8 x 256 tokens;
``--fast`` 120; ``--smoke`` 12 steps of 8 x 64 (the mechanics, not the
learning).
"""

import argparse
import os
import shutil
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import Trainer, TrainerConfig


def config():
    return get_config("granite-3-8b").replace(
        name="granite-13m",
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, head_dim=32,
        d_ff=1024, vocab_size=2048, dtype="float32",
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="train, crash, resume")
    ap.add_argument("--device", default=None,
                    help="where the model trains (default: the CUDA card)")
    ap.add_argument("--smoke", action="store_true", help="12 steps")
    ap.add_argument("--fast", action="store_true", help="120 steps")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_e2e_ckpt"))
    ap.add_argument("--log", default="artifacts/torch_train_e2e_log.jsonl")
    args = ap.parse_args(argv)
    # cuBLAS reads this at its first call: set before any work on the card
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return _run(args)
    finally:
        torch.use_deterministic_algorithms(was)


def _run(args) -> dict:
    steps = 12 if args.smoke else 120 if args.fast else 300
    cfg = config()
    tcfg = TrainerConfig(
        global_batch=8, seq_len=64 if args.smoke else 256, n_microbatches=2,
        ckpt_dir=args.ckpt_dir, ckpt_every=4 if args.smoke else 40,
        async_ckpt=True, log_every=2 if args.smoke else 20,
        opt=AdamWConfig(peak_lr=1e-3, warmup_steps=30, total_steps=steps),
        fail_at_step=steps // 2,              # injected crash mid-run
        device=args.device,
    )
    first = Trainer(cfg, tcfg)
    n_params = sum(p.numel() for p in first._example["params"].values())
    print(f"model: {cfg.name}  params={n_params/1e6:.1f}M  steps={steps}")

    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    print(f"\n-- phase 1: train until the injected crash at step {steps // 2} --")
    try:
        first.run(steps, resume=False)
    except RuntimeError as e:
        print(f"   crashed as planned: {e}")

    print("-- phase 2: auto-resume from the newest valid checkpoint --")
    resumed_at = max(first.ckpt.all_steps()) + 1
    tcfg2 = TrainerConfig(**{**tcfg.__dict__, "fail_at_step": None})
    trainer = Trainer(cfg, tcfg2)
    out = trainer.run(steps, resume=True)
    trainer.save_log(args.log)

    print("-- phase 3: the same steps uninterrupted, in a directory of its own --")
    ref_dir = args.ckpt_dir + "_uninterrupted"
    shutil.rmtree(ref_dir, ignore_errors=True)
    ref = Trainer(cfg, TrainerConfig(**{**tcfg2.__dict__, "ckpt_dir": ref_dir})).run(
        steps, resume=False)
    shutil.rmtree(ref_dir, ignore_errors=True)
    equal = all(torch.equal(out["params"][k], p) for k, p in ref["params"].items())
    equal = equal and out["final_loss"] == ref["final_loss"]
    print(f"   resumed at step {resumed_at}; parameters and final loss "
          f"{'equal bit for bit' if equal else 'DIFFER'} to the uninterrupted run")

    log = out["log"]
    head, last = first.metrics_log[0], log[-1]
    drop = head["loss"] - last["loss"]
    print(f"\nloss: step {head['step']}: {head['loss']:.4f}  ->  "
          f"step {last['step']}: {last['loss']:.4f}")
    print(f"loss drop: {drop:.4f} ({'learning OK' if drop > 0.3 else 'WEAK'})  "
          f"straggler events: {len(trainer.straggler_events)}")
    if not equal:
        raise AssertionError("the resumed run differs from the uninterrupted one")
    if not args.smoke:
        assert drop > 0.1, "model failed to learn the synthetic structure"
    print(f"{args.log} written; checkpoints in {args.ckpt_dir}")
    return {"cfg": cfg, "n_params": n_params, "steps": steps, "resumed_at": resumed_at,
            "out": out, "uninterrupted": ref, "equal": equal, "loss_drop": drop,
            "first_log": first.metrics_log}


if __name__ == "__main__":
    main()
