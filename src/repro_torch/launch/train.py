"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --smoke --device cpu --steps 20 --resume auto

Without ``--device`` it trains on the CUDA card and raises without one.
``--smoke`` selects the reduced same-family config; without it the config
trains at published width and depth.  ``--micro`` is the accumulation
depth.  Auto-resume: with ``--resume auto`` the trainer continues from the
newest valid checkpoint in ``--ckpt-dir``, surviving a kill at any point.
``--mesh dp,tp`` lays the process group's ranks out as (data, model); the
default puts them all on ``data``.  :func:`main` returns the run's summary, so that callers can run
it in-process.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import ARCHS, get_config
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.train_loop import Trainer, TrainerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="stablelm-1.6b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="auto", choices=["auto", "none"])
    ap.add_argument("--mesh", default="", help="dp,tp (default: all ranks DP)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--log", default="artifacts/train_log.jsonl")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    mesh_shape = tuple(int(x) for x in args.mesh.split(",")) if args.mesh else ()
    tcfg = TrainerConfig(
        global_batch=args.batch,
        seq_len=args.seq,
        n_microbatches=args.micro,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        log_every=args.log_every,
        mesh_shape=mesh_shape,
        opt=AdamWConfig(peak_lr=args.lr, total_steps=args.steps),
        device=args.device,
    )
    trainer = Trainer(cfg, tcfg)
    out = trainer.run(args.steps, resume=args.resume == "auto")
    trainer.save_log(args.log)
    first = next((r["loss"] for r in out["log"]), float("nan"))
    print(
        f"arch={cfg.name} steps={args.steps} "
        f"loss {first:.4f} -> {out['final_loss']:.4f} "
        f"(log: {args.log}, ckpts: {args.ckpt_dir})"
    )
    return {**out, "arch": cfg.name, "steps": args.steps, "first_loss": first,
            "n_microbatches": tcfg.n_microbatches, "trainer": trainer}


if __name__ == "__main__":
    main()
