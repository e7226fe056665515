"""Driver ``train``: training steps of the program's
``launch.steps.make_train_step`` (gradient accumulation over microbatches,
fp32 master weights, the program's AdamW).

Traffic (the workload's ``traffic``): ``rows`` x ``seq`` tokens a step in
``microbatches``, drawn uniformly from the vocabulary on the device from
the seed, every row and step distinct; ``optimizer``: AdamW's settings.

Set-up builds one training step object (model, optimizer state) from the
seed and runs its first ``follow_steps`` steps through the same call and
feed the window uses; the window continues with that object.  The check
follows those first steps with the plain reference in float32 and compares
each step's loss, each leaf's first clipped gradient (the program's worked
out from its first moment after one step) and each leaf's change after the
last of them, by the worst leaf.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import torch

from perfbench import compare, port, weights
from perfbench.reference import lm as ref_lm
from perfbench.reference import train as ref_train

TOKENS = 1


@dataclass
class State:
    ctx: object
    traffic: dict
    model: object = None
    opt_state: dict = None
    step: object = None
    program: dict = field(default_factory=lambda: {"losses": []})


def batch(ctx, traffic: dict, index: int):
    rows, seq = traffic["rows"], traffic["seq"]
    ids = weights.tokens(ctx.seed, TOKENS, index, (rows, seq + 1),
                         ctx.config["vocab_size"], ctx.device)
    return {"inputs": ids[:, :-1], "targets": ids[:, 1:]}


def leaf_norms(tensors: dict, scale: float = 1.0) -> dict:
    return {k: float(v.float().norm()) * scale for k, v in tensors.items()}


def setup(ctx) -> State:
    from repro_torch.launch import steps
    from repro_torch.optim import AdamWConfig, adamw_init

    traffic = ctx.workload["traffic"]
    cfg = port.port_config(ctx.config)
    w = weights.make(ctx.config, ctx.seed, torch.float32, ctx.device)
    model = port.load_model(cfg, w, ctx.device, torch.float32)
    del w
    opt = AdamWConfig(**traffic["optimizer"])
    s = State(ctx=ctx, traffic=traffic, model=model,
              opt_state=adamw_init(dict(model.named_parameters())),
              step=steps.make_train_step(cfg, opt, traffic["microbatches"]))
    for i in range(traffic["follow_steps"]):
        s.model, s.opt_state, metrics = s.step(s.model, s.opt_state, batch(ctx, traffic, i))
        s.program["losses"].append(float(metrics["loss"]))
        if i == 0:
            s.program["grad_norms"] = leaf_norms(s.opt_state["m"], 1 / (1 - opt.b1))
    w0 = weights.make(ctx.config, ctx.seed, torch.float32, ctx.device)
    with torch.no_grad():
        s.program["change_norms"] = {k: float((p - w0[k]).norm())
                                     for k, p in s.model.named_parameters()}
    del w0
    return s


def item(s: State, i: int) -> dict:
    t0 = time.perf_counter()
    s.model, s.opt_state, metrics = s.step(
        s.model, s.opt_state, batch(s.ctx, s.traffic, s.traffic["follow_steps"] + i))
    loss = float(metrics["loss"])
    t1 = time.perf_counter()
    return {"t_start": t0, "t_end": t1, "tokens": s.traffic["rows"] * s.traffic["seq"],
            "loss": loss, "failed": not (loss == loss)}


def free(s: State) -> None:
    s.model = s.opt_state = s.step = None
    if s.ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def reference(ctx, traffic: dict, prec: str = "fp32", rows: slice | None = None) -> dict:
    """The plain reference through the first ``follow_steps`` steps (on
    ``rows`` of each batch only, when given)."""
    ref_lm.fp32_matmuls()
    w0 = weights.make(ctx.config, ctx.seed, torch.float32, ctx.device)
    batches = []
    for i in range(traffic["follow_steps"]):
        b = batch(ctx, traffic, i)
        sl = rows or slice(None)
        batches.append((b["inputs"][sl], b["targets"][sl]))
    out = ref_train.follow(w0, batches, ctx.config, traffic["optimizer"],
                           traffic["microbatches"], ref_lm.Precision(prec))
    del w0
    return out


def check(s: State, records: list) -> list[dict]:
    free(s)
    ref = reference(s.ctx, s.traffic)
    checks = compare.training(s.program, ref, s.ctx.workload["limits"])
    print(f"losses {s.program['losses']} (reference {ref['losses']}); worst leaves "
          f"{checks[1]['leaf']}, {checks[2]['leaf']}; leaves left out of the change "
          f"{checks[2]['left_out']}", file=sys.stderr)
    return checks
