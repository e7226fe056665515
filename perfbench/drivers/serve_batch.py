"""Driver ``serve_batch``: a closed loop of the program's
``Server.throughput_batch`` (one prefill, then greedy decode steps replayed
as a CUDA graph) over batches of ``rows`` prompts of ``prompt`` tokens with
``new_tokens`` new tokens each, caches of ``prompt + new_tokens``.

Prompts are drawn uniformly from the vocabulary on the device from the
seed, every batch distinct.  Set-up loads the weights the harness drew
(in the config's compute dtype) and serves one warm batch of the cell's
rows and prompt length with ``WARM_NEW_TOKENS`` new tokens.  The check draws from the seed ``check_batches`` of the window's
batches and ``check_rows`` rows of each, frees the program, and runs the
plain float32 reference over each drawn batch's prompts (all rows, whose
first token it checks too) and the drawn rows' served tokens: the mean gap
by which a served token's reference logit lies below the reference's best
is the number compared.
"""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from perfbench import compare, port, weights
from perfbench.reference import lm as ref_lm
from perfbench.reference import serve as ref_serve

PROMPTS, WARM, DRAW = 2, 3, 4

#: new tokens of the warm batch: the prefill, the eager first decode step,
#: the graph's capture and replays (a batch's cache is sized for the cell)
WARM_NEW_TOKENS = 4


@dataclass
class State:
    ctx: object
    traffic: dict
    server: object = None
    outputs: dict = field(default_factory=dict)


def prompts(ctx, traffic: dict, index: int, stream: int = PROMPTS) -> torch.Tensor:
    return weights.tokens(ctx.seed, stream, index, (traffic["rows"], traffic["prompt"]),
                          ctx.config["vocab_size"], ctx.device)


def setup(ctx) -> State:
    from repro_torch.models.opt_flags import get_flags
    from repro_torch.runtime.serve_loop import Server

    traffic = ctx.workload["traffic"]
    cfg = port.port_config(ctx.config)
    if cfg.n_experts and get_flags().moe_impl != traffic.get("moe_impl", "einsum"):
        raise RuntimeError(f"the program's MoE dispatch is {get_flags().moe_impl!r}")
    dtype = getattr(torch, cfg.dtype)
    model = port.load_model(cfg, weights.make(ctx.config, ctx.seed, dtype, ctx.device),
                            ctx.device, dtype)
    s = State(ctx=ctx, traffic=traffic,
              server=Server(cfg, model, max_len=traffic["prompt"] + traffic["new_tokens"],
                            device=ctx.device))
    s.server.throughput_batch(prompts(ctx, traffic, 0, WARM).cpu().numpy(),
                              min(WARM_NEW_TOKENS, traffic["new_tokens"]))
    return s


def item(s: State, i: int) -> dict:
    t = s.traffic
    p = prompts(s.ctx, t, i).cpu().numpy()
    t0 = time.perf_counter()
    out = s.server.throughput_batch(p, t["new_tokens"])
    t1 = time.perf_counter()
    s.outputs[i] = out["output"]
    return {"t_start": t0, "t_end": t1, "tokens": t["rows"] * (t["prompt"] + t["new_tokens"]),
            "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
            "capture_s": out["capture_s"], "steps": t["new_tokens"] - 1,
            "failed": out["output"].shape != (t["rows"], t["new_tokens"])}


def capacity(config: dict, tokens: int) -> int | None:
    """The prefill's expert capacity, ``ceil(cf * T * K / E)`` and at
    least 1, over the batch's ``tokens``; None without experts."""
    if not config.get("n_experts", 0):
        return None
    return max(1, math.ceil(config["moe_capacity_factor"] * tokens
                            * config["moe_top_k"] / config["n_experts"]))


def draw(seed: int, traffic: dict, done: int) -> list[tuple[int, list[int]]]:
    """The checked batches (``check_batches`` of the ``done``, always the
    last) and rows (``check_rows`` of each), drawn from the seed."""
    rng = np.random.default_rng(weights.sub_seed(seed, DRAW))
    n = min(traffic["check_batches"], done)
    picked = sorted({done - 1} | set(rng.choice(done - 1, n - 1, replace=False).tolist())
                    if done > 1 else {0})
    return [(b, sorted(rng.choice(traffic["rows"], traffic["check_rows"],
                                  replace=False).tolist())) for b in picked]


def free(s: State) -> None:
    s.server = None
    if s.ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def positions(ctx, traffic: dict, outputs: dict, picks, precs=("fp32",), *,
              norms: bool = True) -> list:
    """For each checked batch: the reference's logits at every chosen
    position for each precision in ``precs``, and the served tokens.
    ``norms`` False sets every norm's scale to 1 and bias to 0 (a reading
    of what the check sees when norm weights are ignored)."""
    ref_lm.fp32_matmuls()
    dtype = getattr(torch, ctx.config.get("dtype", "bfloat16"))
    w = weights.make(ctx.config, ctx.seed, dtype, ctx.device)
    if not norms:
        for k, v in w.items():
            if k.endswith(".scale"):
                v.fill_(1.0)
            elif k.endswith(".bias"):
                v.zero_()
    cap = capacity(ctx.config, traffic["rows"] * traffic["prompt"])
    out = []
    for b, rows in picks:
        served = torch.as_tensor(outputs[b], dtype=torch.long, device=ctx.device)
        got = {}
        for prec in precs:
            got[prec], chosen = ref_serve.chosen_logits(
                w, ctx.config, prompts(ctx, traffic, b), served, rows, cap,
                ref_lm.Precision(prec))
        out.append((got, chosen))
    return out


def check(s: State, records: list) -> list[dict]:
    free(s)
    picks = draw(s.ctx.seed, s.traffic, len(records))
    gaps = torch.cat([ref_serve.gaps(got["fp32"], chosen)
                      for got, chosen in positions(s.ctx, s.traffic, s.outputs, picks)])
    print(f"positions checked {gaps.numel()}, widest gap {float(gaps.max())!r} "
          f"(not compared), gap above 0 at {int((gaps > 0).sum())}", file=sys.stderr)
    return compare.serving(gaps, s.ctx.workload["limits"])
