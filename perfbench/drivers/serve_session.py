"""Driver ``serve_session``: document QA over sessions that keep their
caches across turns, through the program's ``Server.open_batch`` and
``BatchSession.turn`` (each turn rewinds to the document's end, feeds the
question through the replayed decode step, then decodes the answer).

Traffic (the workload's ``traffic``): ``rows`` sessions over
``documents`` distinct documents of ``doc_tokens`` tokens (session r reads
document r mod ``documents``), drawn uniformly from the vocabulary on the
device from the seed; caches of ``doc_tokens + question_tokens +
answer_tokens`` positions.  Each item is one turn: every session asks a new
question of ``question_tokens`` tokens, drawn from the seed (every session
and turn its own), and gets ``answer_tokens`` greedy tokens.

Set-up loads the weights the harness drew (in the config's compute dtype;
the file's keys are the source's, read by :mod:`perfbench.mla_weights`),
opens the batch (one prefill a document) and runs one warm turn (the eager
first decode step and the graph's capture).  The check draws from the seed
``check_batches`` of the window's turns (always the last) and
``check_rows`` sessions of each, frees the program, and runs the plain
float32 reference over each drawn session's [document, question, answer
without its last token]: the mean gap by which a served answer token's
reference logit lies below the reference's best is the number compared.
"""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass, field

import torch

from perfbench import compare, mla_weights, port
from perfbench.drivers.serve_batch import capacity, draw
from perfbench.reference import lm as ref_lm
from perfbench.reference import mla as ref_mla
from perfbench.reference import serve as ref_serve

DOCUMENTS, QUESTIONS, WARM = 5, 6, 7

__all__ = ["check", "draw", "free", "item", "positions", "setup"]


@dataclass
class State:
    ctx: object
    traffic: dict
    server: object = None
    session: object = None
    outputs: dict = field(default_factory=dict)


def documents(ctx, traffic: dict) -> torch.Tensor:
    return mla_weights.tokens(ctx.seed, DOCUMENTS, 0,
                              (traffic["documents"], traffic["doc_tokens"]),
                              ctx.config["vocab_size"], ctx.device)


def questions(ctx, traffic: dict, index: int, stream: int = QUESTIONS) -> torch.Tensor:
    return mla_weights.tokens(ctx.seed, stream, index,
                              (traffic["rows"], traffic["question_tokens"]),
                              ctx.config["vocab_size"], ctx.device)


def doc_of(traffic: dict, row: int) -> int:
    return row % traffic["documents"]


def setup(ctx) -> State:
    from repro_torch.models.opt_flags import get_flags
    from repro_torch.runtime.serve_loop import Server

    t = ctx.workload["traffic"]
    cfg = mla_weights.port_config(ctx.config)
    if get_flags().moe_impl != t.get("moe_impl", "einsum"):
        raise RuntimeError(f"the program's MoE dispatch is {get_flags().moe_impl!r}")
    dtype = getattr(torch, cfg.dtype)
    w = mla_weights.make(mla_weights.flat(ctx.config), ctx.seed, dtype, ctx.device)
    model = port.load_model(cfg, w, ctx.device, dtype)
    del w
    turn_tokens = t["question_tokens"] + t["answer_tokens"]
    s = State(ctx=ctx, traffic=t,
              server=Server(cfg, model, max_len=t["doc_tokens"] + turn_tokens,
                            device=ctx.device))
    rows = documents(ctx, t)[[doc_of(t, r) for r in range(t["rows"])]]
    s.session = s.server.open_batch(rows.cpu().numpy(), turn_tokens)
    s.session.turn(questions(ctx, t, 0, WARM).cpu().numpy(), t["answer_tokens"])
    return s


def item(s: State, i: int) -> dict:
    t = s.traffic
    q = questions(s.ctx, t, i).cpu().numpy()
    t0 = time.perf_counter()
    out = s.session.turn(q, t["answer_tokens"])
    t1 = time.perf_counter()
    s.outputs[i] = out["output"]
    return {"t_start": t0, "t_end": t1,
            "tokens": t["rows"] * (t["question_tokens"] + t["answer_tokens"]),
            "decode_s": out["decode_s"], "capture_s": out["capture_s"],
            "steps": out["steps"], "latent_slots_read": out["latent_slots_read"],
            "failed": out["output"].shape != (t["rows"], t["answer_tokens"])}


def free(s: State) -> None:
    """Drop the sessions (their caches and graph) and the program."""
    s.session = s.server = None
    gc.collect()
    if s.ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def positions(ctx, traffic: dict, outputs: dict, picks, precs=("fp32",), *,
              norms: bool = True) -> list:
    """For each document among the checked sessions: the reference's logits
    at every answer position of its checked (turn, session) pairs for each
    precision in ``precs``, and the served tokens.  ``norms`` False sets
    every norm's scale to 1 (a reading of what the check sees when norm
    weights are ignored)."""
    ref_lm.fp32_matmuls()
    cfg = mla_weights.flat(ctx.config)
    w = mla_weights.make(cfg, ctx.seed, getattr(torch, cfg["dtype"]), ctx.device)
    if not norms:
        for k, v in w.items():
            if k.endswith(".scale"):
                v.fill_(1.0)
    docs = documents(ctx, traffic)
    q_len = traffic["question_tokens"]
    by_doc: dict[int, list] = {}
    for turn, rows in picks:
        qs = questions(ctx, traffic, turn)
        served = torch.as_tensor(outputs[turn], dtype=torch.long, device=ctx.device)
        for r in rows:
            by_doc.setdefault(doc_of(traffic, r), []).append(
                (torch.cat([qs[r], served[r, :-1]]), served[r]))
    cap = capacity(cfg, traffic["doc_tokens"])
    out = []
    for d, pairs in sorted(by_doc.items()):
        follows = torch.stack([f for f, _ in pairs])
        chosen = torch.cat([c for _, c in pairs])
        got = {prec: ref_mla.chosen_logits(w, cfg, docs[d], follows, q_len - 1, cap,
                                           ref_lm.Precision(prec)) for prec in precs}
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
