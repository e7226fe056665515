"""Tiny cells for the CPU tests: the benchmark's two configurations cut to
a few narrow layers, their workloads at a few rows, and a
``BENCHMARK.json`` that lists them, written into a directory the caller
gives (a test's temporary directory, never the repository).  The run
itself is the benchmark's, on the CPU."""

from __future__ import annotations

import json
from pathlib import Path

from perfbench.harness import ROOT, Layout, parse, run

TINY = dict(d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, vocab_size=256,
            dtype="float32")

#: limits for the tiny cells, between what sound float32 runs of the
#: program read there (under 1e-6) and what the fp8 control reads (over 3e-3)
TINY_LIMITS = {"loss_gap": 1e-4, "grad_norm_gap": 1e-4, "change_norm_gap": 1e-4,
               "logit_gap_mean": 1e-3}


def _read(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def write(tmp: Path) -> Layout:
    """Write the tiny cells ``tiny.train`` and ``tiny.serve`` under ``tmp``
    and return the layout that finds them (then the benchmark's files)."""
    tmp = Path(tmp)
    pb = ROOT / "perfbench"
    for d in ("configs", "workloads", "metrics", "drivers"):
        (tmp / "perfbench" / d).mkdir(parents=True, exist_ok=True)
    dense = {**_read(pb / "configs/stablelm-1.6b.json"), **TINY, "n_layers": 2,
             "d_ff": 128}
    moe = {**_read(pb / "configs/deepseek-moe-16b.json"), **TINY, "n_layers": 3,
           "d_ff": 32, "d_expert": 32, "n_experts": 8, "moe_top_k": 2,
           "n_shared_experts": 1, "d_ff_dense": 128}
    train = _read(pb / "workloads/stablelm-1.6b.train-2k.json")
    train["config"] = "tiny-dense"
    train["traffic"].update(rows=4, seq=32)
    serve = _read(pb / "workloads/deepseek-moe-16b.prefill-heavy.json")
    serve["config"] = "tiny-moe"
    serve["traffic"].update(rows=4, prompt=16, new_tokens=6, check_batches=2,
                            check_rows=2)
    for wl in (train, serve):
        wl["limits"] = {k: TINY_LIMITS[k] for k in wl["limits"]}
    files = {"configs/tiny-dense.json": dense, "configs/tiny-moe.json": moe,
             "workloads/tiny.train.json": train, "workloads/tiny.serve.json": serve}
    for name, data in files.items():
        (tmp / "perfbench" / name).write_text(json.dumps(data))
    bench = _read(ROOT / "BENCHMARK.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        for cell, tiny_cell in (("train-2k", "tiny.train"), ("prefill-heavy", "tiny.serve")):
            if any(w.endswith(cell) for w in m.get("workloads", ())):
                m["workloads"].append(tiny_cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return Layout(root=tmp, dirs=(tmp / "perfbench", pb))


def run_cell(layout: Layout, cell: str, *, seed: int = 2**31 + 7, seconds: float = 0.3,
             trace: int = 0) -> dict:
    """One run of ``cell`` on the CPU, as the benchmark makes it on the card."""
    args = parse(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                  "--trace", str(trace)])
    return run(args, layout, device="cpu")
