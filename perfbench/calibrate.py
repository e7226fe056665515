"""Readings that set a cell's limits: ``python3 perfbench/calibrate.py
--workload <cell> --seeds <n,n,...> [--control <n,n,...>]``.

For each seed of ``--seeds`` it runs the program's timed path as a run
does (a training cell's set-up steps; a serving cell's ``check_batches``
batches) and the check's comparison with the float32 reference, and prints
the numbers compared.  For each seed of ``--control`` it also reads the
control: the reference put in the program's place in the next lower
precision than the configuration states (fp8 for bfloat16 compute); for a
serving cell also the reference with every norm's scale 1 and bias 0 in
the program's place (a side that ignores norm weights); and,
for a training cell, the reference run on half of each batch (the mean
over the rest), one of the faults the comparison has to catch.  One JSON
line per seed; a benchmark run never runs this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (os.path.join(ROOT, "src"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def _numbers(checks) -> dict:
    return {c["name"]: c["value"] for c in checks}


def train_seed(driver, ctx, control: bool) -> dict:
    from perfbench import compare

    wl = ctx.workload
    t0 = time.perf_counter()
    s = driver.setup(ctx)
    out = {"setup_s": time.perf_counter() - t0, "losses": s.program["losses"]}
    driver.free(s)
    t0 = time.perf_counter()
    ref = driver.reference(ctx, s.traffic)
    out["reference_s"] = time.perf_counter() - t0
    out["program"] = _numbers(compare.training(s.program, ref, wl["limits"]))
    if control:
        low = driver.reference(ctx, s.traffic, "fp8")
        out["control"] = _numbers(compare.training(low, ref, wl["limits"]))
        half = driver.reference(ctx, s.traffic, rows=slice(0, s.traffic["rows"] // 2))
        out["half_batch"] = _numbers(compare.training(half, ref, wl["limits"]))
        out["unchanged"] = _numbers(compare.training(
            {**s.program, "change_norms": dict.fromkeys(ref["change_norms"], 0.0),
             "grad_norms": dict.fromkeys(ref["grad_norms"], 0.0)}, ref, wl["limits"]))
    return out


def serve_seed(driver, ctx, control: bool) -> dict:
    import torch

    from perfbench.reference.serve import gaps

    t = ctx.workload["traffic"]
    t0 = time.perf_counter()
    s = driver.setup(ctx)
    out = {"setup_s": time.perf_counter() - t0, "batch_s": []}
    records = []
    for i in range(t["check_batches"]):
        rec = driver.item(s, i)
        out["batch_s"].append(rec["t_end"] - rec["t_start"])
        records.append(rec)
    driver.free(s)
    picks = driver.draw(ctx.seed, t, len(records))
    t0 = time.perf_counter()
    precs = ("fp32", "fp8", "bf16") if control else ("fp32",)
    found: dict[str, list] = {"program": [], "control": [], "witness_bf16": []}
    for got, chosen in driver.positions(ctx, t, s.outputs, picks, precs):
        found["program"].append(gaps(got["fp32"], chosen))
        if control:
            found["control"].append(gaps(got["fp32"], got["fp8"].argmax(-1)))
            found["witness_bf16"].append(gaps(got["fp32"], got["bf16"].argmax(-1)))
    out["reference_s"] = time.perf_counter() - t0
    if control:
        found["norms_ignored"] = [
            gaps(got["fp32"], plain["fp32"].argmax(-1)) for (got, _), (plain, _) in zip(
                driver.positions(ctx, t, s.outputs, picks),
                driver.positions(ctx, t, s.outputs, picks, norms=False))]
    for name, parts in found.items():
        if parts:
            out[name] = gap_stats(torch.cat(parts))
    return out


def gap_stats(g) -> dict:
    """Summaries of the gaps at the checked positions."""
    import torch

    g = g.double().cpu()
    q = torch.quantile(g, torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64))
    return {"logit_gap_mean": float(g.mean()), "widest": float(g.max()), "p50": float(q[0]),
            "p90": float(q[1]), "p99": float(q[2]),
            "flipped": float((g > 0).double().mean()), "positions": g.numel()}


def main(argv=None) -> None:
    from perfbench import harness

    ap = argparse.ArgumentParser(prog="perfbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    args = ap.parse_args(argv)
    import torch

    layout = harness.Layout()
    wl = layout.json("workloads", args.workload)
    cfg = layout.json("configs", wl["config"])
    driver = layout.module("drivers", wl["driver"])
    seeds = [int(x) for x in args.seeds.split(",") if x]
    control = {int(x) for x in args.control.split(",") if x}
    for seed in seeds + sorted(control - set(seeds)):
        ctx = harness.Context(workload=wl, config=cfg, seed=seed,
                              device=torch.device("cuda"))
        fn = train_seed if wl["driver"] == "train" else serve_seed
        rec = {"workload": args.workload, "seed": seed, **fn(driver, ctx, seed in control)}
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
