"""The typed API tour on the PyTorch port: one facade, per-phase costs,
phase-aware what-ifs.

Everything the paper computes, through ``repro_torch.api`` +
``repro_torch.spec``:

1. SPEC     a typed JobSpec (Tables 1-3 as one value).
2. MODEL    one config -> a CostReport whose fields carry paper Eq numbers.
3. SWEEP    a batched report; phases sum to Eq. 98's total.
4. TUNE     coordinate descent over an axis-validated space.
5. SERVE    async phase-level what-if: "which config minimizes *shuffle*
            time, subject to total job cost <= budget?".

Run:  PYTHONPATH=src python examples/torch_phase_whatif.py [--device cpu] [--smoke]

The evaluator runs on the CUDA card unless ``--device cpu`` is given.  The
walkthrough is model evaluations only and already short; ``--smoke``
sweeps three io.sort.mb values instead of five.
"""

import argparse

import numpy as np

import repro_torch.api as api
from repro_torch.core.hadoop import HadoopParams, MiB
from repro_torch.spec import JobSpec, PhaseBreakdown


def spec() -> JobSpec:
    """Step 1: flat-key overrides route and coerce onto the tables."""
    return JobSpec(
        HadoopParams(pNumNodes=8, pNumMappers=64, pNumReducers=16,
                     pSplitSize=128 * MiB),
        name="wordcount-ish",
    ).replace(sMapSizeSel=0.8, sReduceSizeSel=0.5)


def space(smoke: bool) -> dict:
    return {
        "pSortMB": [25.0, 100.0, 400.0] if smoke else [25.0, 50.0, 100.0, 200.0, 400.0],
        "pSortFactor": [5.0, 10.0, 25.0],
        "pNumReducers": [4.0, 8.0, 16.0, 32.0, 64.0],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="typed API tour")
    ap.add_argument("--device", default=None,
                    help="where the evaluator runs (default: the CUDA card)")
    ap.add_argument("--smoke", action="store_true", help="a smaller sweep")
    args = ap.parse_args(argv)
    js, sp = spec(), space(args.smoke)

    # ---- 2: one configuration -> per-phase report with paper provenance ----
    rep = api.model(js, {"pSortMB": 100.0, "pSortFactor": 10.0}, device=args.device)
    print("== per-phase cost report (job-level seconds) ==")
    for phase in PhaseBreakdown.names():
        print(f"  {phase:13s} {float(rep.phases[phase][0]):8.2f}s   "
              f"[{PhaseBreakdown.eq(phase)}]")
    print(f"  {'total':13s} {float(rep.total_cost[0]):8.2f}s   [Eq. 98] "
          f"(= io {float(rep.io_cost[0]):.2f} + cpu {float(rep.cpu_cost[0]):.2f} "
          f"+ net {float(rep.net_cost[0]):.2f})")

    # ---- 3+4: sweep and tune through the same facade ----
    tuned = api.tune(js, sp, strategy="descent", device=args.device)
    print(f"\n== tune (axis-validated space) ==\n  best {tuned.best_assignment} "
          f"cost={tuned.best_cost:.2f}s ({tuned.evaluations} model evals)")

    # ---- 5: phase-aware what-if through the async service ----
    grid = {
        "pSortMB": np.repeat(sp["pSortMB"], len(sp["pNumReducers"])),
        "pNumReducers": np.tile(sp["pNumReducers"], len(sp["pSortMB"])),
    }
    swept = api.sweep(js, grid, device=args.device)
    budget = float(np.percentile(np.asarray(swept.total_cost), 40))
    with api.serve(js, device=args.device) as svc:
        fut = svc.phase_query(grid, phase="shuffle", total_max=budget)
        fut_any = svc.phase_query(grid, phase="shuffle")
        best = fut.result().best()
        unconstrained = fut_any.result().best()
    print(f"\n== phase query: min shuffle s.t. total <= {budget:.2f}s ==")
    print(f"  constrained   : shuffle={best[1]:7.3f}s at {best[2]}")
    print(f"  unconstrained : shuffle={unconstrained[1]:7.3f}s at {unconstrained[2]}")
    return {"spec": js, "space": sp, "report": rep, "tuned": tuned, "grid": grid,
            "swept": swept, "budget": budget, "best": best,
            "unconstrained": unconstrained}


if __name__ == "__main__":
    main()
