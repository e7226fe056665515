"""The full Starfish loop on live executions, on the PyTorch port — profile,
fit, tune, verify.

1. PROFILE  a wordcount job on the port's MapReduce engine (the combiner's
            sums through the ``seg_combine`` kernel on the card).
2. FIT      the paper's Table-3 cost factors from measured phase timings.
3. TUNE     (io.sort.mb, io.sort.factor, numReducers, combiner) with the
            chunked what-if evaluator + coordinate descent: model
            evaluations on the card, no job runs.
4. ANSWER   a batch of concurrent what-if questions (probes, sweeps, a
            grid) through the async WhatIfService: all queries coalesce
            into a handful of shared evaluator chunks.
5. VERIFY   by running the recommended configuration on the engine.
6. SIMULATE the tuned job on a virtual cluster with stragglers + failures
            + speculative execution (paper §5 way (i)).

Run:  PYTHONPATH=src python examples/torch_job_tuning.py [--device cpu] [--smoke]

The engine's combiner and the evaluator run on the CUDA card unless
``--device cpu`` is given; ``--smoke`` profiles a smaller job.
"""

import argparse

from repro_torch.core.hadoop.params import HadoopParams, MiB
from repro_torch.core.hadoop.simulator import SimConfig, simulate_job
from repro_torch.mapreduce import JOBS
from repro_torch.mapreduce.profiler import fit_cost_factors, predict, run_measured
from repro_torch.search import (
    ChunkedEvaluator,
    WhatIfService,
    coordinate_descent_ev,
    grid_search_ev,
)

SPACE = {
    "pSortMB": [0.25, 0.5, 1.0, 2.0, 4.0],
    "pSortFactor": [3, 5, 10, 20],
    "pNumReducers": [1, 2, 4, 8, 16],
    "pUseCombine": [0.0, 1.0],
}
SIMS = [
    ("clean cluster", SimConfig(seed=7)),
    ("10% stragglers, no speculation",
     SimConfig(seed=7, straggler_prob=0.1, speculative_execution=False)),
    ("10% stragglers + speculation",
     SimConfig(seed=7, straggler_prob=0.1, speculative_execution=True)),
    ("node failure at t=0.3s", SimConfig(seed=7, node_failures=((0.3, 3),))),
]


def default_hp(n: int) -> HadoopParams:
    """The deliberately poor starting configuration for ``n`` records."""
    return HadoopParams(
        pNumMappers=4, pNumReducers=2, pUseCombine=True,
        pSortMB=0.25, pSortFactor=3,
        pSplitSize=n / 4 * JOBS["wordcount"].pair_width, pTaskMem=8 * MiB,
    )


def queries(best: dict) -> dict:
    """Step 4's questions, as (kind, arguments) by label."""
    return {
        "tuned, combiner off": ("probe", ({**best, "pUseCombine": 0.0},)),
        "tuned, 2x reducers": ("probe", ({**best, "pNumReducers": 2 * best["pNumReducers"]},)),
        "reducer sweep @tuned": ("sweep", ("pNumReducers", [1.0, 2.0, 4.0, 8.0, 16.0],
                                           {k: v for k, v in best.items()
                                            if k != "pNumReducers"})),
        "sortMB x factor grid": ("grid", ({"pSortMB": SPACE["pSortMB"],
                                           "pSortFactor": SPACE["pSortFactor"]},)),
    }


def ask(svc, kind, args):
    if kind == "sweep":
        return svc.sweep(args[0], args[1], base=args[2])
    return getattr(svc, kind)(*args)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="job tuning walkthrough")
    ap.add_argument("--device", default=None,
                    help="where the combiner and evaluator run (default: the CUDA card)")
    ap.add_argument("--smoke", action="store_true", help="profile a smaller job")
    args = ap.parse_args(argv)
    job = JOBS["wordcount"]
    N = 24_000 if args.smoke else 120_000
    hp0 = default_hp(N)

    # ---- 1+2: profile + fit from three probe runs ----
    probes = [hp0, hp0.replace(pSortMB=1.0), hp0.replace(pNumReducers=8, pSortFactor=8)]
    runs = [run_measured(job, hp, N, seed=1, device=args.device) for hp in probes]
    costs = fit_cost_factors(runs)
    stats = runs[0].stats
    print("== fitted cost factors (paper Table 3, from live phase timings) ==")
    for f in ("cHdfsReadCost", "cMapCPUCost", "cSortCPUCost", "cMergeCPUCost",
              "cNetworkCost", "cReduceCPUCost"):
        print(f"  {f:18s} = {getattr(costs, f):.3e} s/unit")
    print(f"  measured sMapPairsSel={stats.sMapPairsSel:.2f} "
          f"sCombinePairsSel={stats.sCombinePairsSel:.3f}")

    # ---- 3: tune on the model only ----
    evaluator = ChunkedEvaluator(hp0, stats, costs, chunk=1 << 10, device=args.device)
    tuned = coordinate_descent_ev(evaluator, SPACE)
    exhaustive = grid_search_ev(evaluator, SPACE)
    hp_tuned = tuned.apply(hp0)
    print("\n== tuner (model evaluations only, chunked evaluator) ==")
    print(f"  coordinate descent: {tuned.best_assignment} "
          f"cost={tuned.best_cost:.3f}s ({tuned.evaluations} evals)")
    print(f"  exhaustive optimum: cost={exhaustive.best_cost:.3f}s "
          f"({exhaustive.evaluations} evals, "
          f"{exhaustive.topk.configs_per_sec:,.0f} configs/s) -> descent within "
          f"{100 * tuned.best_cost / max(exhaustive.best_cost, 1e-9) - 100:.1f}%")

    # ---- 4: concurrent what-if questions through the async service ----
    with WhatIfService(evaluator) as svc:
        futures = {label: ask(svc, kind, a)
                   for label, (kind, a) in queries(tuned.best_assignment).items()}
        answers = {label: f.result() for label, f in futures.items()}
    summary = svc.summary()
    print("\n== concurrent what-if queries (async service) ==")
    for label, r in answers.items():
        _, cost, _ = r.best()
        print(f"  {label:22s} best={cost:7.3f}s rows={r.stats.n_rows:2d} "
              f"latency={r.stats.latency_s*1e3:5.1f}ms")
    print(f"  {summary['queries']} queries -> {summary['chunks']} evaluator "
          f"chunks ({summary['shared_chunks']} shared); "
          f"p50={summary['latency_p50_s']*1e3:.1f}ms "
          f"p99={summary['latency_p99_s']*1e3:.1f}ms")

    # ---- 5: verify on the engine ----
    before = run_measured(job, hp0, N, seed=2, device=args.device)
    after = run_measured(job, hp_tuned, N, seed=2, device=args.device)
    print("\n== verification (real engine runs) ==")
    print(f"  default config : measured {before.wall_s:.3f}s "
          f"(predicted {predict(hp0, stats, costs):.3f}s)")
    print(f"  tuned config   : measured {after.wall_s:.3f}s "
          f"(predicted {predict(hp_tuned, stats, costs):.3f}s)")
    speedup = before.wall_s / max(after.wall_s, 1e-9)
    print(f"  speedup {speedup:.2f}x  {'OK' if speedup > 1.0 else 'NO GAIN'}")

    # ---- 6: virtual-cluster simulation (paper §5 way (i)) ----
    print("\n== task-scheduler simulation: stragglers + failure + speculation ==")
    sim_hp = hp_tuned.replace(pNumNodes=8, pNumMappers=64, pNumReducers=16)
    sims = {}
    for label, sc in SIMS:
        r = simulate_job(sim_hp, stats, costs, sc)
        sims[label] = r
        print(f"  {label:34s} makespan={r.makespan:7.2f}s "
              f"spec={r.num_speculative_launched} reruns={r.num_failure_reruns}")
    return {"N": N, "hp0": hp0, "runs": runs, "stats": stats, "costs": costs,
            "tuned": tuned, "exhaustive": exhaustive, "answers": answers,
            "summary": summary, "before": before, "after": after, "sims": sims}


if __name__ == "__main__":
    main()
