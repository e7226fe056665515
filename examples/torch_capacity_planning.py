"""Capacity planning end-to-end on the PyTorch port — workload, DES
baseline, planner, what-ifs.

1. WORKLOAD  a Poisson stream of jobs over the 4-class mix (wordcount /
             sort / filter / aggregate), generated at unit rate so the
             offered load itself is a searchable knob.
2. BASELINE  run the multi-job DES on today's cluster: per-job queueing
             delay, p95 latency, slot utilization, FIFO vs fair-share vs
             preemptive fair-share vs capacity queues, a heterogeneous
             fleet, and what a burst or a node failure does to the tail.
3. PLAN      search (nodes x fleet mix x slots x scheduler policy x
             slowstart) with the batched wave simulator behind
             ``ClusterEvaluator`` — hundreds of (config x workload-seed)
             scenarios per rollout on the card, exhaustive grid + streamed
             top-k.
4. ANSWER    concurrent capacity what-ifs through the same async
             WhatIfService that serves the single-job model.
5. VERIFY    the recommended cluster on the trusted DES.

Run:  PYTHONPATH=src python examples/torch_capacity_planning.py
          [--device cpu] [--smoke] [--trace out.json]

The rollout runs on the CUDA card unless ``--device cpu`` is given;
``--smoke`` shortens the workload and the grid.  With ``--trace``, the
whole run executes under ``repro_torch.obs.observe`` and writes a
Perfetto-loadable Chrome trace: real-time spans for the planner and
service, plus a virtual-time swimlane rendering of the baseline DES run.
"""

import argparse
import contextlib

import numpy as np

from repro_torch.cluster import (
    ClusterConfig,
    ClusterEvaluator,
    NodeClass,
    bursty_trace,
    default_job_classes,
    poisson_trace,
    rescale,
    simulate_workload,
)
from repro_torch.core.hadoop.simulator import SimConfig
from repro_torch.search import WhatIfService, grid_search_ev, search_topk


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="capacity planning walkthrough")
    ap.add_argument("--device", default=None,
                    help="where the wave rollout runs (default: the CUDA card)")
    ap.add_argument("--smoke", action="store_true",
                    help="a short run: 8 jobs, one seed, a small grid")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a Perfetto-loadable Chrome trace of this run")
    args = ap.parse_args(argv)
    stack = contextlib.ExitStack()
    if args.trace:
        from repro_torch.obs import observe

        stack.enter_context(observe(args.trace))

    rate = 0.08          # offered load today: jobs/s
    n_jobs, n_seeds = (8, 1) if args.smoke else (32, 2)
    classes = default_job_classes()
    trace = poisson_trace(classes, n_jobs, rate=1.0, seed=0)

    # ---- 2: today's cluster, on the DES ----
    today = ClusterConfig(num_nodes=8, map_slots_per_node=2,
                          reduce_slots_per_node=2)
    print("== multi-job DES on today's cluster (8 nodes, FIFO) ==")
    runs = [
        ("steady Poisson, FIFO", today, rescale(trace, rate), SimConfig(seed=1)),
        ("steady Poisson, fair",
         ClusterConfig(num_nodes=8, scheduler="fair"), rescale(trace, rate),
         SimConfig(seed=1)),
        ("steady Poisson, fair+preempt",
         ClusterConfig(num_nodes=8, scheduler="fair_preempt",
                       preempt_timeout=10.0),
         rescale(trace, rate), SimConfig(seed=1)),
        ("capacity queues (equal)",
         ClusterConfig(num_nodes=8, scheduler="capacity", preempt_timeout=10.0),
         rescale(trace, rate), SimConfig(seed=1)),
        ("4 fast(2x) + 4 base nodes",
         ClusterConfig(node_classes=(NodeClass(4, 2.0), NodeClass(4, 1.0))),
         rescale(trace, rate), SimConfig(seed=1)),
        ("burst of 8 jobs", today,
         bursty_trace(classes, n_bursts=1 if args.smoke else 4, burst_size=8,
                      burst_gap=120.0),
         SimConfig(seed=1)),
        ("10% stragglers + node failure", today, rescale(trace, rate),
         SimConfig(seed=1, straggler_prob=0.1, node_failures=((40.0, 2),))),
    ]
    for label, cc, tr, sc in runs:
        r = simulate_workload(tr, cc, sc)
        if args.trace and label == "steady Poisson, FIFO":
            # swimlane rendering of the baseline run on the virtual-time track
            from repro_torch.obs import workload_trace

            workload_trace(tr, r, cc)
        delays = [j.queueing_delay for j in r.jobs]
        print(f"  {label:30s} p95={r.p95_latency:7.1f}s "
              f"mean={r.mean_latency:6.1f}s "
              f"queue p95={np.percentile(delays, 95):6.1f}s "
              f"util={r.slot_utilization:.2f} spec={r.num_speculative_launched} "
              f"reruns={r.num_failure_reruns} kills={r.num_preempted}")

    # ---- 3: the capacity planner ----
    ev = ClusterEvaluator(classes, n_jobs=n_jobs, n_seeds=n_seeds, base=today,
                          base_rate=rate, objective="p95",
                          chunk=32 if args.smoke else 256, device=args.device)
    space = {
        "pNumNodes": [4.0, 8.0, 16.0],
        "pNumFastNodes": [0.0, 4.0],          # fleet mix: that many 2x nodes
        "fastSpeedup": [2.0],
        "pMaxMapsPerNode": [2.0, 4.0],
        "pMaxRedPerNode": [2.0, 4.0],
        "schedPolicy": [0.0, 1.0, 2.0, 3.0],  # fifo/fair/fair_preempt/capacity
        "pReduceSlowstart": [0.05, 0.8],
    }
    if args.smoke:
        space.update(pMaxMapsPerNode=[2.0], pMaxRedPerNode=[2.0],
                     schedPolicy=[0.0, 2.0], pReduceSlowstart=[0.05])
    plan = grid_search_ev(ev, space)
    top = search_topk(ev, space, k=5)
    print("\n== capacity planner (batched wave simulator, exhaustive grid) ==")
    print(f"  searched {plan.evaluations} cluster configs x {len(ev.traces)} "
          f"workload seeds ({top.configs_per_sec:,.0f} configs/s)")
    print(f"  best: {plan.best_assignment} -> p95={plan.best_cost:.1f}s")
    print("  top-5 by p95 job latency:")
    for e in top.entries:
        print(f"    p95={e.cost:7.1f}s  {e.assignment}")

    # ---- 4: concurrent what-ifs against the plan ----
    best = plan.best_assignment
    with WhatIfService(ev) as svc:
        futures = {
            "plan, at 2x load": svc.probe({**best, "arrivalRate": 2 * rate}),
            "plan, half the nodes": svc.probe(
                {**best, "pNumNodes": max(best["pNumNodes"] / 2, 1),
                 "pNumFastNodes": best.get("pNumFastNodes", 0) / 2}),
            "load sweep @plan": svc.sweep(
                "arrivalRate", [0.04, 0.08, 0.16, 0.32],
                base={k: v for k, v in best.items()}),
        }
        answers = {label: f.result() for label, f in futures.items()}
    summary = svc.summary()
    print("\n== capacity what-ifs (async service, coalesced chunks) ==")
    for label, r in answers.items():
        i = int(np.argmin(r.total_cost))
        print(f"  {label:22s} p95={r.total_cost[i]:7.1f}s rows={r.stats.n_rows} "
              f"latency={r.stats.latency_s * 1e3:5.1f}ms")
    print(f"  {summary['queries']} queries -> {summary['chunks']} evaluator "
          f"chunks ({summary['shared_chunks']} shared)")

    # ---- 5: verify the winner on the trusted DES ----
    exact = ev.exact_cost(best)
    model = plan.best_cost
    print("\n== verification (multi-job DES on the recommended cluster) ==")
    print(f"  planner model p95 = {model:.1f}s, DES p95 = {exact:.1f}s "
          f"({100 * abs(model - exact) / max(exact, 1e-9):.1f}% apart)")
    baseline = ev.exact_cost({})
    print(f"  today's cluster DES p95 = {baseline:.1f}s -> plan is "
          f"{baseline / max(exact, 1e-9):.2f}x better on the tail")

    stack.close()
    if args.trace:
        print(f"\n[trace written to {args.trace}; open at https://ui.perfetto.dev]")
    return {"plan": plan, "top": top, "answers": answers, "exact": exact,
            "baseline": baseline}


if __name__ == "__main__":
    main()
