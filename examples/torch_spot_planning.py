"""Spot planning end-to-end on the PyTorch port — priced fleets,
reclamation, the $/SLO Pareto.

1. WORKLOAD  a Poisson stream over the 4-class job mix, offered at a
             fixed rate; the fleet shape is what we search.
2. BASELINE  today's all-on-demand fleet on the elastic DES: what it
             costs per job (per-node billing episodes) and where p95 sits.
3. SPOT      swap capacity to spot instances at 1/4 the price and watch
             the DES reclaim nodes mid-run (kill-and-requeue, distinct
             ``reclaim`` kill reason) — cheaper, but the tail pays.
4. SWEEP     the (on-demand x spot x reclaim-rate) grid through
             ``CloudEvaluator`` — dollars-per-job, SLO attainment, and
             p95 for every mix in one batched rollout — and keep the
             dollar/SLO Pareto front.
5. TUNE      grid search under a hard latency SLO: infeasible mixes cost
             ``inf``, the winner is the cheapest fleet that still meets
             the objective.  Verify the pick on the DES (``exact_cost``).

Run:  PYTHONPATH=src python examples/torch_spot_planning.py
          [--device cpu] [--smoke] [--trace out.json]

The rollout runs on the CUDA card unless ``--device cpu`` is given;
``--smoke`` shortens the workload.  With ``--trace``, the run executes
under ``repro_torch.obs.observe`` and the spot DES run is rendered as a
virtual-time swimlane with ``reclaim`` instants, per-node
``provisioned``/``offline`` markers, and ``fleet`` / ``spend`` counter
tracks.
"""

import argparse
import contextlib

import numpy as np

from repro_torch.cloud import (
    CloudEvaluator,
    ElasticFleet,
    bill_workload,
    pareto_front,
)
from repro_torch.cluster import (
    ClusterConfig,
    NodeClass,
    default_job_classes,
    poisson_trace,
    rescale,
    simulate_workload,
)
from repro_torch.core.hadoop.simulator import SimConfig
from repro_torch.search import grid_search_ev


def dollars(res, cc, el=None):
    window = (min(j.submit_time for j in res.jobs), res.makespan)
    return bill_workload(res, cc, elastic=el, window=window)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="spot fleet planning walkthrough")
    ap.add_argument("--device", default=None,
                    help="where the wave rollout runs (default: the CUDA card)")
    ap.add_argument("--smoke", action="store_true",
                    help="a short run: 8 jobs, one seed")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a Perfetto-loadable Chrome trace of this run")
    args = ap.parse_args(argv)
    stack = contextlib.ExitStack()
    if args.trace:
        from repro_torch.obs import observe

        stack.enter_context(observe(args.trace))

    rate = 0.08                   # offered load: jobs/s
    on_demand, spot_price = 0.40, 0.10   # $/node-hour
    clean = SimConfig(speculative_execution=False)
    n_jobs, n_seeds = (8, 1) if args.smoke else (24, 2)
    classes = default_job_classes()
    trace = rescale(poisson_trace(classes, n_jobs, rate=1.0, seed=0), rate)

    # ---- 2: today's fleet — all on-demand ----
    today = ClusterConfig(num_nodes=4,
                          node_classes=(NodeClass(4, 1.0, on_demand),))
    base = simulate_workload(trace, today, clean)
    print("== today: 4 on-demand nodes ==")
    print(f"p95 latency      {base.p95_latency:8.1f} s")
    print(f"dollars per job  ${dollars(base, today) / n_jobs:.4f}")

    # ---- 3: the same capacity, half on spot, reclamation live ----
    mixed = ClusterConfig(num_nodes=4,
                          node_classes=(NodeClass(2, 1.0, spot_price, spot=True),
                                        NodeClass(2, 1.0, on_demand)))
    el = ElasticFleet(reclaim_rate=5e-3, provision_latency=30.0, seed=0)
    spot = simulate_workload(trace, mixed, clean, elastic=el)
    print("\n== 2 spot + 2 on-demand, reclaim rate 5e-3/s ==")
    print(f"p95 latency      {spot.p95_latency:8.1f} s")
    print(f"dollars per job  ${dollars(spot, mixed, el) / n_jobs:.4f}")
    print(f"spot reclaims    {spot.num_reclaimed} task kills "
          f"({sum(len(e) - 1 for e in spot.node_online[:2])} node outages)")

    if args.trace:
        from repro_torch.obs.destrace import workload_trace

        workload_trace(trace, spot, mixed)

    # ---- 4: sweep the fleet-mix grid, keep the $/SLO Pareto front ----
    ev = CloudEvaluator(classes,
                        traces=[poisson_trace(classes, n_jobs, seed=0)],
                        n_seeds=n_seeds, base_rate=rate, sim=clean, chunk=64,
                        on_demand_price=on_demand, spot_price=spot_price,
                        slo_target=0.9, device=args.device)
    slo = 1.5 * base.p95_latency
    od = np.repeat([1.0, 2.0, 4.0], 4)
    sp = np.tile([0.0, 2.0, 4.0, 8.0], 3)
    rep = ev.report({"pOnDemandNodes": od, "pSpotNodes": sp,
                     "spotReclaimRate": np.full(od.size, 5e-3),
                     "sloLatency": np.full(od.size, slo)})
    front = pareto_front(np.asarray(rep.dollars_per_job),
                         -np.asarray(rep.slo_attainment))
    print(f"\n== fleet-mix sweep ({od.size} mixes, SLO p95 <= {slo:.0f} s) ==")
    print("  od  spot   $/job    SLO-attain  on front")
    for i in np.argsort(np.asarray(rep.dollars_per_job)):
        d = float(np.asarray(rep.dollars_per_job)[i])
        a = float(np.asarray(rep.slo_attainment)[i])
        if np.isfinite(d):
            star = "  *" if front[i] else ""
            print(f"  {int(od[i])}   {int(sp[i])}     ${d:.4f}  {a:10.2f}{star}")

    # ---- 5: cheapest fleet that meets the SLO, verified on the DES ----
    tuned = grid_search_ev(ev, {"pOnDemandNodes": [1.0, 2.0, 4.0],
                                "pSpotNodes": [0.0, 2.0, 4.0, 8.0],
                                "spotReclaimRate": [5e-3],
                                "sloLatency": [slo]})
    pick = tuned.best_assignment
    print(f"\n== winner: {int(pick['pOnDemandNodes'])} on-demand + "
          f"{int(pick['pSpotNodes'])} spot at ${tuned.best_cost:.4f}/job ==")
    exact = ev.exact_cost(pick)
    print(f"DES-verified     ${exact:.4f}/job "
          f"({abs(exact - tuned.best_cost) / exact:.1%} from the wave estimate)")

    stack.close()
    if args.trace:
        print(f"\n[trace written to {args.trace}; open at https://ui.perfetto.dev]")
    return {"report": rep, "front": front, "tuned": tuned, "exact": exact}


if __name__ == "__main__":
    main()
