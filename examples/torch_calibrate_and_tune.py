"""Differentiable loop on the PyTorch port: observe -> calibrate by autodiff
-> tune by gradient.

The closed-form job model is branch-free PyTorch end to end
(straight-through round counts, double-``where`` guarded divisions), so the
graph that *predicts* a cost can be differentiated — against its Table-3
cost factors (calibration) or against the configuration knobs (search):

1. OBSERVE    run a few jobs on the port's MapReduce engine (the
              combiner's sums through ``seg_combine`` on the card) and keep
              only ``(JobSpec, wall seconds)`` pairs.
2. CALIBRATE  ``api.calibrate`` fits the cost factors by autograd on the
              relative-error loss (float64, AdamW, per-axis log/logit
              transforms keep every step in-domain).
3. TUNE       ``api.tune(strategy="gradient")`` relaxes the search space
              continuously and descends on the model itself; candidates
              are rounded, validated and re-costed through the evaluator.

Run:  PYTHONPATH=src python examples/torch_calibrate_and_tune.py [--device cpu] [--smoke]

The engine, the fit and the search run on the CUDA card unless ``--device
cpu`` is given; ``--smoke`` observes smaller jobs and calibrates for fewer
steps.
"""

import argparse

import repro_torch.api as api
from repro_torch.calib import Observation
from repro_torch.core.hadoop.params import HadoopParams, MiB
from repro_torch.mapreduce import JOBS
from repro_torch.mapreduce.profiler import fit_cost_factors, predict, run_measured
from repro_torch.spec import JobSpec

SPACE = {
    "pSortMB": [0.25, 0.5, 1.0, 2.0, 4.0],
    "pSortFactor": [3, 5, 8, 16],
    "pNumReducers": [2, 4, 8],
    "pUseCombine": [0.0, 1.0],
}


def base_hp(n: int) -> HadoopParams:
    return HadoopParams(
        pNumMappers=4, pNumReducers=2, pUseCombine=True,
        pSortMB=0.25, pSortFactor=3,                      # deliberately poor
        pSplitSize=n / 4 * JOBS["wordcount"].pair_width, pTaskMem=8 * MiB,
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="calibrate and tune")
    ap.add_argument("--device", default=None,
                    help="where the engine, fit and search run (default: the CUDA card)")
    ap.add_argument("--smoke", action="store_true",
                    help="smaller jobs, fewer calibration steps")
    args = ap.parse_args(argv)
    job = JOBS["wordcount"]
    N = 24_000 if args.smoke else 120_000
    steps = 60 if args.smoke else 300
    hp0 = base_hp(N)

    # ---- 1: observe three configurations on the live engine ----
    # Probes sit inside the closed-form merge domain (valid == 0 rows are
    # weighed out of the fit), so none uses pSortMB=0.25.
    probes = [
        hp0.replace(pSortMB=1.0, pSortFactor=8),
        hp0.replace(pSortMB=2.0, pSortFactor=10),
        hp0.replace(pSortMB=1.0, pSortFactor=8, pNumReducers=8),
    ]
    runs = [run_measured(job, hp, N, seed=1, device=args.device) for hp in probes]
    stats = runs[0].stats
    # the lstsq fit needs each run's phase timings; the autodiff fit only
    # the spec that ran and its wall time, seeded from the lstsq factors
    seed_costs = fit_cost_factors(runs)
    observations = [Observation(spec=JobSpec(params=r.hp, stats=r.stats,
                                             costs=seed_costs), cost=r.wall_s)
                    for r in runs]

    # ---- 2: calibrate the cost factors by autograd ----
    report = api.calibrate(observations, steps=steps, device=args.device)
    print("== calibration (autodiff on the model itself) ==")
    print(report.summary())
    fitted_costs = seed_costs.replace(**report.fitted)

    print("\nper-run relative error, lstsq -> autodiff:")
    for r in runs:
        e0 = abs(predict(r.hp, stats, seed_costs) - r.wall_s) / r.wall_s
        e1 = abs(predict(r.hp, stats, fitted_costs) - r.wall_s) / r.wall_s
        print(f"  {r.hp.pSortMB:6.2f}MB sort, {r.hp.pNumReducers:2d} reducers: "
              f"{e0:6.1%} -> {e1:6.1%}")

    # ---- 3: tune the knobs by gradient descent on the calibrated model ----
    spec = JobSpec(params=hp0, stats=stats, costs=fitted_costs)
    grad = api.tune(spec, SPACE, strategy="gradient", device=args.device)
    coord = api.tune(spec, SPACE, strategy="descent", device=args.device)
    print("\n== tuning on the calibrated model ==")
    print(f"coordinate descent: {coord.best_cost:8.3f}s "
          f"in {coord.evaluations} evaluator calls")
    print(f"gradient descent  : {grad.best_cost:8.3f}s "
          f"in {grad.evaluations} evaluator calls")
    print(f"recommended config: {grad.best_assignment}")
    return {"runs": runs, "observations": observations, "steps": steps,
            "report": report, "spec": spec, "grad": grad, "coord": coord}


if __name__ == "__main__":
    main()
