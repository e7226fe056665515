"""Quickstart on the PyTorch port: the paper's models in five minutes.

1. Predict a MapReduce job's cost with the closed-form models (Eqs. 2-98).
2. Cross-check the dataflow against a real execution of the same job on the
   port's MapReduce engine, whose combiner sums run through the
   ``seg_combine`` kernel on the card.
3. Ask a what-if question (the paper's headline use case) and tune a knob.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] [--smoke]

The engine runs on the CUDA card unless ``--device cpu`` is given;
``--smoke`` runs a smaller job in step 2.
"""

import argparse

from repro_torch.core.hadoop import ref
from repro_torch.core.hadoop.params import CostFactors, HadoopParams, MiB, ProfileStats
from repro_torch.mapreduce import JOBS, MapReduceEngine, make_input
from repro_torch.mapreduce.profiler import profile_job

HP = HadoopParams(
    pNumNodes=16, pNumMappers=64, pNumReducers=16,
    pSortMB=100.0, pSortFactor=10, pUseCombine=True,
    pSplitSize=128 * MiB, pTaskMem=200 * MiB,
)
STATS = ProfileStats(
    sInputPairWidth=100.0, sMapSizeSel=0.8, sMapPairsSel=1.0,
    sCombineSizeSel=0.4, sCombinePairsSel=0.4,
    sReduceSizeSel=0.5, sReducePairsSel=0.1,
)


def small_job(n: int) -> HadoopParams:
    """Step 2's configuration: 2 maps, 4 reducers, 1 MiB sort buffers."""
    return HadoopParams(
        pNumMappers=2, pNumReducers=4, pUseCombine=True,
        pSortMB=1.0, pSplitSize=n / 2 * JOBS["wordcount"].pair_width,
        pTaskMem=8 * MiB,
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="quickstart")
    ap.add_argument("--device", default=None,
                    help="where the engine's combiner runs (default: the CUDA card)")
    ap.add_argument("--smoke", action="store_true", help="a smaller engine run")
    args = ap.parse_args(argv)

    # ------------------------------------------------------------ 1. model
    jm = ref.job_model(HP, STATS, CostFactors())
    print("== closed-form prediction (paper Eqs. 2-98) ==")
    print(f"  map task : numSpills={jm.map.numSpills} "
          f"mergePasses={jm.map.numMergePasses} io={jm.map.ioCost:.2f}s "
          f"cpu={jm.map.cpuCost:.2f}s")
    print(f"  reduce   : shuffle={jm.reduce.totalShuffleSize/MiB:.1f}MiB "
          f"io={jm.reduce.ioCost:.2f}s cpu={jm.reduce.cpuCost:.2f}s")
    print(f"  job      : total={jm.totalCost:.2f}s "
          f"(io={jm.ioJobCost:.2f} cpu={jm.cpuJobCost:.2f} net={jm.netCost:.2f})")

    # --------------------------------------------------------- 2. validate
    job = JOBS["wordcount"]
    n = 8_000 if args.smoke else 40_000
    hp_small = small_job(n)
    keys, values = make_input(job, n)
    jc = MapReduceEngine(hp_small, job, device=args.device).run_job(keys, values)
    measured = profile_job(jc, job, hp_small)
    m = ref.map_task_model(hp_small, measured, CostFactors())
    mc = jc.maps[0]
    print("\n== engine vs model (live wordcount run) ==")
    print(f"  numSpills        engine={mc.numSpills:<6d} model={m.numSpills}")
    print(f"  spillBufferPairs engine={mc.spillBufferPairs:<6d} model={int(m.spillBufferPairs)}")
    print(f"  mergePasses      engine={mc.numMergePasses:<6d} model={m.numMergePasses}")
    print(f"  combine selectivity measured from run: {measured.sCombinePairsSel:.3f}")

    # ---------------------------------------------------------- 3. what-if
    print("\n== what-if: shrink io.sort.mb 100 -> 10 (more spills/merges) ==")
    whatif = {}
    for sort_mb in (100.0, 10.0):
        w = ref.job_model(HP.replace(pSortMB=sort_mb), STATS, CostFactors())
        whatif[sort_mb] = (w.map.numSpills, w.totalCost)
        print(f"  io.sort.mb={sort_mb:>5.0f}MB -> numSpills={w.map.numSpills:>3d} "
              f"total={w.totalCost:.2f}s")

    print("\n== tune pNumReducers (grid) ==")
    best = min(
        (ref.job_model(HP.replace(pNumReducers=r), STATS, CostFactors()).totalCost, r)
        for r in (4, 8, 16, 32, 64)
    )
    print(f"  best pNumReducers={best[1]} (predicted {best[0]:.2f}s)")
    return {"total": jm.totalCost, "n": n, "hp_small": hp_small, "jc": jc,
            "measured": measured, "model": m, "whatif": whatif, "best": best}


if __name__ == "__main__":
    main()
