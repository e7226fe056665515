"""The paper's tuning loop applied to accelerator execution configs, on the
PyTorch port, and checked against the port's dry-run.

The twin of ``examples/tpu_tuning.py``.  Starfish uses the analytical job
model to rank Hadoop configurations without running them.  Here the step
model (``repro_torch/core/tpu_model.py``, the Table-1/2/3 adaptation) ranks
(dp, tp, n_micro) mesh factorizations of 256 chips for each architecture,
through the same search stack as the Hadoop tuner; where the port's dry-run
(``python -m repro_torch.launch.dryrun``) has left artifacts for the same
cell and presets, the ranking is compared with what the dry-run counted.
The port's dry-run computes replicated within a model group (``ROADMAP.md``
queue 1 item 24), so its presets differ from the reference's compiled
ones: a comparison, not a validation.

Run:  PYTHONPATH=src python examples/torch_tpu_tuning.py [--smoke] [--hw h100_sxm]

The step model is numpy on the host: no card is needed.  ``--hw`` picks the
hardware table (``repro_torch.core.roofline.HW_TABLES``; default: the
reference's); ``--smoke`` ranks the first architecture only.
"""

import argparse
import glob
import json
import os

from repro_torch.configs import SHAPES, get_config
from repro_torch.core.tpu_model import TpuCostFactors
from repro_torch.search import TpuEvaluator, search_topk, space_size

SPACE = {
    "dp": [16.0, 32.0, 64.0, 128.0, 256.0],
    "tp": [16.0, 8.0, 4.0, 2.0, 1.0],
    "n_micro": [2.0, 4.0, 8.0, 16.0],
}
N_CHIPS = 256
CELLS = [("starcoder2-7b", "train_4k"), ("gemma2-9b", "train_4k"),
         ("granite-3-8b", "train_4k")]
ARTIFACTS = os.path.join("artifacts", "dryrun_torch")


def tune(arch: str, shape_name: str, hw: str | None = None):
    """Rank execution configs with the shared search stack: the step model
    behind the same Evaluator interface the Hadoop tuner uses.  Unshardable
    candidates (dp*tp != chips, indivisible batch) are rejected by the
    evaluator's validity mask.  Rows: ((dp, tp, n_micro), cost, bound)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    costs = TpuCostFactors.for_hw(hw) if hw else None
    ev = TpuEvaluator(cfg, shape, n_chips=N_CHIPS, costs=costs)
    # k = every candidate, so the (16,16) baseline row is always present
    top = search_topk(ev, SPACE, k=space_size(SPACE), exact_fallback=False)
    rows = []
    for e in top.entries:
        dp, tp, nm = (int(e.assignment[k]) for k in ("dp", "tp", "n_micro"))
        out = ev.evaluate({k: [v] for k, v in e.assignment.items()}).outputs
        bound = max(("compute", "memory", "collective"),
                    key=lambda t: out[f"{t}_s"][0])
        rows.append(((dp, tp, nm), e.cost, bound))
    return rows


def measured(arch: str, shape: str) -> dict:
    """The dry-run's max roofline term for each preset traced for this cell."""
    out = {}
    for f in glob.glob(os.path.join(ARTIFACTS, f"{arch}__{shape}__single*.json")):
        with open(f) as fh:
            c = json.load(fh)
        if c.get("status") != "ok":
            continue
        r = c["roofline"]
        out[c.get("opt", "baseline")] = max(r["compute_s"], r["memory_s"],
                                            r["collective_s"])
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="rank mesh layouts with the step model")
    ap.add_argument("--smoke", action="store_true", help="the first architecture only")
    ap.add_argument("--hw", default=None, help="a HW_TABLES name (default: the reference's)")
    args = ap.parse_args(argv)
    result = {}
    for arch, shape in CELLS[:1] if args.smoke else CELLS:
        rows = tune(arch, shape, args.hw)
        print(f"\n== {arch}/{shape}: model ranking (top 5 of {len(rows)}), "
              f"hw {args.hw or 'tpu_v5e'} ==")
        for (dp, tp, nm), t, bound in rows[:5]:
            print(f"  dp={dp:<3d} tp={tp:<2d} micro={nm:<2d} -> {t:9.4f}s ({bound})")
        base = next((t for (d, tp, _), t, _ in rows if (d, tp) == (16, 16)), None)
        best = rows[0]
        print(f"  model: best {best[0]} vs (16,16) baseline {base:.4f}s "
              f"-> predicted {base / best[1]:.1f}x")
        m = measured(arch, shape)
        if "baseline" in m:
            opt = {k: v for k, v in m.items() if k != "baseline"}
            if opt:
                k, v = min(opt.items(), key=lambda kv: kv[1])
                agree = (best[0][:2] != (16, 16)) == (v < m["baseline"])
                print(f"  the port's dry-run: baseline {m['baseline']:.4f}s, best preset "
                      f"'{k}' {v:.4f}s ({m['baseline'] / v:.1f}x) -> ranking "
                      f"{'agrees' if agree else 'disagrees'}")
        result[arch] = {"rows": rows, "measured": m}
    return result


if __name__ == "__main__":
    main()
