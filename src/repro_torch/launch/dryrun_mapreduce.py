"""Dry-run the paper's own workload at pod scale: the MapReduce pipeline
(map -> combine -> ``all_to_all_single`` shuffle -> reduce) traced over a
process group of 16 placeholder ranks, with the shuffle's collective bytes
counted -- Eq. 90's netTransferSize measured from the traced step instead of
predicted.

The port of ``repro/launch/dryrun_mapreduce.py``.  The reference compiles
its ``shard_map`` pipeline on the 256-chip production mesh and shuffles over
the ``data`` axis (16 mapper/reducer groups); here
:func:`repro_torch.mapreduce.distributed.make_pipeline` runs as rank 0 of a
fake group of 16 ranks (:func:`repro_torch.launch.dryrun.fake_world`) on
meta tensors, with the combine on ``index_add_`` (``use_kernel=False``, the
reference's ``use_pallas=False``), under the dry-run's
:class:`~repro_torch.launch.dryrun.Census`.  No card is needed.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_mapreduce \\
        --pairs-per-shard 1048576 --key-space 1048576
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.core.hadoop.params import CostFactors, HadoopParams, ProfileStats
from repro_torch.core.hadoop.ref import job_model
from repro_torch.core.roofline import roofline_terms
from repro_torch.launch.dryrun import DEFAULT_OUT, Census, fake_world
from repro_torch.mapreduce.distributed import make_pipeline, wordcount_map

__all__ = ["SHARDS", "main", "run"]

#: mapper/reducer shards: the reference shuffles over its mesh's data axis
SHARDS = 16
#: chips in the roofline terms: the reference's production mesh
CHIPS = 256


def run(pairs_per_shard: int, key_space: int) -> dict:
    """The artifact: traced collectives and roofline terms of one pipeline
    call over ``SHARDS`` ranks, beside the paper's Eq. 90 prediction for
    the same job."""
    total_pairs = pairs_per_shard * SHARDS
    meta = torch.device("meta")
    census = Census()
    with fake_world(SHARDS):
        pipe = make_pipeline(map_fn=wordcount_map, key_space=key_space,
                             use_kernel=False, device=meta)
        keys = torch.empty(total_pairs, dtype=torch.int32, device=meta)
        values = torch.empty(total_pairs, dtype=torch.float32, device=meta)
        with census:
            pipe(keys, values)
    coll = census.coll
    cost = {"flops": census.flops, "bytes accessed": census.bytes}
    terms = roofline_terms(cost, coll, CHIPS)

    # the paper's Eq. 90 prediction for the same job shape
    hp = HadoopParams(
        pNumNodes=16, pNumMappers=16, pNumReducers=16,
        pSplitSize=pairs_per_shard * 12.0, pUseCombine=True,
    )
    st = ProfileStats(sInputPairWidth=12.0, sMapPairsSel=4.0, sMapSizeSel=4.0,
                      sCombinePairsSel=0.25, sCombineSizeSel=0.25)
    jm = job_model(hp, st, CostFactors())
    return {
        "pairs": total_pairs,
        "key_space": key_space,
        "shards": SHARDS,
        "hw": "tpu_v5e",
        "collectives": {"total_bytes": coll.total_bytes, "by_kind": dict(coll.by_kind),
                        "count": coll.count},
        "roofline": {
            "compute_s": terms.compute_s, "memory_s": terms.memory_s,
            "collective_s": terms.collective_s, "bound": terms.bound,
        },
        "paper_eq90_net_bytes": jm.netTransferSize,
        "status": "ok",
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--pairs-per-shard", type=int, default=1 << 20)
    ap.add_argument("--key-space", type=int, default=1 << 20)
    ap.add_argument("--out", default=os.path.join(DEFAULT_OUT, "mapreduce_pipeline.json"))
    args = ap.parse_args(argv)
    out = run(args.pairs_per_shard, args.key_space)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
