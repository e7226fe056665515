"""The comparisons that decide ``correct``.  Each returns a list of checks
``{"name", "value", "limit"}``; a run is correct when every value is at or
under its limit.  The limits are the workload file's (``limits``)."""

from __future__ import annotations

import statistics

#: a leaf whose reference gradient is under this share of the median
#: leaf's moves under Adam by round-off alone: its change is not compared
STILL_LEAF = 1e-3


def worst_leaf_gap(program: dict, ref: dict, leaves=None) -> tuple[float, str]:
    """The largest ``|program - ref|`` of a leaf's norm, over the larger of
    the reference's norm of that leaf and of the median leaf."""
    leaves = list(ref) if leaves is None else list(leaves)
    median = statistics.median(ref[k] for k in ref)
    worst, where = 0.0, ""
    for k in leaves:
        gap = abs(program[k] - ref[k]) / max(ref[k], median, 1e-30)
        if gap > worst or not where:
            worst, where = gap, k
    return worst, where


def training(program: dict, ref: dict, limits: dict) -> list[dict]:
    """Each step's loss (relative to the reference's), the first step's
    clipped gradient and the change after the last step, by the worst
    leaf; leaves whose reference gradient is nought to rounding are left
    out of the change."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(program["losses"], ref["losses"]))
    if len(program["losses"]) != len(ref["losses"]) or loss != loss:
        loss = float("inf")
    grad, grad_leaf = worst_leaf_gap(program["grad_norms"], ref["grad_norms"])
    median = statistics.median(ref["grad_norms"].values())
    moving = [k for k, g in ref["grad_norms"].items() if g >= STILL_LEAF * median]
    change, change_leaf = worst_leaf_gap(program["change_norms"], ref["change_norms"],
                                         moving)
    return [
        {"name": "loss_gap", "value": loss, "limit": limits["loss_gap"]},
        {"name": "grad_norm_gap", "value": grad, "limit": limits["grad_norm_gap"],
         "leaf": grad_leaf},
        {"name": "change_norm_gap", "value": change, "limit": limits["change_norm_gap"],
         "leaf": change_leaf, "left_out": len(ref["grad_norms"]) - len(moving)},
    ]


def serving(gaps, limits: dict) -> list[dict]:
    """The mean, over the checked positions, of the gap by which a served
    token's reference logit lies below the reference's best there.  (The
    widest gap does not separate bf16 serving from the fp8 control: both
    flip near-ties of the top token and of the router's top-k, PERF.md
    §2.)"""
    return [{"name": "logit_gap_mean", "value": float(gaps.mean()),
             "limit": limits["logit_gap_mean"]}]
