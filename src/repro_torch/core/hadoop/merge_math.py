"""Merge-round mathematics (paper §2.3, Eqs. 20-22).

Hadoop merges ``N`` sorted spill files with an external multi-pass merge of
fan-in ``F`` (= ``io.sort.factor``).  Hadoop sizes the *first* pass so that all
subsequent intermediate passes merge exactly ``F`` files.  The paper gives
closed forms valid for ``N <= F**2`` and prescribes a simulation-based
approach beyond that; both are implemented here and cross-checked in tests.

Terminology (paper's):
* ``first pass``    — merges ``calc_num_spills_first_pass(N, F)`` files.
* ``intermediate``  — every pass except the final one; the paper's
  ``calcNumSpillsIntermMerge`` counts the number of *spill-file equivalents
  read* during the first + intermediate passes.
* ``final merge``   — merges the remaining files/streams directly into the
  consumer; ``calcNumSpillsFinalMerge`` is the *number of streams* in it.

Worked example used throughout the paper: ``N=30, F=10`` ->
first pass merges 3, intermediate reads total 23, final merge has 10 streams,
4 merge passes in total.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

__all__ = [
    "calc_num_spills_first_pass",
    "calc_num_spills_interm_merge",
    "calc_num_spills_final_merge",
    "num_merge_passes",
    "ste_floor",
    "ste_ceil",
    "ste_round",
    "MergePlan",
    "simulate_merge",
    "merge_plan",
]


# --------------------------------------------------------------------------
# straight-through rounding (shared by the batched model and calibration)
# --------------------------------------------------------------------------
#
# The spill/merge round counts (Eqs. 15, 20-26, 31-32 and the reduce-side
# Eqs. 46-53 neighborhood) are floor/ceil expressions.  ``torch.floor`` /
# ``torch.ceil`` have an exactly-zero derivative, so any gradient taken
# through the job model w.r.t. the knobs behind them (pSortMB, pSpillPerc,
# pSortFactor, selectivities, ...) silently dies there.  These helpers keep
# the FORWARD VALUES BIT-FOR-BIT IDENTICAL to torch.floor/ceil/round
# (``torch.round`` rounds half to even, as ``numpy.round`` does) while
# letting the gradient pass through unchanged for finite inputs (the
# straight-through estimator: d/dx = 1; non-finite inputs get a zero
# gradient so an ``inf`` primal can never turn a finite gradient into NaN).
#
# Each helper is a custom operator, ``repro_torch::ste_<name>``, with its
# gradient registered beside it, rather than a ``torch.autograd.Function``:
# tracing (``make_fx``) records a custom operator as one node of that name,
# while an ``autograd.Function`` dissolves into a bare ``aten.floor``.  The
# static analyzer's grad-blocker checker (:mod:`repro_torch.analysis`) tells
# the model's deliberate straight-through roundings from a bare ``floor`` on
# a differentiated path by that node.  The operators are defined at first
# use, and torch is imported lazily, so that the pure-Python half of this
# module stays importable without it.

#: the namespace of the straight-through operators in ``torch.ops``
STE_NAMESPACE = "repro_torch"

_STE_CACHE: dict = {}


def _ste_wrap(name: str):
    """Define (once) the straight-through custom operator for torch.<name>."""
    if name in _STE_CACHE:
        return _STE_CACHE[name]
    import torch

    rounder = getattr(torch, name)

    @torch.library.custom_op(f"{STE_NAMESPACE}::ste_{name}", mutates_args=(),
                             schema="(Tensor x) -> Tensor")
    def op(x):
        return rounder(x)

    @op.register_fake
    def _(x):
        return torch.empty_like(x)

    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(torch.isfinite(x), g, torch.zeros_like(g))

    op.register_autograd(backward, setup_context=setup_context)
    _STE_CACHE[name] = op
    return op


def ste_floor(x):
    """``torch.floor(x)`` forward, identity gradient (straight-through)."""
    return _ste_wrap("floor")(x)


def ste_ceil(x):
    """``torch.ceil(x)`` forward, identity gradient (straight-through)."""
    return _ste_wrap("ceil")(x)


def ste_round(x):
    """``torch.round(x)`` forward (half to even), identity gradient."""
    return _ste_wrap("round")(x)


def calc_num_spills_first_pass(n: int, f: int) -> int:
    """Eq. 20 — number of spills merged by the first merge pass."""
    if n <= f:
        return n
    if (n - 1) % (f - 1) == 0:
        return f
    return (n - 1) % (f - 1) + 1


def calc_num_spills_interm_merge(n: int, f: int) -> int:
    """Eq. 21 — spill-equivalents read during first + intermediate passes.

    Closed form valid for ``n <= f**2`` (asserted); use :func:`simulate_merge`
    beyond that, as the paper prescribes.
    """
    if n <= f:
        return 0
    assert n <= f * f, f"closed form requires N <= F^2 (got N={n}, F={f})"
    p = calc_num_spills_first_pass(n, f)
    return p + ((n - p) // f) * f


def calc_num_spills_final_merge(n: int, f: int) -> int:
    """Eq. 22 — number of streams merged by the final merge pass."""
    if n <= f:
        return n
    assert n <= f * f, f"closed form requires N <= F^2 (got N={n}, F={f})"
    p = calc_num_spills_first_pass(n, f)
    s = calc_num_spills_interm_merge(n, f)
    return 1 + (n - p) // f + (n - s)


def num_merge_passes(n: int, f: int) -> int:
    """Eq. 25 — total number of merge passes (incl. first and final)."""
    if n <= 1:
        return 0
    if n <= f:
        return 1
    assert n <= f * f, f"closed form requires N <= F^2 (got N={n}, F={f})"
    p = calc_num_spills_first_pass(n, f)
    return 2 + (n - p) // f


@dataclass(frozen=True)
class MergePlan:
    """Full accounting of a multi-pass merge of ``n`` unit-weight spills."""

    n: int
    f: int
    first_pass: int          # files merged in the first pass
    interm_reads: float      # spill-equivalents read before the final pass
    final_merge_width: int   # streams in the final merge
    passes: int              # total merge passes (incl. first and final)


def simulate_merge(n: int, f: int) -> MergePlan:
    """Exact simulation of Hadoop's merge loop for arbitrary ``n``.

    Replicates ``org.apache.hadoop.mapred.Merger`` semantics: the first pass
    merges ``calc_num_spills_first_pass(n, f)`` of the smallest files; every
    subsequent pass merges the ``f`` smallest remaining files, until at most
    ``f`` remain, which form the final merge.  File sizes are tracked in
    spill-equivalents (original spills have weight 1; merged files carry the
    summed weight) so re-merges of merged files — which occur only when
    ``n > f**2`` — are charged correctly.

    For ``n <= f**2`` this reproduces the paper's closed forms exactly
    (property-tested in ``tests/test_merge_math.py``).
    """
    if n <= 1:
        return MergePlan(n, f, 0, 0.0, n, 0)
    if n <= f:
        return MergePlan(n, f, n, 0.0, n, 1)

    heap: list[float] = [1.0] * n
    heapq.heapify(heap)
    interm_reads = 0.0
    passes = 0

    # First pass: merge P smallest files.
    p = calc_num_spills_first_pass(n, f)
    merged = sum(heapq.heappop(heap) for _ in range(p))
    interm_reads += merged
    heapq.heappush(heap, merged)
    passes += 1

    # Intermediate passes: merge F smallest until <= F files remain.
    while len(heap) > f:
        merged = sum(heapq.heappop(heap) for _ in range(f))
        interm_reads += merged
        heapq.heappush(heap, merged)
        passes += 1

    # Final merge of whatever remains.
    final_width = len(heap)
    passes += 1
    return MergePlan(n, f, p, interm_reads, final_width, passes)


def merge_plan(n: int, f: int) -> MergePlan:
    """Closed forms when valid (``n <= f**2``), exact simulation otherwise."""
    if n <= f * f:
        return MergePlan(
            n,
            f,
            calc_num_spills_first_pass(n, f) if n > f else (n if n > 1 else 0),
            float(calc_num_spills_interm_merge(n, f)),
            calc_num_spills_final_merge(n, f) if n > 1 else n,
            num_merge_passes(n, f),
        )
    return simulate_merge(n, f)
