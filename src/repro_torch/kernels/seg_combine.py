"""``seg_combine`` on Hopper: the CUDA kernel's routes, launcher and launch
geometry, its plain version, and a CPU mirror of its reduction.

The kernel (``csrc/seg_combine.cu``) replaces the reference package's Pallas
kernel ``repro/kernels/seg_combine.py::seg_combine_kernel``: per-partition
fp32 sums ``out[p, :] = sum(values[n, :] for ids[n] == p)``, with ids outside
``[0, P)`` dropped and ids in any order.  It is a reduce-by-key that sums
equal ids in registers and shared memory before any global atomic; the
source says why, and what each of its three routes does.  For D == 1 a
segmented scan over each CTA's rows sums every chain of equal ids once,
and the chain sums go

* ``"bins"`` (P <= :data:`BINS_MAX_P`): straight to global atomics where a
  pass of 2,048 rows has few of them (sorted ids), else into per-CTA
  shared-memory bins, flushed once per CTA, so unsorted ids cost at most P
  global atomics a CTA;
* ``"global"`` (larger P): straight to global atomics;

and for D > 1, ``"columns"``: a thread walks down one column of a CTA's
rows.

:func:`route` picks the route, :func:`launch_spec` and :func:`coverage` give
its geometry, and :func:`reduce_plan` repeats its association on the CPU and
counts the global atomics it issues.  The library is built and loaded at
first use by :mod:`repro_torch.kernels._build`.

:func:`seg_combine_torch` is the plain PyTorch version of the same
function.  The CPU path of :func:`repro_torch.kernels.seg_combine` and the
tests use it; on the card it is only the yardstick the kernel is held to.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ._build import LaunchSpec, check, launch, load

__all__ = ["BINS_MAX_P", "ROUTES", "Geometry", "ReducePlan", "coverage",
           "geometry", "launch_spec", "reduce_plan", "route", "rows_per_cta",
           "seg_combine_cuda", "seg_combine_torch"]

ROWS = 8                 # consecutive rows of one thread (rows routes)
THREADS = 256            # threads a CTA (rows routes)
PASS = THREADS * ROWS    # rows a CTA loads at once
COL_THREADS = 128        # columns a CTA (columns route), a thread each
COL_ROWS = 64            # rows a CTA (columns route)
BINS_MAX_P = 12_288      # bins that fit 48 KB of shared memory
BINS_AT = PASS // 4      # a pass with more sums to add than this uses the bins
SMS = 132                # an H100 SXM's SMs
MAX_PASSES = 16
#: route name -> the C enum (csrc/seg_combine.cu::Route)
ROUTES = {"bins": 0, "global": 1, "columns": 2}

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
         ctypes.c_void_p]
_SIGNATURES = {"seg_combine_f32": _ARGS, "seg_combine_bf16": _ARGS}
_FN: dict[torch.dtype, object] = {}     # the loaded C entry point per dtype


def route(n: int, d: int, p: int) -> str:
    """The kernel's route for (N, D, P): ``"columns"`` for D > 1; for D == 1
    ``"bins"`` where P bins fit a CTA's shared memory, else
    ``"global"``."""
    if d > 1:
        return "columns"
    return "bins" if p <= BINS_MAX_P else "global"


def rows_per_cta(n: int, d: int, p: int, kind: str | None = None) -> int:
    """Rows one CTA takes: 64 on the columns route; on the rows routes whole
    passes of 2,048, as many as keep about two CTAs per SM (at most 16)."""
    kind = kind or route(n, d, p)
    if kind == "columns":
        return COL_ROWS
    passes = min(MAX_PASSES, max(1, -(-n // (PASS * 2 * SMS))))
    return PASS * passes


def launch_spec(n: int, d: int, p: int, kind: str | None = None) -> LaunchSpec:
    """The kernel's launch: rows routes 256 threads a CTA, one CTA per
    :func:`rows_per_cta` rows (the bins route's P fp32 bins in dynamic
    shared memory); columns route 128 threads a CTA, a grid of row blocks x
    column blocks."""
    kind = kind or route(n, d, p)
    rows = rows_per_cta(n, d, p, kind)
    if kind == "columns":
        return LaunchSpec(grid=(-(-n // rows), -(-d // COL_THREADS), 1),
                          block=(COL_THREADS, 1, 1), smem_bytes=0)
    return LaunchSpec(grid=(-(-n // rows), 1, 1), block=(THREADS, 1, 1),
                      smem_bytes=4 * p if kind == "bins" else 0)


def coverage(n: int, d: int, p: int, kind: str | None = None
             ) -> tuple[tuple[int, int, int], tuple[int, int, int]]:
    """What the grid must cover, per grid axis (x, y, z): the N rows and D
    columns, and what one CTA covers of them: :func:`rows_per_cta` rows and
    all D columns (rows routes, D == 1) or 128 (columns route).  The kernel
    drops the rows and columns past N and D."""
    kind = kind or route(n, d, p)
    cols = COL_THREADS if kind == "columns" else d
    return (n, d, 1), (rows_per_cta(n, d, p, kind), cols, 1)


class Geometry(NamedTuple):
    """One call's route, launch, and what its grid covers (:func:`coverage`:
    ``shape`` per grid axis and ``tile``, what one CTA covers)."""

    route: str
    spec: LaunchSpec
    shape: tuple[int, int, int]
    tile: tuple[int, int, int]


@functools.lru_cache(maxsize=256)
def geometry(n: int, d: int, p: int, kind: str | None = None) -> Geometry:
    """:func:`route`, :func:`launch_spec` and :func:`coverage` of one call,
    kept per shape: a launch spends no host time recomputing them."""
    kind = kind or route(n, d, p)
    return Geometry(kind, launch_spec(n, d, p, kind).check("seg_combine"),
                    *coverage(n, d, p, kind))


def seg_combine_cuda(
    values: torch.Tensor, ids: torch.Tensor, num_parts: int, geo: Geometry,
) -> torch.Tensor:
    """Zero the output and launch the kernel with ``geo`` (its route and
    launch), both on the current stream, in one C call; no checks, no
    synchronise.

    ``values`` (N, D) contiguous f32/bf16 and ``ids`` (N,) contiguous int32
    on one CUDA device, N * D > 0, P > 0.  Callers go through
    :func:`repro_torch.kernels.seg_combine`, which checks all of that.
    """
    n, d = values.shape
    out = values.new_empty((num_parts, d), dtype=torch.float32)
    fn = _FN.get(values.dtype)
    if fn is None:
        lib = load("seg_combine", _SIGNATURES)
        fn = _FN[values.dtype] = (lib.seg_combine_f32 if values.dtype == torch.float32
                                  else lib.seg_combine_bf16)
    spec = geo.spec
    err = launch(fn, (values.data_ptr(), ids.data_ptr(), out.data_ptr(), n, d,
                      num_parts, ROUTES[geo.route], spec.grid[0], spec.grid[1],
                      spec.block[0], geo.tile[0], spec.smem_bytes), values.device)
    check(err, "seg_combine")
    return out


def seg_combine_torch(
    values: torch.Tensor, ids: torch.Tensor, num_parts: int
) -> torch.Tensor:
    """Plain PyTorch version: ids outside ``[0, P)`` contribute nothing,
    then ``index_add_`` in fp32."""
    out = torch.zeros((num_parts, values.shape[1]), dtype=torch.float32,
                      device=values.device)
    if num_parts == 0:
        return out
    keep = (ids >= 0) & (ids < num_parts)
    vals = torch.where(keep[:, None], values.float(), 0.0)
    return out.index_add_(0, torch.where(keep, ids, 0), vals)


# ---------------------------------------------------------------------------
# the kernel's reduction, repeated on the CPU
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ReducePlan:
    """What the kernel computes for one call, as :func:`reduce_plan` repeats
    it: ``out`` (P, D) fp32, the number of global ``atomics`` it adds into
    ``out``, the ``route``, the number of ``ctas``, and of their passes of
    2,048 rows (D == 1) those that added into shared-memory bins
    (``bins_passes``) out of ``passes``."""

    out: torch.Tensor
    atomics: int
    route: str
    ctas: int
    passes: int = 0
    bins_passes: int = 0


def _thread_runs(ids: torch.Tensor, vals: torch.Tensor):
    """Runs of equal ids in each thread's 8 rows, summed in row order as
    the kernel sums them.  ``ids``/``vals`` (T, 8).  Returns (first id,
    first sum, last id, last sum, runs, closed): ``closed`` holds the runs
    after the first that end before the last, as (thread, id, sum)."""
    last, acc = ids[:, 0].clone(), vals[:, 0].clone()
    first_sum = torch.zeros_like(acc)
    runs = torch.ones_like(last)
    closed = []
    t = torch.arange(ids.shape[0])
    for j in range(1, ROWS):
        brk = ids[:, j] != last
        first_end = brk & (runs == 1)
        first_sum = torch.where(first_end, acc, first_sum)
        mid = brk & (runs > 1)
        closed.append((t[mid], last[mid], acc[mid]))
        runs = runs + brk.long()
        last = torch.where(brk, ids[:, j], last)
        acc = torch.where(brk, vals[:, j], acc + vals[:, j])
    first_sum = torch.where(runs == 1, acc, first_sum)
    return ids[:, 0], first_sum, last, acc, runs, closed


def _scan_partials(ids: torch.Tensor, vals: torch.Tensor):
    """The scan over passes of 2,048 rows, ``ids``/``vals`` (passes, 256,
    8): the sums each pass adds, as (pass, id, value) in thread order and
    the kernel's association, and per pass the number of sums it adds (as
    the kernel counts them: a thread's middle runs, dropped ids among them,
    and its chain ends)."""
    n_pass = ids.shape[0]
    first, first_sum, last, last_sum, runs, closed = _thread_runs(
        ids.reshape(-1, ROWS), vals.reshape(-1, ROWS))
    shape = (n_pass, THREADS)
    first, first_sum, last, last_sum, runs = (
        x.reshape(shape) for x in (first, first_sum, last, last_sum, runs))
    single = runs == 1
    none = torch.full((n_pass, 1), -2, dtype=first.dtype)
    prev = torch.cat([none, last[:, :-1]], 1)
    nxt = torch.cat([first[:, 1:], none], 1)
    cont = first == prev
    head = ~(single & cont)
    # within each warp: 5 steps of Hillis-Steele, as __shfl_up_sync
    s = last_sum.reshape(n_pass, THREADS // 32, 32).clone()
    h = head.reshape(n_pass, THREADS // 32, 32).clone()
    lane = torch.arange(32)
    for off in (1, 2, 4, 8, 16):
        s_up = torch.roll(s, off, 2)
        h_up = torch.roll(h, off, 2)
        on = lane >= off
        s = torch.where(on & ~h, s_up + s, s)
        h = torch.where(on, h | h_up, h)
    # the warps' tails, combined in warp order
    carry = torch.zeros((n_pass, THREADS // 32))
    c = torch.zeros(n_pass)
    for w in range(1, THREADS // 32):
        c = torch.where(h[:, w - 1, 31], s[:, w - 1, 31], c + s[:, w - 1, 31])
        carry[:, w] = c
    s = torch.where(h, s, carry[:, :, None] + s).reshape(shape)
    s_prev = torch.cat([torch.zeros((n_pass, 1)), s[:, :-1]], 1)
    s_prev[:, 32::32] = carry[:, 1:]
    head_val = torch.where(cont, s_prev + first_sum, first_sum)
    thread = torch.arange(n_pass * THREADS).reshape(shape)
    add_first = ~single & (first >= 0)
    add_last = (nxt != last) & (last >= 0)
    adds = ((runs - 2).clamp(min=0) + add_first.long() + add_last.long()).sum(1)
    parts = [(t, i, v) for t, i, v in closed]
    parts.append((thread[add_first], first[add_first], head_val[add_first]))
    parts.append((thread[add_last], last[add_last], s[add_last]))
    t = torch.cat([p[0] for p in parts])
    order = torch.argsort(t, stable=True)
    return (t[order] // THREADS, torch.cat([p[1] for p in parts])[order],
            torch.cat([p[2] for p in parts])[order], adds)


def reduce_plan(values: torch.Tensor, ids: torch.Tensor, num_parts: int,
                kind: str | None = None) -> ReducePlan:
    """The kernel's reduction on the CPU, for ``values`` (N, D) and ``ids``
    (N,) int32 with P = ``num_parts``, on route ``kind`` (default
    :func:`route`): each CTA's sums in the kernel's association (a thread's
    runs in row order; the scan's shuffle steps and warp order; a column's
    runs in row order), then the global atomics, added in CTA order (on the
    card they land in any order).  On the bins route a pass with more than
    :data:`BINS_AT` sums to add puts them into its CTA's bins, in
    thread order (on the card in any order), and a bin that sums to 0 is
    not flushed, as in the kernel."""
    n, d = values.shape
    kind = kind or route(n, d, num_parts)
    spec = launch_spec(n, d, num_parts, kind)
    rows = rows_per_cta(n, d, num_parts, kind)
    ctas = spec.grid[0]
    keep = (ids >= 0) & (ids < num_parts)
    idx = torch.where(keep, ids.long(), -1)
    vals = torch.where(keep[:, None], values.float(), 0.0)
    pad = ctas * rows - n
    idx = torch.cat([idx, torch.full((pad,), -1, dtype=torch.long)])
    vals = torch.cat([vals, torch.zeros((pad, d))])
    if kind == "columns":
        cta_of, pid, col, val = _columns_partials(idx.reshape(ctas, rows),
                                                  vals.reshape(ctas, rows, d))
        passes = bins_passes = 0
    else:
        pass_of, pid, val, adds = _scan_partials(
            idx.reshape(-1, THREADS, ROWS), vals.reshape(-1, THREADS, ROWS))
        to_bins = (adds > BINS_AT if kind == "bins"
                   else torch.zeros_like(adds, dtype=torch.bool))
        passes, bins_passes = adds.numel(), int(to_bins.sum())
        kept = pid >= 0                  # the kernel adds no dropped id
        pass_of, pid, val = pass_of[kept], pid[kept], val[kept]
        cta_of = pass_of // (rows // PASS)
        binned = to_bins[pass_of]
        bins = torch.zeros(ctas * num_parts)
        bins.index_add_(0, cta_of[binned] * num_parts + pid[binned], val[binned])
        b_cta, b_pid = torch.nonzero(bins.reshape(ctas, num_parts) != 0,
                                     as_tuple=True)
        cta_of = torch.cat([cta_of[~binned], b_cta])
        pid = torch.cat([pid[~binned], b_pid])
        val = torch.cat([val[~binned], bins[b_cta * num_parts + b_pid]])
        order = torch.argsort(cta_of, stable=True)
        cta_of, pid, val = cta_of[order], pid[order], val[order]
        col = torch.zeros_like(pid)
    out = torch.zeros(num_parts * d)
    out.index_add_(0, pid * d + col, val)
    return ReducePlan(out=out.reshape(num_parts, d), atomics=int(pid.numel()),
                      route=kind, ctas=ctas,
                      passes=passes, bins_passes=bins_passes)


def _columns_partials(ids: torch.Tensor, vals: torch.Tensor):
    """The columns route: ``ids`` (CTAs, rows), ``vals`` (CTAs, rows, D).
    Each column's runs down a CTA's rows, summed in row order: (CTA, id,
    column, value) of each run with a kept id."""
    ctas, rows, d = vals.shape
    cur = torch.full((ctas,), -1, dtype=torch.long)
    acc = torch.zeros((ctas, d))
    out = []
    c = torch.arange(ctas)
    for r in range(rows):
        brk = ids[:, r] != cur
        m = brk & (cur >= 0)
        out.append((c[m], cur[m], acc[m]))
        acc = torch.where(brk[:, None], vals[:, r], acc + vals[:, r])
        cur = torch.where(brk, ids[:, r], cur)
    m = cur >= 0
    out.append((c[m], cur[m], acc[m]))
    cta = torch.cat([o[0] for o in out])
    order = torch.argsort(cta, stable=True)
    cta = cta[order]
    pid = torch.cat([o[1] for o in out])[order]
    acc = torch.cat([o[2] for o in out])[order]
    cols = torch.arange(d)
    return (cta.repeat_interleave(d), pid.repeat_interleave(d),
            cols.repeat(pid.numel()), acc.reshape(-1))
