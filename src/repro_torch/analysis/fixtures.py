"""Known-bad fixtures: one deliberately broken model per checker.

The torch versions of the reference's ``repro/analysis/fixtures.py``.  These
are the analyzer's regression suite: each fixture reproduces the bug class
its checker exists for, so a refactor that blinds a checker fails
``tests/test_torch_analysis.py`` (and ``python -m repro_torch.analysis
--smoke``) immediately.  None of them ship in any registered model.
"""

from __future__ import annotations

import math

from .interval import FINITE_TOP, Interval
from .targets import TraceTarget

__all__ = ["fixture_targets", "value_branching_body", "MASK_BAD_SOURCE",
           "bad_launch_probes", "confirm_unwritten", "selftest"]


# --------------------------------------------------------------------------
# graph-level fixtures (traced like real targets)
# --------------------------------------------------------------------------


def _build_nan_fixture(device):
    """Single-``where`` masked division: the *forward* value is fine, but
    the unguarded ``num / den`` still evaluates ``x / 0`` and poisons the
    gradient with ``0 * inf``."""
    import torch

    from .absint import trace

    def f(den, num):
        ok = den > 0.0
        return {"cost": torch.where(ok, num / den, math.inf)}

    args = (torch.tensor(2.0, device=device), torch.tensor(3.0, device=device))
    # den's axis bound attains 0
    return trace(f, *args), [Interval(0.0, math.inf, False, True),
                             Interval(0.0, math.inf, False, True)], \
        ("cost",), args


def _build_grad_fixture(device):
    """Bare ``torch.floor`` on the differentiated path (should be
    ``merge_math.ste_floor``)."""
    import torch

    from .absint import trace

    def f(x):
        return {"cost": torch.floor(x) * x}

    args = (torch.tensor(4.0, device=device),)
    return trace(f, *args), [FINITE_TOP], ("cost",), args


def _build_recompile_fixture(device):
    """A Python float crossing the trace boundary: baked in as a constant."""
    from .absint import trace

    del device      # the input is a Python number, on no device

    def f(x):
        return {"cost": x + 1.0}

    args = (3.0,)
    return trace(f, *args), [FINITE_TOP], ("cost",), args


def fixture_targets() -> list[TraceTarget]:
    return [
        TraceTarget(
            name="fixture-nan",
            doc="single-where masked division",
            build=_build_nan_fixture,
        ),
        TraceTarget(
            name="fixture-grad",
            doc="bare torch.floor on a differentiated path",
            build=_build_grad_fixture,
            grad_mode=True,
        ),
        TraceTarget(
            name="fixture-recompile",
            doc="a Python scalar at the trace boundary",
            build=_build_recompile_fixture,
        ),
    ]


def value_branching_body():
    """For :func:`.checkers.recompile.probe_trace_stability`: a Python
    branch on a tensor's *value* — the body cannot be traced at all (every
    call reads the value on the host, so no one graph serves a key set)."""
    import torch

    def body(cols):
        x = cols["pSortMB"]
        if x[0] > 4.0:                   # Python branch on a tensor's value
            x = x * 2.0
        return torch.sum(x)

    return body


# --------------------------------------------------------------------------
# AST fixture for mask-contract
# --------------------------------------------------------------------------

MASK_BAD_SOURCE = '''\
import torch


class LeakyEvaluator(Evaluator):
    """Reads raw model costs; inf rows win the argmin."""

    def evaluate(self, overrides):
        out = self._model_fn({**self.base_cfg, **overrides})
        total = out[self.cost_key]              # no masked_total
        best = int(torch.argmin(total))
        return SearchResult(total_cost=float(total[best]), best=best)
'''


# --------------------------------------------------------------------------
# launch-geometry fixtures: the counterpart of the reference's
# _bad_pallas_probe, a (4, 1000) f32 copy in (1, 300) blocks
# --------------------------------------------------------------------------


def bad_launch_probes() -> list:
    """Two faulty launches of the ``fixture_copy`` kernel:

    * the grid cut by floor division to (4, 1000 // 300) = (4, 3): columns
      900-999 of every row are never written (``coverage``);
    * one thread per element of the (1, 300) tile: a block of 300 threads,
      not a whole number of warps (``block_threads``).
    """
    from repro_torch.kernels._build import LaunchSpec
    from repro_torch.kernels.fixture_copy import THREADS, coverage

    from .checkers.launch_geometry import LaunchProbe

    shape, tile = coverage(4, 1000, (1, 300))
    return [
        LaunchProbe("fixture_copy",
                    LaunchSpec(grid=(4, 1000 // 300, 1), block=(THREADS, 1, 1),
                               smem_bytes=0), shape, tile),
        LaunchProbe("fixture_copy",
                    LaunchSpec(grid=(4, 4, 1), block=(300, 1, 1),
                               smem_bytes=0), shape, tile),
    ]


def confirm_unwritten(probe, device) -> int:
    """Launch ``probe``'s ``fixture_copy`` geometry on ``device`` into a
    NaN-filled output and check that exactly the elements the
    launch-geometry checker names stay NaN, and every other element is the
    input's.  Returns the number of unwritten elements; raises when the
    device disagrees with the checker.  On the CPU the kernel's plain
    version runs the geometry."""
    import torch

    from repro_torch.kernels import fixture_copy

    from .checkers.launch_geometry import unwritten

    R, C, _ = probe.shape
    x = torch.arange(R * C, dtype=torch.float32, device=device).reshape(R, C)
    got = fixture_copy(x, probe.tile[:2], grid=probe.spec.grid[:2]).cpu()
    claimed = torch.zeros((R, C), dtype=torch.bool)
    for axis, start, stop in unwritten(probe.spec, probe.shape, probe.tile):
        idx = [slice(None), slice(None)]
        idx[axis] = slice(start, stop)
        claimed[tuple(idx)] = True
    stayed = torch.isnan(got)
    if not torch.equal(stayed, claimed) or \
            not torch.equal(got[~claimed], x.cpu()[~claimed]):
        raise RuntimeError(
            f"fixture_copy under grid {probe.spec.grid} left "
            f"{int(stayed.sum())} elements unwritten on {device}, where the "
            f"launch-geometry checker named {int(claimed.sum())}")
    return int(claimed.sum())


# --------------------------------------------------------------------------
# self-test: every checker must fire on its fixture
# --------------------------------------------------------------------------


def selftest(device=None) -> dict[str, list]:
    """Run each checker against its known-bad fixture on ``device`` (None:
    the CUDA card); returns findings per checker name.  Every list must be
    non-empty for a healthy analyzer.  The ``coverage`` launch fixture also
    runs on the device (:func:`confirm_unwritten`)."""
    from repro_torch.compat import resolve_device

    from .checkers import CHECKERS, AnalysisContext
    from .checkers import launch_geometry, mask_contract, recompile

    dev = resolve_device(device)
    ctx = AnalysisContext(targets=fixture_targets(), device=dev)
    out: dict[str, list] = {}
    out["nan-hazard"] = CHECKERS["nan-hazard"].run(ctx)
    out["grad-blocker"] = CHECKERS["grad-blocker"].run(ctx)

    unstable = []
    for t in ctx.targets:
        unstable.extend(recompile.scalar_input_findings(ctx.traced(t), t.name))
    import torch

    unstable.extend(recompile.probe_trace_stability(
        value_branching_body(),
        ({"pSortMB": torch.zeros(8, device=dev)},),
        ({"pSortMB": torch.ones(8, device=dev)},),
        target_name="fixture-recompile",
        location="fixtures.value_branching_body"))
    out["recompile-hazard"] = unstable

    out["mask-contract"] = mask_contract.check_source(
        MASK_BAD_SOURCE, "fixture_evaluator.py")
    probes = bad_launch_probes()
    out["launch-geometry"] = launch_geometry.probe_kernels(probes)
    confirm_unwritten(probes[0], dev)
    return out
