"""recompile-hazard: trace instability that breaks one graph per key set.

The port runs its chunked evaluator eagerly, but its contract is the
reference's: :class:`repro_torch.search.evaluator.ChunkedEvaluator` pads
every chunk to one fixed shape, so a body traced once per override key set
serves every grid.  A later CUDA-graph capture of the evaluator chunk (or of
a decode step) replays one recorded graph and needs exactly that.  Two
things silently break it:

* **scalar inputs** — a Python number at the trace boundary.  ``make_fx``
  bakes it into the graph as a constant, so every other value is a
  different graph (the counterpart of the reference's ``weak_type_input``).
* **unstable bodies** — a body that cannot be traced at all (a Python
  branch on a tensor's value reads it on the host: ``trace_error``), or
  whose graph differs between two inputs of one key set (``retrace``,
  ``signature_drift``).

The first is read off each target's example arguments.  The second is
probed by tracing the evaluator's chunk body twice with ``make_fx`` — same
key set, different values and pre-pad row counts — and comparing the two
graphs.  Nothing here runs through ``torch.compile``; the port runs nothing
through it.
"""

from __future__ import annotations

from ..absint import leaves
from ..findings import Finding

__all__ = ["run", "probe_trace_stability", "scalar_input_findings"]

_HINT_SCALAR = (
    "pass tensors at the boundary (torch.as_tensor(..., dtype=...), as "
    "split_overrides does for evaluator columns)"
)
_HINT_RETRACE = (
    "make the body a function of static shapes only: pad to fixed chunk "
    "shapes (pad_block) and branch with torch.where, not Python control "
    "flow on tensor values"
)


def scalar_input_findings(traced, target_name: str) -> list[Finding]:
    """Python numbers among a traced target's example arguments."""
    n = sum(1 for a in leaves(traced.args)
            if isinstance(a, (bool, int, float)))
    if not n:
        return []
    return [Finding(
        checker="recompile-hazard",
        target=target_name,
        kind="scalar_input",
        message=(f"{n} traced input(s) are Python numbers: make_fx bakes "
                 "them into the graph as constants, so each value is a "
                 "different graph"),
        location=f"{target_name} signature in trace",
        hint=_HINT_SCALAR,
    )]


def _signature(gm) -> list[str]:
    out = []
    for n in gm.graph.nodes:
        if n.op == "placeholder":
            v = n.meta.get("val")
            out.append(f"{getattr(v, 'dtype', type(v).__name__)}"
                       f"{list(getattr(v, 'shape', ()))}")
    return out


def probe_trace_stability(fn, args_a, args_b, *, target_name: str,
                          location: str) -> list[Finding]:
    """Trace ``fn`` on two same-key-set argument sets; different graphs
    mean one recorded graph cannot serve both."""
    from torch.fx.experimental.proxy_tensor import make_fx

    try:
        ga = make_fx(fn)(*args_a)
        gb = make_fx(fn)(*args_b)
    except Exception as e:  # a value-dependent branch, or any trace failure
        return [Finding(
            checker="recompile-hazard",
            target=target_name,
            kind="trace_error",
            message=f"tracing raised {type(e).__name__}: {str(e)[:300]}",
            location=location,
            hint=_HINT_RETRACE,
        )]
    sa, sb = ga.code, gb.code
    if sa != sb:
        import difflib
        diff = [ln for ln in difflib.unified_diff(
            sa.splitlines(), sb.splitlines(), lineterm="", n=0)
            if ln.startswith(("+", "-")) and not ln.startswith(("+++", "---"))]
        return [Finding(
            checker="recompile-hazard",
            target=target_name,
            kind="retrace",
            message=("same key set, different graph (" +
                     f"{len(diff)} line(s) differ; first: "
                     f"{diff[0][:120] if diff else '?'}): each distinct "
                     "grid/block needs a graph of its own"),
            location=location,
            hint=_HINT_RETRACE,
        )]
    in_a, in_b = _signature(ga), _signature(gb)
    if in_a != in_b:
        return [Finding(
            checker="recompile-hazard",
            target=target_name,
            kind="signature_drift",
            message="same key set, different input shapes or dtypes: "
                    f"{in_a} vs {in_b}",
            location=location,
            hint=_HINT_SCALAR,
        )]
    return []


def _chunked_evaluator_probe(device) -> list[Finding]:
    import numpy as np

    from repro_torch.core.hadoop.params import (CostFactors, HadoopParams,
                                                ProfileStats)
    from repro_torch.search.evaluator import (ChunkedEvaluator, _run_model,
                                              pad_block, split_overrides)

    ev = ChunkedEvaluator(HadoopParams(), ProfileStats(), CostFactors(),
                          chunk=8, device=device)

    def body(cols, static):
        return _run_model(ev._model_fn, static, cols, ev.chunk)

    def blocks(values):
        batched, static, n = split_overrides(
            ev.base_cfg, {"pSortMB": np.asarray(values, dtype=np.float64)})
        cols, _mask = pad_block(batched, 0, n, ev.chunk)
        return (cols, static)

    # same key set {pSortMB}: different values AND different pre-pad length
    return probe_trace_stability(
        body, blocks([100.0, 200.0, 300.0]), blocks([50.0] * 7),
        target_name="chunked-evaluator",
        location="src/repro_torch/search/evaluator.py in _run_model")


def run(ctx) -> list[Finding]:
    findings: list[Finding] = []
    for t in ctx.targets:
        if not t.traceable:
            continue
        findings.extend(scalar_input_findings(ctx.traced(t), t.name))
    findings.extend(_chunked_evaluator_probe(ctx.device))
    return findings
