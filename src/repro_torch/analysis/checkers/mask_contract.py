"""mask-contract: cost totals must flow through the shared masking helpers.

Carried over from the reference's ``repro/analysis/checkers/mask_contract.py``
and run over the port's own sources.  The silent-``inf`` class: an evaluator (or strategy) that reads raw
model costs without ``sanitize_costs``/``masked_total`` lets NaN/inf rows
win or poison reductions, and validity flags consumed row-by-row before
being combined defeat the ``valid == 0`` escape hatch.  Two rules:

* **AST rule** — every ``Evaluator`` subclass's ``evaluate`` (and any
  function constructing a ``SearchResult`` with ``total_cost=``) must call
  ``masked_total`` or ``sanitize_costs``, or delegate to another
  ``evaluate``.  Purely-abstract bodies (``raise NotImplementedError``) are
  exempt.
* **graph rule** — every traced *model* target must emit a validity output
  (``valid`` / ``converged``) alongside its costs; a model whose cost can
  be ``inf``/NaN with no flag to mask on cannot honor the contract at all.

The AST rule runs over ``src/repro_torch/`` (and over fixture source in
the analyzer's own tests via :func:`check_source`).
"""

from __future__ import annotations

import ast
import os

from ..findings import Finding

__all__ = ["run", "check_source", "iter_source_files"]

_MASK_HELPERS = ("masked_total", "sanitize_costs")
_VALIDITY_NAMES = ("valid", "converged")
_HINT = (
    "route totals through repro_torch.search.evaluator.masked_total (or "
    "sanitize raw costs with sanitize_costs) and emit a validity flag the "
    "caller can mask on"
)


def _calls_in(node: ast.AST) -> set[str]:
    names = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            f = n.func
            if isinstance(f, ast.Name):
                names.add(f.id)
            elif isinstance(f, ast.Attribute):
                names.add(f.attr)
    return names


def _is_abstract(fn: ast.FunctionDef) -> bool:
    for n in ast.walk(fn):
        if isinstance(n, ast.Raise):
            exc = n.exc
            name = ""
            if isinstance(exc, ast.Call) and isinstance(exc.func, ast.Name):
                name = exc.func.id
            elif isinstance(exc, ast.Name):
                name = exc.id
            if name == "NotImplementedError":
                return True
    return False


def _builds_search_result(fn: ast.FunctionDef) -> bool:
    for n in ast.walk(fn):
        if isinstance(n, ast.Call):
            f = n.func
            nm = f.id if isinstance(f, ast.Name) else (
                f.attr if isinstance(f, ast.Attribute) else "")
            if nm == "SearchResult" and any(
                    kw.arg == "total_cost" for kw in n.keywords):
                return True
    return False


def check_source(text: str, filename: str) -> list[Finding]:
    """AST rule over one file's source text."""
    try:
        tree = ast.parse(text)
    except SyntaxError:
        return []
    findings: list[Finding] = []

    def check_fn(fn: ast.FunctionDef, owner: str):
        if _is_abstract(fn):
            return
        calls = _calls_in(fn)
        if any(h in calls for h in _MASK_HELPERS):
            return
        if "evaluate" in calls or "evaluate_small" in calls:
            return          # delegates to another evaluate implementation
        findings.append(Finding(
            checker="mask-contract",
            target=owner,
            kind="unmasked_total",
            message=(f"{owner}.{fn.name} produces a cost total without "
                     "masked_total/sanitize_costs — NaN/inf rows flow to "
                     "callers unmasked"),
            location=f"{filename}:{fn.lineno} in {fn.name}",
            hint=_HINT,
        ))

    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and (
                "Evaluator" in node.name
                or any("Evaluator" in getattr(b, "id", getattr(b, "attr", ""))
                       for b in node.bases)):
            for item in node.body:
                if isinstance(item, ast.FunctionDef) \
                        and item.name == "evaluate":
                    check_fn(item, node.name)
        elif isinstance(node, ast.FunctionDef) and _builds_search_result(node):
            # module-level / nested functions constructing results directly
            in_class = False  # handled above when inside Evaluator classes
            for cls in ast.walk(tree):
                if isinstance(cls, ast.ClassDef) and node in ast.walk(cls):
                    in_class = True
                    break
            if not in_class:
                check_fn(node, filename.rsplit("/", 1)[-1])
    return findings


def _repro_root() -> str:
    import repro_torch

    return os.path.dirname(os.path.abspath(repro_torch.__file__))


def iter_source_files() -> list[str]:
    root = _repro_root()
    out = []
    for dirpath, _dirnames, filenames in os.walk(root):
        if "analysis" in os.path.relpath(dirpath, root).split(os.sep):
            continue                     # the analyzer does not self-apply
        for f in sorted(filenames):
            if f.endswith(".py"):
                out.append(os.path.join(dirpath, f))
    return out


def _validity_output_findings(ctx) -> list[Finding]:
    findings = []
    for t in ctx.targets:
        if not t.traceable or t.grad_mode:
            continue                     # grad targets return bare scalars
        names = ctx.traced(t).out_names
        if not any(v in names for v in _VALIDITY_NAMES):
            findings.append(Finding(
                checker="mask-contract",
                target=t.name,
                kind="no_validity_output",
                message=("model emits no validity flag "
                         f"({'/'.join(_VALIDITY_NAMES)}) — masked-inf costs "
                         "cannot be distinguished from real ones"),
                location=f"{t.name} outputs in trace",
                hint=_HINT,
            ))
    return findings


def run(ctx) -> list[Finding]:
    findings: list[Finding] = []
    src_root = os.path.dirname(os.path.dirname(_repro_root()))
    for path in iter_source_files():
        with open(path) as f:
            text = f.read()
        rel = os.path.relpath(path, src_root)
        findings.extend(check_source(text, rel))
    findings.extend(_validity_output_findings(ctx))
    return findings
