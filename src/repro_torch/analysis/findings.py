"""Finding / report / baseline plumbing for :mod:`repro_torch.analysis`.

Carried over from the reference package's ``repro/analysis/findings.py``,
with the same finding fields, fingerprint and baseline layout.  A
:class:`Finding` is one checker hit on one target; its
:meth:`~Finding.fingerprint` is the stable identity used by the baseline
file (``analysis_baseline_torch.json`` at the repo root, the port's own),
which freezes *accepted* findings.  The fingerprint deliberately excludes line numbers — accepted findings should
survive unrelated edits — but includes file basename, function, checker,
kind, and primitive, so a finding that moves to different code re-fires.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field

__all__ = ["Finding", "Report", "load_baseline", "save_baseline",
           "DEFAULT_BASELINE"]

#: repo-root relative default baseline location
DEFAULT_BASELINE = "analysis_baseline_torch.json"

#: the frozen finding schema, the reference's
FINDING_FIELDS = ("checker", "target", "kind", "message", "location",
                  "chain", "hint")


@dataclass(frozen=True)
class Finding:
    checker: str                  # e.g. "nan-hazard"
    target: str                   # e.g. "hadoop-model"
    kind: str                     # e.g. "div0"
    message: str                  # interval/AST story
    location: str                 # "path/to/file.py:123 in fn" or "<unknown>"
    chain: tuple[str, ...] = ()   # enclosing higher-order primitive path
    hint: str = ""                # how to fix

    def fingerprint(self) -> str:
        loc = self.location
        fn = loc.rsplit(" in ", 1)[-1] if " in " in loc else "?"
        file_part = loc.split(":", 1)[0]
        base = os.path.basename(file_part) if file_part else "?"
        return "|".join((self.checker, self.target, self.kind, base, fn))

    def to_dict(self) -> dict:
        d = asdict(self)
        d["chain"] = list(self.chain)
        d["fingerprint"] = self.fingerprint()
        return d


@dataclass
class Report:
    findings: list[Finding] = field(default_factory=list)
    skipped: dict[str, str] = field(default_factory=dict)      # target -> why
    coverage_gaps: dict[str, list[str]] = field(default_factory=dict)
    checkers_run: list[str] = field(default_factory=list)

    def new_findings(self, baseline: set[str]) -> list[Finding]:
        return [f for f in self.findings if f.fingerprint() not in baseline]

    def stale_baseline(self, baseline: set[str]) -> list[str]:
        live = {f.fingerprint() for f in self.findings}
        return sorted(fp for fp in baseline if fp not in live)

    def to_dict(self) -> dict:
        return {
            "findings": [f.to_dict() for f in self.findings],
            "skipped": dict(self.skipped),
            "coverage_gaps": {k: sorted(v)
                              for k, v in self.coverage_gaps.items()},
            "checkers_run": list(self.checkers_run),
        }


def load_baseline(path: str) -> set[str]:
    """Accepted-finding fingerprints, or empty when the file is absent."""
    if not os.path.exists(path):
        return set()
    with open(path) as f:
        data = json.load(f)
    return {e["fingerprint"] for e in data.get("accepted", [])}


def save_baseline(path: str, report: Report) -> None:
    """Freeze the report's current findings as the accepted baseline."""
    data = {
        "_comment": (
            "Accepted repro_torch.analysis findings. CI fails on any "
            "finding whose fingerprint is not listed here; update "
            "deliberately via `python -m repro_torch.analysis "
            "--update-baseline` and justify each entry's `reason`."),
        "accepted": [
            {
                "fingerprint": f.fingerprint(),
                "checker": f.checker,
                "target": f.target,
                "kind": f.kind,
                "location": f.location,
                "reason": "TODO: justify why this finding is accepted",
            }
            for f in report.findings
        ],
    }
    with open(path, "w") as fh:
        json.dump(data, fh, indent=2, sort_keys=False)
        fh.write("\n")
