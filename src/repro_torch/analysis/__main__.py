"""CI gate CLI: ``python -m repro_torch.analysis``.

Exit codes, the reference's: 0 = no findings beyond the baseline, 1 = new
findings (or a broken analyzer in ``--smoke``).  ``--update-baseline``
rewrites the baseline from the current run — every entry then needs a
human-written ``reason``.  Tracing runs on the CUDA card, and raises without
one, unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import (DEFAULT_BASELINE, load_baseline, run_all, save_baseline)


def _default_baseline_path() -> str:
    # repo root = two levels above src/repro_torch (src/repro_torch/analysis/..)
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(os.path.dirname(os.path.dirname(here)))
    cand = os.path.join(root, DEFAULT_BASELINE)
    return cand if os.path.isdir(root) else DEFAULT_BASELINE


def _smoke(device) -> int:
    """Fast self-test: every checker must fire on its known-bad fixture."""
    from .fixtures import selftest

    results = selftest(device)
    bad = 0
    for name, findings in results.items():
        status = "ok" if findings else "DEAD"
        if not findings:
            bad += 1
        print(f"  {name:20s} {status}  "
              f"({len(findings)} finding(s) on its fixture)")
    if bad:
        print(f"analysis --smoke: {bad} checker(s) no longer fire on their "
              "known-bad fixtures", file=sys.stderr)
        return 1
    print("analysis --smoke: all checkers fire on their fixtures")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static analysis gate over the registered cost models")
    ap.add_argument("--json", action="store_true",
                    help="emit the full machine-readable report on stdout")
    ap.add_argument("--baseline", default=None, metavar="PATH",
                    help=f"baseline file (default: {DEFAULT_BASELINE} at "
                         "the repo root)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="accept the current findings into the baseline")
    ap.add_argument("--checker", action="append", default=None,
                    metavar="NAME", help="run only the named checker(s)")
    ap.add_argument("--smoke", action="store_true",
                    help="fixture self-test only (fast; no model tracing)")
    ap.add_argument("--device", default=None, metavar="DEVICE",
                    help="where to trace (default: the CUDA card; 'cpu' "
                         "for the CPU)")
    args = ap.parse_args(argv)

    if args.smoke:
        return _smoke(args.device)

    baseline_path = args.baseline or _default_baseline_path()
    report = run_all(checkers=args.checker, device=args.device)
    baseline = load_baseline(baseline_path)
    new = report.new_findings(baseline)
    stale = report.stale_baseline(baseline)

    if args.update_baseline:
        save_baseline(baseline_path, report)
        print(f"baseline updated: {baseline_path} "
              f"({len(report.findings)} accepted entr(y/ies))")
        return 0

    if args.json:
        payload = report.to_dict()
        payload["new_findings"] = [f.to_dict() for f in new]
        payload["stale_baseline"] = stale
        payload["baseline"] = baseline_path
        json.dump(payload, sys.stdout, indent=2)
        sys.stdout.write("\n")
    else:
        print(f"checkers: {', '.join(report.checkers_run)}")
        for tname, why in report.skipped.items():
            print(f"skipped target {tname}: {why}")
        for tname, prims in report.coverage_gaps.items():
            print(f"coverage gap in {tname}: unmodeled ops "
                  f"{', '.join(prims)}")
        for f in report.findings:
            mark = "baselined" if f.fingerprint() in baseline else "NEW"
            print(f"[{mark}] {f.checker}/{f.kind} in {f.target} "
                  f"at {f.location}\n    {f.message}")
            if f.hint:
                print(f"    hint: {f.hint}")
        for fp in stale:
            print(f"stale baseline entry (finding no longer fires): {fp}")
        print(f"{len(report.findings)} finding(s), {len(new)} new, "
              f"{len(stale)} stale baseline entr(y/ies)")

    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
