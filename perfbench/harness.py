"""The benchmark's runner: one cell, one seed, one process.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` sets the cell up, measures it for ``--seconds``, checks
what the timed path produced against the plain reference and prints one
JSON line as the last line of its standard output.

Everything about a cell is data, found by name:

* ``perfbench/workloads/<cell>.json``: its configuration, its driver kind,
  the traffic's parameters, how many items a traced run profiles, and the
  limits of the numbers its check compares;
* ``perfbench/configs/<config>.json``: the configuration as it is run;
* ``perfbench/drivers/<kind>.py``: ``setup(ctx)``, ``item(sut, i)`` and
  ``check(sut, records)``;
* ``perfbench/metrics/<metric>.py``: ``read(obs)``, one reader per metric,
  end-to-end or per layer; a reader that finds nothing returns None;
* ``BENCHMARK.json``: which metrics each cell reports, and their units.

A run with ``--trace 0`` reports the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read from one ``torch.profiler``
session over the window's first ``trace_items`` items.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path

#: modules that may not be loaded in a run's process (whole top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

ROOT = Path(__file__).resolve().parents[1]


@dataclass
class Layout:
    """Where a run finds its files: ``root`` holds ``BENCHMARK.json``;
    each kind of file is looked up in ``dirs`` in order (a directory with
    ``workloads/``, ``configs/``, ``drivers/``, ``metrics/``)."""

    root: Path = ROOT
    dirs: tuple = (ROOT / "perfbench",)

    def find(self, kind: str, name: str, suffix: str) -> Path:
        for d in self.dirs:
            path = Path(d) / kind / f"{name}{suffix}"
            if path.exists():
                return path
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r}")

    def json(self, kind: str, name: str) -> dict:
        return json.loads(self.find(kind, name, ".json").read_text())

    def module(self, kind: str, name: str):
        path = self.find(kind, name, ".py")
        spec = importlib.util.spec_from_file_location(
            f"perfbench_{kind}_{name}".replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        return mod

    def benchmark(self) -> dict:
        return json.loads((Path(self.root) / "BENCHMARK.json").read_text())

    def workloads(self) -> list[str]:
        names = set()
        for d in self.dirs:
            names |= {p.stem for p in (Path(d) / "workloads").glob("*.json")}
        return sorted(names)


@dataclass
class Context:
    """What a driver's ``setup`` gets."""

    workload: dict
    config: dict
    seed: int
    device: object


@dataclass
class Obs:
    """What the metric readers read: the run's records (one per step or
    batch, with ``t_start``, ``t_end`` from the window's start and
    ``tokens``), set-up seconds, the window's peak memory, the trace."""

    workload: dict
    config: dict
    setup_s: float
    records: list
    peak_bytes: int
    trace: object = None


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics ``cell`` reports: its end-to-end metrics (those without
    a ``workloads`` list, and those that list it), or with ``trace`` the
    per-layer metrics whose ``workloads`` list it."""
    if not trace:
        return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


def _device_info(torch, device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips}


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _window(driver, sut, seconds: float, traced: int, prof, sync):
    """Items until ``seconds`` have passed since the first began, each
    whole; with ``prof``, profile the first ``traced``.  Returns (records,
    the traced window's seconds, the items traced)."""
    records, trace_t = [], None
    w0 = time.perf_counter()
    if prof is not None:
        prof.__enter__()
    while True:
        rec = driver.item(sut, len(records))
        rec["t_start"] -= w0
        rec["t_end"] -= w0
        records.append(rec)
        if prof is not None and len(records) == traced:
            sync()
            trace_t = time.perf_counter() - w0
            prof.__exit__(None, None, None)
        if time.perf_counter() - w0 >= seconds:
            break
    sync()
    if prof is not None and trace_t is None:
        trace_t, traced = time.perf_counter() - w0, len(records)
        prof.__exit__(None, None, None)
    return records, trace_t, traced


def run(args, layout: Layout | None = None, *, device: str | None = None,
        t_start: float | None = None) -> dict:
    """One run; returns the result's dict (``None`` values never appear).
    ``device`` None takes the CUDA card and refuses to run without as many
    cards as the cell asks for; a test passes ``"cpu"``."""
    t0 = time.perf_counter() if t_start is None else t_start
    layout = layout or Layout()
    import torch

    wl = layout.json("workloads", args.workload)
    cfg = layout.json("configs", wl["config"])
    chips = int(wl["chips"])
    if device is None:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < chips:
            raise SystemExit(f"perfbench: {args.workload} needs {chips} CUDA card(s); "
                             f"found {found}")
        device = "cuda"
    dev = torch.device(device)
    bench = layout.benchmark()
    wanted = cell_metrics(bench, args.workload, bool(args.trace))
    driver = layout.module("drivers", wl["driver"])

    ctx = Context(workload=wl, config=cfg, seed=int(args.seed), device=dev)
    sut = driver.setup(ctx)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    sync()
    # the window starts from a collected heap; the collector then runs as
    # it does in the program's own process (nothing frozen or disabled)
    gc.collect()
    setup_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else []))
    records, trace_t, traced = _window(driver, sut, args.seconds,
                                       int(wl.get("trace_items", 1)), prof, sync)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    obs = Obs(workload=wl, config=cfg, setup_s=setup_s, records=records, peak_bytes=peak)
    if prof is not None:
        from perfbench.trace import reduce_events
        obs.trace = reduce_events(prof.events(), trace_t, traced)
        del prof
    for rec in records:
        print(json.dumps(rec), file=sys.stderr)

    gc.collect()
    checks = driver.check(sut, records)
    del sut
    gc.collect()

    metrics = {}
    for m in wanted:
        value = layout.module("metrics", m["name"]).read(obs)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    info = _device_info(torch, dev, chips)
    info["memory_peak_bytes"] = int(peak)
    if obs.trace is not None:
        info["busy_s"] = obs.trace.busy_s
        info["window_s"] = obs.trace.window_s
    correct = all(c["value"] <= c["limit"] for c in checks) and bool(checks)
    result = {"correct": correct, "attempted": len(records),
              "failed": sum(1 for r in records if r.get("failed")),
              "metrics": metrics, "device": info}
    if obs.trace is not None:
        result["breakdown"] = {"device_ops": obs.trace.top_ops(10),
                               "idle_gaps": obs.trace.gaps}
    result["checks"] = {c["name"]: {"value": _finite(c["value"]), "limit": c["limit"]}
                        for c in checks}
    return result


def _finite(value: float) -> float:
    """A compared number as JSON can carry it: NaN and infinities (a run
    that produced no number) become the largest double."""
    return value if math.isfinite(value) else sys.float_info.max


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_start: float | None = None) -> None:
    """A run as the benchmark's command makes it: refuse to print a result
    when the process has loaded JAX or the JAX package."""
    result = run(parse(argv), t_start=t_start)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"perfbench: the run loaded {found}")
    emit(result)


def emit(result: dict) -> None:
    """The compared numbers on standard error as its last lines, then the
    result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
