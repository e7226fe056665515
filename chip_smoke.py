#!/usr/bin/env python3
"""Drive the PyTorch port's job-tuning path once on one CUDA card.

    python3 chip_smoke.py

The paper's loop, through the port's own entry points, at Hadoop's default
sizes (``dfs.block.size`` 128 MiB splits of 400-byte wordcount records,
``io.sort.mb`` 100, so each map task spills 262,144-pair buffers):

  0. print the card (``nvidia-smi``) and build the ``seg_combine`` CUDA
     kernel from ``src/repro_torch/kernels/csrc/seg_combine.cu`` with nvcc;
  1. hold the kernel against its plain PyTorch version on the card, at the
     test shapes and at the engine's shape, and time the kernel, the plain
     version and one ``index_add_`` call (CUDA events, median of 50);
  2. run the MapReduce engine (4 maps, 8 reducers, combiner on) as a user
     calls it, so the combiner's sums go to the kernel on the card, and
     hold it against the numpy combiner;
  3. profile three probe runs and fit the Table-3 cost factors;
  4. search a >= 10^5-config grid with the chunked evaluator on the card
     (chunked == unchunked bit for bit; top-10 == the CPU run's), then
     coordinate descent;
  5. answer the four what-if query kinds through the async service (bit
     for bit equal to sequential ``evaluate`` calls);
  6. verify the default and tuned configs on the engine and simulate the
     tuned job on a cluster.

Every phase asserts what it checks; the script exits non-zero, printing no
result, on the first failure, without a CUDA card, or without the package
beside it.  The ``seg_combine`` launch count is zeroed just before the main
path (phases 2-6) and read just after: it must be > 0.  Before the last
line it prints one ``{"kernels": [...]}`` JSON line, which also repeats the
build time and the ``torch.profiler`` device times; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MiB = 1024 * 1024
RECORDS_PER_MAP = int(128 * MiB // 400)       # one 128 MiB split of 400 B records
MAIN_SHAPE = (262_144, 1, 4_128)              # (N, D, P) of one engine spill
TEST_SHAPES = [(1024, 256, 16), (777, 130, 7), (64, 8, 3)]
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM data sheet
FP32_OPS_PER_S = 67e12                        # H100 SXM, outside tensor cores
RTOL, ATOL = 1e-4, 1e-3                       # fp32 atomics reorder sums


def _phase(name, timings):
    class _Timer:
        def __enter__(self):
            print(f"== phase {name}", flush=True)
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            if exc[0] is None:
                timings[name] = round(time.perf_counter() - self.t0, 3)
                print(f"   {name}: {timings[name]} s", flush=True)

    return _Timer()


def _median_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    import numpy as np
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _device_profile(fn, reps: int) -> tuple[float, int, float]:
    """``fn`` run ``reps`` times under ``torch.profiler``: (device ms per
    run summed over its CUDA kernels, CUDA kernels per run, host wall ms
    per run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    dev_us = sum(e.time_range.elapsed_us() for e in kernels)
    return dev_us / 1e3 / reps, round(len(kernels) / reps), wall * 1e3 / reps


def _strip_times(jc) -> dict:
    import dataclasses

    d = dataclasses.asdict(jc)
    for side in ("maps", "reduces"):
        for c in d[side]:
            c.pop("times")
    d.pop("output")
    return d


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    import numpy as np
    import repro_torch

    if ROOT not in Path(repro_torch.__file__).resolve().parents:
        print(f"chip_smoke: repro_torch must come from {ROOT / 'src'}, not "
              f"{repro_torch.__file__}", file=sys.stderr)
        return 2

    from repro_torch.core.hadoop.params import HadoopParams
    from repro_torch.core.hadoop.simulator import SimConfig, simulate_job
    from repro_torch.kernels import seg_combine
    from repro_torch.kernels.seg_combine import build, seg_combine_torch
    from repro_torch.mapreduce import JOBS, MapReduceEngine, make_input
    from repro_torch.mapreduce.profiler import fit_cost_factors, predict, run_measured
    from repro_torch.search import (
        ChunkedEvaluator,
        WhatIfService,
        coordinate_descent_ev,
        evaluate_unchunked,
        search_topk,
        space_block,
        space_size,
    )

    dev = torch.device("cuda")
    timings: dict[str, float] = {}
    kernel = {"name": "seg_combine", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/seg_combine.cu",
              "replaces": "src/repro/kernels/seg_combine.py:37"}

    # ---------------------------------------------------------------- 0
    with _phase("0_card_and_build", timings):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(f"card: {smi}")
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]}")
        t0 = time.perf_counter()
        lib = build()
        build_s = time.perf_counter() - t0
        print(f"built {lib.name} in {build_s:.2f} s")

    # ---------------------------------------------------------------- 1
    with _phase("1_kernel_vs_plain", timings):
        rng = np.random.default_rng(0)
        max_err = 0.0

        def check(vals, ids, p, exact=False):
            nonlocal max_err
            before = seg_combine.launches
            got = seg_combine(vals, ids, p)
            torch.cuda.synchronize()
            assert seg_combine.launches == before + 1, "kernel did not launch"
            want = seg_combine_torch(vals, ids, p)
            assert got.dtype == torch.float32 and got.shape == want.shape
            if exact:
                assert torch.equal(got, want), "counts not exact"
            else:
                torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
            max_err = max(max_err, float((got - want).abs().max()))

        for n, d, p in TEST_SHAPES:
            for dt in (torch.float32, torch.bfloat16):
                vals = torch.from_numpy(
                    rng.standard_normal((n, d)).astype(np.float32)).to(dev, dt)
                for lo, hi in ((0, p), (-1, p), (-1, p + 3)):   # drops < 0, >= P
                    ids = torch.from_numpy(
                        rng.integers(lo, hi, n).astype(np.int32)).to(dev)
                    check(vals, ids, p)
        n, d, p = MAIN_SHAPE
        ids_main = torch.from_numpy(
            np.sort(rng.integers(0, p, n)).astype(np.int32)).to(dev)
        ones = torch.ones((n, d), device=dev)
        check(ones, ids_main, p, exact=True)          # pair counts, exact
        vals_main = torch.from_numpy(
            rng.standard_normal((n, d)).astype(np.float32)).to(dev)
        check(vals_main, ids_main, p)
        check(vals_main.to(torch.bfloat16), ids_main, p)

        kernel_ms = _median_ms(lambda: seg_combine(ones, ids_main, p))
        plain_ms = _median_ms(lambda: seg_combine_torch(ones, ids_main, p))
        library_ms = _median_ms(lambda: torch.zeros(
            (p, d), device=dev).index_add_(0, ids_main, ones))
        k_dev, k_n, _ = _device_profile(lambda: seg_combine(ones, ids_main, p), 20)
        p_dev, p_n, _ = _device_profile(
            lambda: seg_combine_torch(ones, ids_main, p), 20)
        print(f"   device time per call (torch.profiler): kernel {k_dev:.4f} ms "
              f"in {k_n} CUDA kernels, plain {p_dev:.4f} ms in {p_n}")
        n_bytes = n * d * 4 + n * 4 + p * d * 4       # values, ids, sums
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n * d / FP32_OPS_PER_S * 1e3
        kernel.update(
            max_abs_err=max_err, ms=kernel_ms,
            plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            device_ms=k_dev, device_kernels=k_n, plain_device_ms=p_dev,
            plain_device_kernels=p_n, build_s=build_s)
        print(f"   main shape N={n} D={d} P={p}: kernel {kernel_ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms, "
              f"bound {kernel['bound_ms']:.6f} ms ({n_bytes} B)")

    # ------------------------------------------------------ main path: 2-6
    seg_combine.launches = 0
    job = JOBS["wordcount"]
    n_maps = 4
    n_records = n_maps * RECORDS_PER_MAP
    hp = HadoopParams(pNumMappers=n_maps, pNumReducers=8, pUseCombine=True,
                      pSortMB=100.0, pSplitSize=128 * MiB)

    with _phase("2_engine", timings):
        keys, values = make_input(job, n_records, seed=0)
        t0 = time.perf_counter()
        engine = MapReduceEngine(hp, job)          # combines on the card
        assert engine.device.type == "cuda"
        jc_k = engine.run_job(keys, values)
        t_kernel = time.perf_counter() - t0
        launches_engine = seg_combine.launches
        t0 = time.perf_counter()
        jc_np = MapReduceEngine(hp, job, use_kernel_combine=False).run_job(
            keys, values)
        t_numpy = time.perf_counter() - t0
        assert launches_engine > 0, "the engine did not launch seg_combine"
        np.testing.assert_array_equal(jc_k.output[0], jc_np.output[0])
        np.testing.assert_allclose(jc_k.output[1], jc_np.output[1], rtol=1e-5)
        assert _strip_times(jc_k) == _strip_times(jc_np)
        m0 = jc_k.maps[0]
        print(f"   {n_records} records, {n_maps} maps x {m0.numSpills} spills of "
              f"{m0.spillBufferPairs} pairs; {launches_engine} launches "
              f"({launches_engine / n_maps:.2f} per map task); engine "
              f"{t_kernel:.2f} s with the kernel, {t_numpy:.2f} s with numpy")

    with _phase("3_profile_and_fit", timings):
        probes = [hp, hp.replace(pSortMB=50.0),
                  hp.replace(pNumReducers=8, pSortFactor=20)]
        runs = [run_measured(job, h, n_records, seed=1) for h in probes]
        costs = fit_cost_factors(runs)
        stats = runs[0].stats
        for f in ("cHdfsReadCost", "cMapCPUCost", "cSortCPUCost",
                  "cMergeCPUCost", "cReduceCPUCost"):
            v = getattr(costs, f)
            assert np.isfinite(v) and v >= 0.0, (f, v)
            print(f"   {f} = {v:.3e} s/unit")
        print(f"   sMapPairsSel={stats.sMapPairsSel:.3f} "
              f"sCombinePairsSel={stats.sCombinePairsSel:.4f}")

    with _phase("4_search", timings):
        space = {
            "pSortMB": [25.0, 50.0, 75.0, 100.0, 150.0, 200.0, 300.0, 400.0,
                        600.0, 800.0],
            "pSortFactor": [3, 5, 8, 10, 15, 20, 25, 50, 75, 100],
            "pNumReducers": [1, 2, 4, 8, 12, 16, 24, 32, 48, 64],
            "pUseCombine": [0.0, 1.0],
            "pIsIntermCompressed": [0.0, 1.0],
            "pSpillPerc": [0.5, 0.6, 0.7, 0.8, 0.9, 0.95],
            "pSortRecPerc": [0.02, 0.05, 0.1, 0.15, 0.2],
        }
        n_grid = space_size(space)
        assert n_grid >= 100_000
        ev = ChunkedEvaluator(hp, stats, costs, chunk=8192, device=dev)
        ev_cpu = ChunkedEvaluator(hp, stats, costs, chunk=8192, device="cpu")
        cols = space_block(space, 0, n_grid)
        chunked = ev.evaluate(cols)
        whole = evaluate_unchunked(ev.base_cfg, cols)
        for k, v in whole.items():
            assert chunked.outputs[k].tobytes() == v.tobytes(), k
        block = space_block(space, 0, ev.chunk)
        c_dev, c_n, c_wall = _device_profile(lambda: ev.chunk_topk(block, 10), 3)
        print(f"   one chunk_topk of {ev.chunk} rows: {c_wall:.3f} ms wall, "
              f"{c_n} CUDA kernels, {c_dev:.3f} ms of device time "
              f"(device idle {100 * (1 - c_dev / c_wall):.1f} %)")
        search_topk(ev, space, k=10)                   # warm-up
        tops = [search_topk(ev, space, k=10) for _ in range(5)]
        top = tops[0]
        for t in tops[1:]:
            assert [e.index for e in t.entries] == [e.index for e in top.entries]
        rates = sorted(t.configs_per_sec for t in tops)
        top_cpu = search_topk(ev_cpu, space, k=10)
        assert [e.index for e in top.entries] == [e.index for e in top_cpu.entries]
        np.testing.assert_allclose([e.cost for e in top.entries],
                                   [e.cost for e in top_cpu.entries], rtol=1e-12)
        t0 = time.perf_counter()
        tuned = coordinate_descent_ev(ev, space)
        t_cd = time.perf_counter() - t0
        assert tuned.best_cost >= top.best().cost * (1 - 1e-12)
        print(f"   grid {n_grid} configs: top-k median {rates[2]:,.0f} "
              f"configs/s on the card over 5 runs (min {rates[0]:,.0f}, max "
              f"{rates[-1]:,.0f}), {top_cpu.configs_per_sec:,.0f} on the "
              f"host CPU; best {top.best().cost:.3f} s")
        print(f"   coordinate descent: {tuned.best_assignment} "
              f"{tuned.best_cost:.3f} s, {tuned.evaluations} evals in "
              f"{t_cd:.3f} s ({tuned.evaluations / t_cd:,.0f} configs/s)")

    with _phase("5_service", timings):
        best = tuned.best_assignment
        with WhatIfService(ev) as svc:
            futures = [
                svc.probe({**best, "pUseCombine": 0.0}),
                svc.probe({**best, "pNumReducers": 2 * best["pNumReducers"]}),
                svc.sweep("pNumReducers", [1.0, 2.0, 4.0, 8.0, 16.0],
                          base={k: v for k, v in best.items()
                                if k != "pNumReducers"}),
                svc.grid({"pSortMB": space["pSortMB"],
                          "pSortFactor": space["pSortFactor"]}),
            ]
            answers = [f.result(timeout=300) for f in futures]
        for r in answers:
            seq = ev.evaluate(r.overrides)
            assert r.total_cost.tobytes() == seq.total_cost.tobytes()
            for k, v in seq.outputs.items():
                assert r.outputs[k].tobytes() == v.tobytes(), k
            assert np.isfinite(r.best()[1])
        s = svc.summary()
        print(f"   {s['queries']} queries -> {s['chunks']} chunks "
              f"({s['shared_chunks']} shared); median latency of the "
              f"{s['queries']} queries {s['latency_p50_s'] * 1e3:.2f} ms "
              f"(a smoke reading, not a distribution)")

    with _phase("6_verify_and_simulate", timings):
        hp_tuned = tuned.apply(hp)
        before = run_measured(job, hp, n_records, seed=2)
        after = run_measured(job, hp_tuned, n_records, seed=2)
        pred_before = predict(hp, stats, costs)
        pred_after = predict(hp_tuned, stats, costs)
        assert pred_after <= pred_before * (1 + 1e-12)
        print(f"   default: measured {before.wall_s:.3f} s, predicted "
              f"{pred_before:.3f} s; tuned: measured {after.wall_s:.3f} s, "
              f"predicted {pred_after:.3f} s")
        sim_hp = hp_tuned.replace(pNumNodes=8, pNumMappers=64, pNumReducers=16)
        for label, sc in [
            ("clean", SimConfig(seed=7)),
            ("stragglers+speculation",
             SimConfig(seed=7, straggler_prob=0.1, speculative_execution=True)),
            ("node failure", SimConfig(seed=7, node_failures=((0.3, 3),))),
        ]:
            r = simulate_job(sim_hp, stats, costs, sc)
            assert np.isfinite(r.makespan) and r.makespan > 0
            print(f"   simulate {label}: makespan {r.makespan:.3f} s")

    kernel["launches"] = seg_combine.launches
    assert kernel["launches"] > 0, "the main path never launched seg_combine"
    print(json.dumps({"phases_s": timings}))
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
