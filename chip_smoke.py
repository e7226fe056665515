#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card.

    python3 chip_smoke.py

The job-tuning path, through the port's own entry points, at Hadoop's
default sizes (``dfs.block.size`` 128 MiB splits of 400-byte wordcount
records, ``io.sort.mb`` 100, so each map task spills 262,144-pair buffers),
the LM serving path at the published width and depth of all ten configs
(dense, MoE, SSM, RG-LRU hybrid, vision and enc-dec), LM training at
stablelm-1.6b's, the static analyzer over the port's job model,
wave rollout and kernel launches, and the capacity planner with cloud
provisioning at the reference benchmarks' full settings:

  0. print the card (``nvidia-smi``) and build the five CUDA sources
     (``seg_combine``, ``flash_attention_wgmma`` (bf16) and
     ``flash_attention`` (fp32), ``decode_attention``, ``fixture_copy``) from
     ``src/repro_torch/kernels/csrc/`` with nvcc, one process each, all
     started together, printing each kernel's registers and spills;
  1. hold ``seg_combine`` against its plain PyTorch version on the card, at
     the test shapes (the columns route), at ``MAIN_SHAPE`` with uniform
     sorted ids, at the engine's first spill (ids built as ``_combine``
     builds them) and at the distributed caller's shape (the same split's
     words mod 8,192, unsorted; counts exact); and at the last three time
     the wrapper, its device time and device ops a call (``torch.profiler``),
     the plain version, one ``torch.zeros(...).index_add_`` call (wrapper and
     device), the byte bound, the route taken, and the device time of each
     D == 1 route launched directly;
  2. run the MapReduce engine (4 maps, 8 reducers, combiner on) as a user
     calls it, so the combiner's sums go to the kernel on the card, and
     hold it against the numpy combiner; time the engine's whole combine
     call for its first spill beside the part of it on the card (copies in,
     wrapper, copy out);
  3. profile three probe runs and fit the Table-3 cost factors by least
     squares, then refine them by autograd through the job model on the
     card (``fit_cost_factors_autodiff``, float64): the calibration report,
     steps per second, one calibration step's device time and kernels
     (``torch.profiler``), and both fits' relative error on the fit runs;
     the fitted factors finite and in-domain, the loss no worse than at
     the start;
  4. search a >= 10^5-config grid with the chunked evaluator on the card
     (chunked == unchunked bit for bit; top-10 == the CPU run's), then
     coordinate descent beside gradient descent on the card (best cost,
     evaluator calls and rows, wall time): gradient descent's reported cost
     equals ``evaluate`` of its assignment bit for bit, the same search on
     the CPU gives the same int/bool axes (float axes and cost at rtol
     1e-6), and ``api.tune(strategy="gradient")`` equals the direct call;
  5. answer the four what-if query kinds through the async service (bit
     for bit equal to sequential ``evaluate`` calls);
  6. verify the default and tuned configs on the engine and simulate the
     tuned job on a cluster; fit on phase 3's runs and predict these two
     with both fits (``prediction_error_from_runs``, lstsq and autodiff),
     printing the gap and claiming nothing from it;
  7. hold ``flash_attention`` (both kernels: bf16 on ``wgmma``, fp32 on the
     CUDA cores) and ``decode_attention`` against their plain versions on the
     card, at the test shapes, the bf16 kernel's edges (G = 3, hd 72 and 96,
     ragged Sq and Sk with an offset, ``k_len`` < Sk, a window narrower than
     a kv tile), the decode split's edges (pos 0, inside the first split, at
     tile and split boundaries and +-1, the last slot, a wrapped ring, S off
     the tile size, G 1 to 16), each decode shape with its cache layout
     declared and without, twice, and the serving path's shapes (bf16 at
     2e-2, f32 at 1e-5 with TF32 off); replay one decode call captured in a
     CUDA graph at three positions; and time the kernel, its device time
     back to back, the plain version and ``F.scaled_dot_product_attention``
     (a yardstick only, without softcap, which it cannot express; for decode
     over the live slots, each call on the next of enough cache copies that
     the cache is cold in L2, as a decode step finds it) at the main
     shapes, the serving step's among them;
  8. serve gemma2-9b, all 42 layers at full width with seeded random
     weights, through ``Server``: ``throughput_batch`` (4 prompts of 512
     tokens, 32 new tokens) eager, with its decode step replayed as a CUDA
     graph, graphed again and eager again, the graphed greedy tokens equal
     to the eager ones; ``generate`` (prompts of 4608, 700 and 129 tokens, 8
     new tokens each; the first wraps the local layers' rings); the first
     replayed step's logits against the eager step's, and one step of each
     under ``torch.profiler``; then a 2-layer cut at full width, whose
     prefill and first-decode logits through the kernels are held against
     the plain attention in fp32 at 1e-4 (in bf16 their difference is
     printed beside the plain path's own noise, chunk 128 against chunk
     1024);
  9. run the static analyzer on the card as ``python -m repro_torch.analysis``
     runs it: ``run_all()`` (no finding beyond the empty
     ``analysis_baseline_torch.json``, no coverage gap, only ``tpu-model``
     skipped, with its reason; the two wave-rollout targets walked to their
     loop fixpoint) and ``selftest()`` (all five checkers fire; the
     ``coverage`` launch fixture runs on the card); check every launch
     geometry the wrappers recorded in phases 1-8; hold ``fixture_copy``
     against ``x.clone()`` exactly on its vector path (the timing shape) and
     its scalar path (an odd width), each as ``route`` predicts and the
     launcher reports, and time it (wrapper and device) beside ``copy_``;
     and launch the faulty fixture grid into a NaN-filled output, where
     exactly the elements the checker names must stay NaN;
 10. run the distributed pipeline (``make_pipeline``: map -> ``seg_combine``
     -> ``all_to_all_single`` -> reduce) on an NCCL process group of one
     rank, over the wordcount words of one 128 MiB split (1,342,176 words,
     ``key_space`` 8,192): equal to the plain ``index_add_`` pipeline and to
     the engine's dense sums; every ``seg_combine`` launch on the ``bins``
     route, ``reduce_plan`` sending all but a few passes into shared bins;
     its wall time, device time and kernels, and the collective's time;
 11. drive the capacity planner and cloud provisioning (64 Poisson jobs over
     the 4-class mix, seed 3): the DES<->wave agreement rows (finish times at
     rtol 1e-3 without contention and for the big/small preemption rows, p95
     within 15 % on the contended mixes and the rack incast bursts); a
     planner batch of 2,048 scenarios in two policy groups on the card
     (scenarios/s, host clock, median of 3, beside the DES's over 6; rounds
     against ``n_steps``; one batch under ``torch.profiler`` for kernels a
     round, device time and idle share), every row converged; the same
     knobs under all four schedulers with heterogeneous fleets, 64 of the
     rows equal to the port's CPU rollout at rtol 1e-9; ``api.tune
     ("cluster")`` over the capacity example's grid (top-k, chunk 256), its
     winner re-costed on the DES; ``CloudEvaluator`` at batch 256 (configs/s,
     the Pareto front) and wave dollars against DES dollars at rtol 1e-3;
     and ``ChunkedEvaluator(devices=[cuda:0, cuda:0])`` over phase 4's first
     chunk, equal to one device bit for bit.  Slice 4 launches no kernel:
     the four counts are zeroed before it, must read 0 after, and are put
     back;
 12. serve starcoder2-7b, granite-3-8b and stablelm-1.6b at published width
     and depth (bf16, seeded weights on the card, one model at a time)
     through ``Server.throughput_batch`` (4 prompts of 512 tokens, 16 new
     tokens), eager and with the decode step replayed as a CUDA graph (the
     graphed tokens equal to the eager ones), and internvl2-26b through
     ``LM.prefill`` with 256 patch rows before each of the 4 prompts, then
     16 greedy decode steps, eager and graphed; hold a 2-layer fp32 cut of
     each at full width against the plain attention (prefill and first
     decode logits at 1e-4); train stablelm-1.6b at published width and
     depth (fp32 master weights, bf16 compute, ``TokenPipeline`` batches of
     8 x 2,048 in the 2 microbatches ``pick_microbatches`` gives, 5 AdamW
     steps, every loss finite; step time, tokens/s, peak memory, and one
     step under ``torch.profiler``, its device time split by the step's
     profiler ranges: forward, the recomputation under remat, the flash
     backward); hold a 2-layer fp32 cut's loss and every gradient through
     the kernel forward against the plain attention at rtol 1e-4, and its
     accumulated gradients at 2 microbatches against 1 at the same
     tolerance; and check the launch geometries this phase recorded.
     Phase 7 checks and times both attention kernels at these four
     configs' serving geometries, and flash at the training step's;
 13. serve slice 5b's five configs at published width and depth (bf16,
     seeded weights, one model at a time): deepseek-moe-16b,
     moonshot-v1-16b-a3b (MoE, ``moe_impl`` "einsum"), mamba2-130m (SSD) and
     recurrentgemma-9b (RG-LRU + local attention on a ring) through
     ``Server.throughput_batch`` (4 x 512 + 16, caches of 1,024), and
     seamless-m4t-large-v2 through ``EncDec.prefill`` (4 x 1,024 seeded
     source frames and a 256-token target prompt) and 16 ``GreedyDecoder``
     steps, each eager and with the decode step replayed as a CUDA graph
     (tokens equal); peak memory below the card's 80 GB; hold each config's
     fp32 cut at full width (2 layers; recurrentgemma-9b 5, its prefix and
     one group; seamless 2 + 2) against the plain attention at 1e-4, and
     mamba2-130m's, which has no attention, against the same weights on the
     CPU; and check the launch geometries the phase launched.  Phase 7
     checks and times both kernels at these configs' new geometries (G 16
     at hd 256 on a ring of window 2,048, wrapped; non-causal flash with Sq
     != Sk; the cross decode at pos = the cache size).

Every phase asserts what it checks; the script exits non-zero, printing no
result, on the first failure, without a CUDA card, or without the package
beside it.  Each path's launch counts are zeroed just before it and read just
after: ``seg_combine`` over phases 2-6 (> 0), over the 42-layer run of
phase 8 (the graphed ``throughput_batch`` and ``generate``)
``flash_attention`` exactly 42 x 4 prefills, all on the bf16 ``wgmma``
kernel, and ``gqa_decode_attention`` exactly 42 x (31 + 21) decode steps (a
graph replay adds the launches its capture recorded), and
``fixture_copy`` over the analyzer's run of phase 9 (> 0),
``seg_combine`` again over phase 10's pipeline (> 0, all on ``bins``),
added to its count, and over each path of phase 12 (the graphed serving
run of each config, then the 5 training steps) ``flash_attention`` exactly
layers x 1 prefill, all on ``bf16_wgmma`` (training: 5 steps x 2
microbatches x 24 layers x 2, the forward and its recomputation under
remat, and no backward launch) and ``gqa_decode_attention`` exactly layers
x decode steps, each added to its kernel's count (``launches_by_path``),
and over each config of phase 13 ``flash_attention`` exactly its attention
layers x 1 prefill (28, 48, 0, 12; seamless 72: 24 encoder, 24 self, 24
cross) and ``gqa_decode_attention`` exactly those x decode steps (seamless
48 a step).  Before the
last line it prints one ``{"kernels": [...]}`` JSON line; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import itertools
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
DIST_PARTS = 8_192                            # the distributed caller's P
TEST_SHAPES = [(1024, 256, 16), (777, 130, 7), (64, 8, 3)]
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM data sheet
L2_COLD_BYTES = 60e6                          # more than the H100's 50 MB L2
FP32_OPS_PER_S = 67e12                        # H100 SXM, outside tensor cores
BF16_OPS_PER_S = 989e12                       # H100 SXM, dense tensor cores
RTOL, ATOL = 1e-4, 1e-3                       # fp32 atomics reorder sums
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # the reference's kernel tolerances
# flash's bf16 device time at FLASH_MAIN before the wgmma kernel: the CUDA-core
# kernel (csrc/flash_attention.cu's former bf16 instance), as this script
# measured it on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md keeps the run
# (B, H, KV, Sq, Sk, hd, causal, window, softcap, q_offset[, k_len])
FLASH_TEST = [(1, 4, 2, 256, 256, 64, True, None, None, 0),
              (2, 2, 2, 128, 384, 128, True, None, None, 0),
              (1, 8, 1, 256, 256, 80, True, None, None, 0),
              (1, 4, 4, 256, 256, 64, True, 64, None, 0),
              (1, 4, 4, 256, 256, 64, True, 1024, None, 0),
              (1, 4, 2, 128, 384, 128, True, None, 50.0, 256),
              (2, 4, 4, 128, 128, 64, False, None, None, 0),
              (1, 2, 2, 200, 333, 64, False, None, None, 0),
              # the wgmma kernel's edges: G = 3 (one head per tile), hd 72 and
              # 96 (padded to 128), Sq and Sk off the tile sizes with an
              # offset, k_len below Sk, a window narrower than a kv tile; G 16
              # (4 queries x 16 heads a tile) and G 6 at hd 256
              (1, 6, 2, 200, 333, 72, True, 40, 50.0, 100, 250),
              (1, 6, 2, 130, 200, 96, False, None, None, 0, 150),
              (2, 4, 2, 77, 141, 128, True, 16, None, 64, 120),
              (1, 16, 1, 100, 100, 64, True, None, None, 0),
              (1, 6, 1, 70, 70, 256, True, None, 50.0, 0)]
FLASH_MAIN = (4, 16, 8, 512, 512, 256, True, None, 50.0, 0)      # global layer
FLASH_MAIN_LOCAL = (4, 16, 8, 512, 512, 256, True, 4096, 50.0, 0)
FLASH_LONG = (1, 16, 8, 4608, 4608, 256, True, 4096, 50.0, 0)
# (B, H, KV, S, hd, pos, window, softcap, ring)
DECODE_TEST = [(2, 8, 2, 512, 64, 256, None, None, False),
               (1, 4, 4, 300, 128, 150, None, None, False),
               (1, 4, 1, 256, 64, 1000, 200, 30.0, True),
               # the split's edges at gemma2-9b's shape (32 tiles of 32 slots
               # among 12 CTAs a kv head): pos 0, inside the first split, a
               # tile boundary, a split boundary (12 tiles = 384 slots) and
               # +-1, the last slot
               (4, 16, 8, 1024, 256, 0, None, 50.0, False),
               (4, 16, 8, 1024, 256, 17, None, 50.0, False),
               (4, 16, 8, 1024, 256, 31, None, 50.0, False),
               (4, 16, 8, 1024, 256, 382, None, 50.0, False),
               (4, 16, 8, 1024, 256, 383, None, 50.0, False),
               (4, 16, 8, 1024, 256, 384, None, 50.0, False),
               # a wrapped ring with a window narrower than S; S off the tile
               # size; G 1, 3, 8 (hd 128) and 16
               (1, 32, 2, 256, 64, 300, 100, None, True),
               (1, 8, 1, 100, 256, 250, 64, None, True),
               (2, 4, 4, 777, 128, 776, None, 50.0, False),
               (1, 6, 2, 200, 72, 150, None, None, False),
               (2, 16, 2, 777, 128, 776, None, 50.0, False),
               (1, 32, 2, 300, 64, 299, None, 30.0, False)]
DECODE_MAIN = (4, 16, 8, 1024, 256, 1023, None, 50.0, False)
DECODE_STEP = (4, 16, 8, 1024, 256, 527, None, 50.0, False)   # the serving step
DECODE_RING = (1, 16, 8, 4096, 256, 4610, 4096, 50.0, True)
# phase 12's serving geometries, (flash, decode) per config: prefill of 4
# prompts of 512 tokens (internvl2-26b: 256 patch rows, then 512 tokens) and
# decode at the serving step with caches of 1,024 (pos 527; internvl2-26b's
# last step, 783: its steps read 25 tiles of 32 slots, not 17); no softcap,
# no window
SERVE_GEOMETRIES = {
    "starcoder2-7b": ((4, 36, 4, 512, 512, 128, True, None, None, 0),
                      (4, 36, 4, 1024, 128, 527, None, None, False)),
    "granite-3-8b": ((4, 32, 8, 512, 512, 128, True, None, None, 0),
                     (4, 32, 8, 1024, 128, 527, None, None, False)),
    "stablelm-1.6b": ((4, 32, 32, 512, 512, 64, True, None, None, 0),
                      (4, 32, 32, 1024, 64, 527, None, None, False)),
    "internvl2-26b": ((4, 48, 8, 768, 768, 128, True, None, None, 0),
                      (4, 48, 8, 1024, 128, 783, None, None, False)),
}
# phase 13's geometries (slice 5b), (flash shapes, decode shapes) per config
# whose attention is new to the card: deepseek-moe-16b's (moonshot-v1-16b-a3b
# has the same; mamba2-130m has no attention) at G 1, hd 128; recurrentgemma-9b's
# local layers at G 16, hd 256, window 2,048 on a ring (the serving prefill and
# step at pos 527 in a ring of 1,024, and a prompt of 2,100 that wraps a ring
# of 2,048, decoded at pos 2,100); seamless-m4t-large-v2's encoder and
# cross-attention (non-causal, Sq != Sk), its decoder's self-attention
# prefill and last step (pos 271), and its cross decode over the static cache
# of 1,024 source frames at pos = 1,024
FAMILY_GEOMETRIES = {
    "deepseek-moe-16b": ([(4, 16, 16, 512, 512, 128, True, None, None, 0)],
                         [(4, 16, 16, 1024, 128, 527, None, None, False)]),
    "recurrentgemma-9b": ([(4, 16, 1, 512, 512, 256, True, 2048, None, 0),
                           (1, 16, 1, 2100, 2100, 256, True, 2048, None, 0)],
                          [(4, 16, 1, 1024, 256, 527, 2048, None, True),
                           (1, 16, 1, 2048, 256, 2100, 2048, None, True)]),
    "seamless-m4t-large-v2": ([(4, 16, 16, 1024, 1024, 64, False, None, None, 0),
                               (4, 16, 16, 256, 1024, 64, False, None, None, 0),
                               (4, 16, 16, 256, 256, 64, True, None, None, 0)],
                              [(4, 16, 16, 1024, 64, 1024, None, None, False),
                               (4, 16, 16, 1024, 64, 271, None, None, False)]),
}
FAMILY_FLASH = [f for fs, _ in FAMILY_GEOMETRIES.values() for f in fs]
FAMILY_DECODE = [d for _, ds in FAMILY_GEOMETRIES.values() for d in ds]
# phase 13: the decoder-only configs through Server.throughput_batch, and the
# enc-dec through its prefill (4 x 1,024 source frames, a 256-token target
# prompt: the reference's enc-dec prefill, repro/configs/shapes.py) and
# GreedyDecoder; each config's fp32 cut (layers; enc-dec: encoder + decoder)
FAMILIES = ("deepseek-moe-16b", "moonshot-v1-16b-a3b", "mamba2-130m",
            "recurrentgemma-9b", "seamless-m4t-large-v2")
FAMILY_CUT_LAYERS = {"recurrentgemma-9b": 5}     # 2 prefix layers + one group
ENCDEC_SRC, ENCDEC_PROMPT = 1024, 256
CARD_BYTES = 80e9
# the flash kernel as stablelm-1.6b's training step runs it (bf16, one
# microbatch of 4 x 2,048): forward and recomputation under remat
FLASH_TRAIN = (4, 32, 32, 2048, 2048, 64, True, None, None, 0)
SERVE_PROMPT, SERVE_NEW, SERVE_CACHE = 512, 16, 1024
VISION_ROWS = 256                 # one 448-px tile's patch embeddings
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 5


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


def _host_median_ms(fn, reps: int = 20) -> float:
    """Median host wall ms of ``fn``, which ends in a copy to the host (so
    the device's work is inside), after one warm-up call."""
    import numpy as np

    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _back_to_back_ms(fn, reps: int = 20) -> float:
    """The device's ms per call: ``reps`` calls queued behind a ~25 ms sleep
    kernel, so that they run back to back between two CUDA events whatever
    the host's rate of issuing them."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _device_profile(fn, reps: int) -> tuple[float, int, float]:
    """``fn`` run ``reps`` times under ``torch.profiler``: (device ms per
    run summed over its CUDA kernels, CUDA kernels per run, host wall ms
    per run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a session that delivers no device event at all lost its trace (it
    # happens in this long process, not in a fresh one): trace again
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
        if kernels:
            break
        print("   (torch.profiler delivered no device event; tracing again)")
    dev_us = sum(e.time_range.elapsed_us() for e in kernels)
    return dev_us / 1e3 / reps, round(len(kernels) / reps), wall * 1e3 / reps


def _step_profile(fn) -> tuple[float, float, int, list, dict]:
    """One run of ``fn`` (after a warm-up) under ``torch.profiler``: (host
    wall ms, device ms summed over its CUDA kernels, CUDA kernels, the five
    kernel names with the most device time as (name, ms, count), and
    ``{name: [ms, count]}`` of every kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            acc = by_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us() / 1e3
            acc[1] += 1
    top = sorted(((n[:60], ms, c) for n, (ms, c) in by_name.items()),
                 key=lambda t: -t[1])[:5]
    dev = sum(ms for ms, _ in by_name.values())
    return wall * 1e3, dev, sum(c for _, c in by_name.values()), top, by_name


def _ptxas_summary(log: str) -> list[tuple[int, int, int]]:
    """(template argument, registers, spill-store bytes) of each kernel
    instantiation in an ``nvcc -Xptxas=-v`` log, in the log's order."""
    import re

    out, inst, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*kernelILi(\d+)E", line)
        if m:
            inst = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and inst is not None:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and inst is not None:
            out.append((inst, int(m.group(1)), spill))
            inst, spill = None, 0
    return out


def _decode_ptxas(log: str) -> list[tuple[str, int, int]]:
    """(instance, registers, spill-store bytes) of each instance of the
    decode kernel in an ``nvcc -Xptxas=-v`` log: ``bf16 tensor cores`` or
    ``fp32 NCH n HPW h`` (16-byte chunks a lane owns, heads a warp takes)."""
    import re

    out, inst, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*decode_attention_kernel\S*", line)
        if m:
            simt = re.search(r"SimtHeadsIfLi(\d+)ELi(\d+)E", line)
            inst = ("fp32 NCH {} HPW {}".format(*simt.groups()) if simt
                    else "bf16 tensor cores")
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and inst is not None:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and inst is not None:
            out.append((inst, int(m.group(1)), spill))
            inst, spill = None, 0
    return out


def _strip_times(jc) -> dict:
    import dataclasses

    d = dataclasses.asdict(jc)
    for side in ("maps", "reduces"):
        for c in d[side]:
            c.pop("times")
    d.pop("output")
    return d


def _flash_bound(shape, dtype_bytes: int, ops_per_s: float) -> tuple[float, str, int, float]:
    """(bound ms, what bounds it, bytes, FLOP) of one flash call: q, k, v
    read once and out written once; 4 * hd FLOP per visible (query, key)
    pair, counted for this call's masks."""
    import numpy as np

    B, H, KV, Sq, Sk, hd, causal, window, _, q_offset = shape[:10]
    k_len = shape[10] if len(shape) > 10 and shape[10] is not None else Sk
    qpos = q_offset + np.arange(Sq)
    hi = np.minimum(k_len, qpos + 1) if causal else np.full(Sq, k_len)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(Sq, int)
    pairs = int(np.maximum(0, hi - lo).sum()) * B * H
    n_bytes = (2 * B * H * Sq * hd + 2 * B * KV * Sk * hd) * dtype_bytes
    flop = 4.0 * hd * pairs
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flop / ops_per_s * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations",
            n_bytes, flop)


def _decode_bound(shape, slot_pos, dtype_bytes: int,
                  ops_per_s: float) -> tuple[float, str, int, float]:
    """(bound ms, what bounds it, bytes, FLOP) of one decode call: q read
    once, the K and V rows of the visible slots read once, out written
    once; 4 * hd FLOP per (head, visible slot)."""
    B, H, KV, S, hd, pos, window, _, _ = shape
    ok = (slot_pos >= 0) & (slot_pos <= pos)
    if window:
        ok &= slot_pos > pos - window
    valid = int(ok.sum())
    n_bytes = (2 * B * H * hd + 2 * B * KV * valid * hd) * dtype_bytes
    flop = 4.0 * hd * B * H * valid
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flop / ops_per_s * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations",
            n_bytes, flop)


def _engine_first_spill(job, hp, keys, values) -> dict:
    """The first spill of one map task as ``MapReduceEngine._combine`` gets
    it: the map output's first ``MAIN_SHAPE[0]`` pairs, hash-partitioned and
    lexsorted by (partition, key); ``ids`` is ``np.unique``'s inverse over
    the (partition, key) pairs, ``num_parts`` the distinct pairs."""
    import numpy as np

    from repro_torch.mapreduce.engine import _hash_partition

    okeys, ovals = job.map_fn(keys, values)
    n = MAIN_SHAPE[0]
    part = _hash_partition(okeys, hp.pNumReducers)[:n]
    k, v = okeys[:n], ovals[:n]
    order = np.lexsort((k, part))
    part, k, v = part[order], k[order], v[order]
    uniq, inverse = np.unique(np.stack([part, k], 1), axis=0, return_inverse=True)
    return {"part": part, "keys": k, "vals": np.asarray(v, np.float32),
            "ids": inverse.reshape(-1).astype(np.int32),
            "num_parts": int(uniq.shape[0])}


def _time_seg_combine(label, v, ids, p, torch) -> dict:
    """``seg_combine`` at one phase-1 shape beside its plain version and one
    ``index_add_``: wrapper times (CUDA events around one call, median of
    50), device time and device ops a call (``torch.profiler``), the device
    time back to back, and the device time of each D == 1 route launched
    directly (each held to the plain version); with, from ``reduce_plan``
    (the kernel's reduction repeated on the CPU), its passes, those that
    added into shared-memory bins, and its global atomics.  Returns the JSON
    record."""
    from repro_torch.kernels import seg_combine
    from repro_torch.kernels.seg_combine import (geometry, reduce_plan, route,
                                                 seg_combine_cuda,
                                                 seg_combine_torch)

    n, d = v.shape
    dev = v.device
    kind = route(n, d, p)
    plan = reduce_plan(v.cpu(), ids.cpu(), p)

    def library():
        return torch.zeros((p, d), device=dev).index_add_(0, ids, v)

    k_ms = _median_ms(lambda: seg_combine(v, ids, p))
    k_dev, k_ops, _ = _device_profile(lambda: seg_combine(v, ids, p), 20)
    k_b2b = _back_to_back_ms(lambda: seg_combine(v, ids, p))
    p_ms = _median_ms(lambda: seg_combine_torch(v, ids, p))
    l_ms = _median_ms(library)
    l_dev, l_ops, _ = _device_profile(library, 20)
    want = seg_combine_torch(v, ids, p)
    routes = {}
    for r in ("bins", "global"):
        def call(geo=geometry(n, d, p, r)):
            return seg_combine_cuda(v, ids, p, geo)

        torch.testing.assert_close(call(), want, rtol=RTOL, atol=ATOL)
        routes[r] = _device_profile(call, 20)[0]
    n_bytes = n * d * v.element_size() + n * 4 + p * d * 4   # values, ids, sums
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n * d / FP32_OPS_PER_S * 1e3
    bound = max(bytes_ms, ops_ms)
    print(f"   {label} N={n} D={d} P={p}, route {kind} ({plan.bins_passes} of "
          f"{plan.passes} passes into shared-memory bins, {plan.atomics} global "
          f"atomics, by reduce_plan): wrapper {k_ms:.4f} ms, "
          f"device {k_dev:.4f} ms in {k_ops} device ops (profiler; "
          f"{k_b2b:.4f} ms a call back to back); index_add_ wrapper "
          f"{l_ms:.4f} ms, device {l_dev:.4f} ms in {l_ops} device ops "
          f"(wrapper / index_add_ {k_ms / l_ms:.2f}); plain {p_ms:.4f} ms; "
          f"bound {bound:.6f} ms ({n_bytes} B); device time by route "
          f"{ {r: round(t, 4) for r, t in routes.items()} }")
    return dict(route_taken=kind, passes=plan.passes, bins_passes=plan.bins_passes,
                atomics=plan.atomics, ms=k_ms, device_ms=k_dev, device_ops=k_ops,
                back_to_back_ms=k_b2b, plain_ms=p_ms, library_ms=l_ms,
                library="torch.zeros + Tensor.index_add_",
                library_device_ms=l_dev, library_device_ops=l_ops,
                bound_ms=bound, bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                routes_device_ms=routes)


def _phase7_attention(timings, builds, torch, np):
    """Phase 7: both attention kernels against their plain versions, and
    their times at the serving path's shapes.  Returns their JSON records
    (without ``launches``, which phase 8 fills in)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, gqa_decode_attention
    from repro_torch.kernels.decode_attention import decode_attention_torch
    from repro_torch.kernels.flash_attention import VARIANTS, flash_attention_torch

    dev = torch.device("cuda")
    flash = {"name": "flash_attention", "route": "cuda", "variant": "bf16_wgmma",
             "source": "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
             "replaces": "src/repro/kernels/flash_attention.py:44",
             "build_s": builds["flash_attention_wgmma"]["seconds"]}
    decode = {"name": "decode_attention", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
              "replaces": "src/repro/kernels/decode_attention.py:39",
              "build_s": builds["decode_attention"]["seconds"]}
    with _phase("7_attention_kernels_vs_plain", timings):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print("   TF32 off (torch.backends.cuda.matmul.allow_tf32 = False); "
              "tolerance f32 1e-5, bf16 2e-2")
        gen = torch.Generator(device=dev).manual_seed(7)

        def randn(shape, dtype):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        def flash_inputs(shape, dtype):
            B, H, KV, Sq, Sk, hd = shape[:6]
            return (randn((B, H, Sq, hd), dtype), randn((B, KV, Sk, hd), dtype),
                    randn((B, KV, Sk, hd), dtype))

        def flash_kw(shape):
            return dict(causal=shape[6], window=shape[7], logit_cap=shape[8],
                        q_offset=shape[9],
                        k_len=shape[10] if len(shape) > 10 else None)

        def decode_inputs(shape, dtype):
            B, H, KV, S, hd, pos, _, _, ring = shape
            p = torch.tensor(pos, dtype=torch.int32, device=dev)
            i = torch.arange(S, dtype=torch.int32, device=dev)
            slot_pos = p - torch.remainder(p - i, S) if ring else i
            return (randn((B, H, 1, hd), dtype), randn((B, KV, S, hd), dtype),
                    randn((B, KV, S, hd), dtype), slot_pos, p)

        def decode_kw(shape):
            return dict(window=shape[6], logit_cap=shape[7])

        def decode_layout(shape):
            return "ring" if shape[8] else "full"

        errs = {"flash": 0.0, "decode": 0.0}
        n_decode_checks = 0

        def held(kind, got, want, dtype, launched):
            assert launched, f"{kind} did not launch its kernel"
            tol = ATTN_TOL[str(dtype).removeprefix("torch.")]
            assert got.dtype == want.dtype and got.shape == want.shape
            torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
            errs[kind] = max(errs[kind], float((got.float() - want.float()).abs().max()))

        for dtype in (torch.float32, torch.bfloat16):
            variant = VARIANTS[dtype]
            for shape in FLASH_TEST + [FLASH_MAIN, FLASH_MAIN_LOCAL, FLASH_LONG] \
                    + [f for f, _ in SERVE_GEOMETRIES.values()] + [FLASH_TRAIN] \
                    + FAMILY_FLASH:
                q, k, v = flash_inputs(shape, dtype)
                before = flash_attention.launches
                on_variant = flash_attention.launches_by_variant[variant]
                got = flash_attention(q, k, v, **flash_kw(shape))
                torch.cuda.synchronize()
                held("flash", got, flash_attention_torch(q, k, v, **flash_kw(shape)),
                     dtype, flash_attention.launches == before + 1
                     and flash_attention.launches_by_variant[variant] == on_variant + 1)
            for shape in DECODE_TEST + [DECODE_MAIN, DECODE_STEP, DECODE_RING] \
                    + [d for _, d in SERVE_GEOMETRIES.values()] + FAMILY_DECODE:
                q, kc, vc, sp, p = decode_inputs(shape, dtype)
                B, H, KV, _, hd = shape[:5]
                want = decode_attention_torch(q.view(B, KV, H // KV, hd), kc, vc, sp,
                                              p, **decode_kw(shape)).view(B, H, 1, hd)
                # the declared layout (the span at pos) and none (all S
                # slots), each twice: the merge counters are back at 0
                for layout in (decode_layout(shape), None, decode_layout(shape), None):
                    before = gqa_decode_attention.launches
                    got = gqa_decode_attention(q, kc, vc, sp, p, layout=layout,
                                               **decode_kw(shape))
                    torch.cuda.synchronize()
                    held("decode", got, want, dtype,
                         gqa_decode_attention.launches == before + 1)
                    n_decode_checks += 1
        # TMA loads need 16-byte-aligned addresses: the wrapper refuses a
        # bf16 CUDA tensor that starts 2 bytes past one, and launches nothing
        q, k, v = flash_inputs(FLASH_TEST[0], torch.bfloat16)
        q = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)[1:].view(q.shape)
        before = flash_attention.launches
        try:
            flash_attention(q, k, v, **flash_kw(FLASH_TEST[0]))
        except ValueError as err:
            assert "16-byte" in str(err), err
        else:
            raise AssertionError("flash_attention took a misaligned bf16 CUDA tensor")
        assert flash_attention.launches == before
        # the decode kernel's 16-byte loads need aligned addresses too
        q, kc, vc, sp, p = decode_inputs(DECODE_TEST[0], torch.bfloat16)
        q = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)[1:].view(q.shape)
        before = gqa_decode_attention.launches
        try:
            gqa_decode_attention(q, kc, vc, sp, p, layout="full")
        except ValueError as err:
            assert "16-byte" in str(err), err
        else:
            raise AssertionError("gqa_decode_attention took a misaligned CUDA tensor")
        assert gqa_decode_attention.launches == before
        n_flash = len(FLASH_TEST) + 4 + len(SERVE_GEOMETRIES) + len(FAMILY_FLASH)
        print(f"   max |kernel - plain|: flash {errs['flash']:.3e}, "
              f"decode {errs['decode']:.3e} over {2 * n_flash} and "
              f"{n_decode_checks} checks")

        # one decode call captured in a CUDA graph and replayed at three
        # advancing positions, written in place: the kernel reads pos on the
        # device and its merge counters are back at 0 after every replay
        q, kc, vc, sp, p = decode_inputs(DECODE_MAIN, torch.bfloat16)
        B, H, KV, _, hd = DECODE_MAIN[:5]
        kw = dict(decode_kw(DECODE_MAIN), layout="full")
        gqa_decode_attention(q, kc, vc, sp, p, **kw)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            g_out = gqa_decode_attention(q, kc, vc, sp, p, **kw)
        replayed = []
        for pos in (100, 527, 1023):
            p.fill_(pos)
            graph.replay()
            torch.cuda.synchronize()
            want = decode_attention_torch(q.view(B, KV, H // KV, hd), kc, vc, sp, p,
                                          **decode_kw(DECODE_MAIN)).view(B, H, 1, hd)
            torch.testing.assert_close(g_out.float(), want.float(), rtol=2e-2,
                                       atol=2e-2)
            replayed.append(float((g_out.float() - want.float()).abs().max()))
        del graph
        print(f"   decode captured once in a CUDA graph, replayed at pos 100, 527, "
              f"1023: max |replay - plain| {replayed} (bf16 2e-2)")

        def time_flash(shape, label, record=None):
            q, k, v = flash_inputs(shape, torch.bfloat16)
            kw = flash_kw(shape)
            k_ms = _median_ms(lambda: flash_attention(q, k, v, **kw))
            p_ms = _median_ms(lambda: flash_attention_torch(q, k, v, **kw))
            sdpa = lambda: F.scaled_dot_product_attention(    # noqa: E731
                q, k, v, is_causal=kw["causal"], enable_gqa=True)
            l_ms = _median_ms(sdpa)
            # torch.profiler recorded only one of several back-to-back flash
            # launches here, so the kernel's device time is taken from CUDA
            # events over launches queued back to back (phase 8's profile of
            # a prefill counts each one)
            k_dev = _back_to_back_ms(lambda: flash_attention(q, k, v, **kw))
            p_dev, p_n, _ = _device_profile(
                lambda: flash_attention_torch(q, k, v, **kw), 5)
            bound, by, n_bytes, flop = _flash_bound(shape, 2, BF16_OPS_PER_S)
            tflops = flop / (k_dev * 1e-3) / 1e12
            missing = [what for what, on in (("softcap", shape[8]),
                                             ("window", shape[7] and shape[7] < shape[4]))
                       if on]
            sdpa_what = (f"SDPA without {' or '.join(missing)}" if missing
                         else "SDPA (the same function)")
            print(f"   flash {label} {shape[:6]} bf16: kernel {k_ms:.4f} ms "
                  f"(device {k_dev:.4f} ms, back to back, {tflops:.1f} TFLOP/s, "
                  f"{100 * bound / k_dev:.0f} % of the bound), "
                  f"plain {p_ms:.4f} ms (device {p_dev:.4f} ms in {p_n} kernels), "
                  f"{sdpa_what} {l_ms:.4f} ms (kernel / SDPA "
                  f"{k_ms / l_ms:.2f}); bound {bound:.4f} ms ({by}: {n_bytes} B, "
                  f"{flop:.4g} FLOP)")
            times = dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms,
                         plain_device_ms=p_dev, library_ms=l_ms, bound_ms=bound,
                         bound_by=by, tflop_per_s=tflops)
            if record is not None:
                record.update(times, library="F.scaled_dot_product_attention, "
                                             "without softcap")
            return times

        def time_decode(shape, label) -> dict:
            """Times with the cache cold in L2, as a decode step finds it (the
            step reads 42 layers' caches in turn): each call reads the next of
            enough copies of the caches that the calls before it moved more
            than the 50 MB L2.  The kernel's device time warm (one copy, as
            earlier PRs timed it) is kept beside it."""
            q, kc, vc, sp, p = decode_inputs(shape, torch.bfloat16)
            B, H, KV, S, hd, pos = shape[:6]
            kw = decode_kw(shape)
            qg = q.view(B, KV, H // KV, hd)
            bound, by, n_bytes, flop = _decode_bound(
                shape, sp.cpu().numpy(), 2, BF16_OPS_PER_S)
            n_copies = 2 + int(L2_COLD_BYTES // n_bytes)
            caches = itertools.cycle(
                [(kc, vc)] + [(kc.clone(), vc.clone()) for _ in range(n_copies - 1)])
            # SDPA over the live slots of a full cache (all of a ring's)
            live = S if shape[8] else min(S, pos + 1)

            def call():
                k, v = next(caches)
                return gqa_decode_attention(q, k, v, sp, p, layout=decode_layout(shape),
                                            **kw)

            def plain():
                k, v = next(caches)
                return decode_attention_torch(qg, k, v, sp, p, **kw)

            def sdpa():
                k, v = next(caches)
                return F.scaled_dot_product_attention(
                    q, k[:, :, :live], v[:, :, :live], enable_gqa=True)

            k_ms = _median_ms(call)
            k_dev = _back_to_back_ms(call)
            warm_dev = _back_to_back_ms(lambda: gqa_decode_attention(
                q, kc, vc, sp, p, layout=decode_layout(shape), **kw))
            prof_dev, k_n, _ = _device_profile(call, 20)
            assert k_n == 1, f"decode ran {k_n} device kernels a call, not 1"
            p_ms = _median_ms(plain)
            p_dev, p_n, _ = _device_profile(plain, 20)
            l_ms = _median_ms(sdpa)
            print(f"   decode {label} {shape[:6]} bf16, L2 cold ({n_copies} cache "
                  f"copies in turn): kernel {k_ms:.4f} ms (device {k_dev:.4f} ms "
                  f"back to back, {100 * bound / k_dev:.0f} % of the bound; profiler "
                  f"{prof_dev:.4f} ms in {k_n} kernel; warm in L2 {warm_dev:.4f} ms "
                  f"back to back), plain {p_ms:.4f} ms (device {p_dev:.4f} ms in "
                  f"{p_n} kernels), SDPA over {live} slots without softcap "
                  f"{l_ms:.4f} ms (kernel / SDPA {k_ms / l_ms:.2f}); bound "
                  f"{bound:.4f} ms ({by}: {n_bytes} B, {flop:.4g} FLOP)")
            return dict(ms=k_ms, device_ms=k_dev, profiled_device_ms=prof_dev,
                        warm_device_ms=warm_dev, device_kernels=k_n, plain_ms=p_ms,
                        plain_device_ms=p_dev, library_ms=l_ms, bound_ms=bound,
                        bound_by=by)

        time_flash(FLASH_MAIN, "main prefill (global layer)", flash)
        time_flash(FLASH_MAIN_LOCAL, "main prefill (local layer)")
        time_flash(FLASH_LONG, "long prefill (local layer)")
        q, k, v = flash_inputs(FLASH_MAIN, torch.float32)
        f32_dev = _back_to_back_ms(lambda: flash_attention(q, k, v, **flash_kw(FLASH_MAIN)))
        print(f"   flash main prefill fp32 (CUDA-core kernel): device {f32_dev:.4f} ms, "
              "back to back")
        decode.update(time_decode(DECODE_MAIN, "main, full cache"),
                      library="F.scaled_dot_product_attention(enable_gqa=True), "
                              "without softcap")
        for key, shape, label in (("step", DECODE_STEP, "serving step, full cache"),
                                  ("ring", DECODE_RING, "ring cache")):
            decode.update({f"{key}_{k}": v for k, v in time_decode(shape, label).items()
                           if k in ("ms", "device_ms", "warm_device_ms", "plain_ms",
                                    "library_ms", "bound_ms")})
        # the other dense configs' serving geometries (no softcap: SDPA
        # computes the same function)
        keep = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
        flash["serving_geometries"], decode["serving_geometries"] = {}, {}
        for name, (fshape, dshape) in SERVE_GEOMETRIES.items():
            flash["serving_geometries"][name] = time_flash(fshape, f"{name} prefill")
            decode["serving_geometries"][name] = {
                k: v for k, v in time_decode(dshape, f"{name} serving step").items()
                if k in keep}
        flash["training_geometry"] = time_flash(FLASH_TRAIN, "stablelm-1.6b training")
        # slice 5b's geometries (phase 13's paths)
        flash["family_geometries"], decode["family_geometries"] = {}, {}
        for name, (fshapes, dshapes) in FAMILY_GEOMETRIES.items():
            for i, fshape in enumerate(fshapes):
                flash["family_geometries"][f"{name} {i}"] = dict(
                    shape=list(fshape), **time_flash(fshape, f"{name} [{i}]"))
            for i, dshape in enumerate(dshapes):
                decode["family_geometries"][f"{name} {i}"] = dict(shape=list(dshape), **{
                    k: v for k, v in time_decode(dshape, f"{name} [{i}]").items()
                    if k in keep})
        flash["max_abs_err"] = errs["flash"]
        decode["max_abs_err"] = errs["decode"]
    return flash, decode


def _phase8_serving(timings, flash, decode, torch, np):
    """Phase 8: gemma2-9b served through ``Server`` on the card, at full
    width and depth; then a 2-layer cut held against the plain attention."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, gqa_decode_attention
    from repro_torch.launch.steps import init_params
    from repro_torch.models import attention
    from repro_torch.runtime.decode_graph import GreedyDecoder
    from repro_torch.runtime.serve_loop import Request, Server

    dev = torch.device("cuda")
    cfg = get_config("gemma2-9b")
    with _phase("8_lm_serving", timings):
        t0 = time.perf_counter()
        model = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
        print(f"   {cfg.name}: {len(model.layers)} layers, {n_params:,} parameters, "
              f"{n_bytes / 1e9:.2f} GB, seeded on the card in "
              f"{time.perf_counter() - t0:.2f} s")
        rng = np.random.default_rng(0)
        prompts = rng.integers(2, cfg.vocab_size, (4, 512))
        long_prompts = [rng.integers(2, cfg.vocab_size, n).tolist()
                        for n in (4608, 700, 129)]
        torch.cuda.reset_peak_memory_stats()

        # throughput_batch eager, graphed, graphed, eager; the main path
        # (counted) is the first graphed run and generate
        L = len(model.layers)
        runs = {}

        def batch(label, graphed):
            before = gqa_decode_attention.launches
            out = Server(cfg, model, max_len=1024).throughput_batch(
                prompts, 32, cuda_graph=graphed)
            n = gqa_decode_attention.launches - before
            assert out["cuda_graph"] is graphed and n == L * 31, (label, n)
            runs[label] = out
            return out

        batch("eager 1", False)
        flash_attention.launches = 0
        flash_attention.launches_by_variant = dict.fromkeys(
            flash_attention.launches_by_variant, 0)
        gqa_decode_attention.launches = 0
        out = batch("graphed 1", True)
        server = Server(cfg, model, max_len=5120)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(long_prompts)]
        t0 = time.perf_counter()
        server.generate(reqs)
        gen_s = time.perf_counter() - t0
        n_flash, n_decode = flash_attention.launches, gqa_decode_attention.launches
        by_variant = dict(flash_attention.launches_by_variant)
        batch("graphed 2", True)
        batch("eager 2", False)

        print(f"   launches on the 42-layer run (throughput_batch graphed, then "
              f"generate): flash_attention {n_flash} (want {L} x 4) by kernel "
              f"{by_variant}, gqa_decode_attention {n_decode} (want {L} x "
              f"(31 + 21)); every throughput_batch run, eager or graphed: "
              f"{L} x 31 decode launches")
        assert n_flash == L * 4 == 168, n_flash
        assert by_variant == {"f32_cuda_cores": 0, "bf16_wgmma": 168}, by_variant
        assert n_decode == L * (31 + 21) == 2184, n_decode
        flash["launches"], decode["launches"] = n_flash, n_decode
        assert out["output"].shape == (4, 32)
        assert ((out["output"] >= 0) & (out["output"] < cfg.vocab_size)).all()
        for label, r in runs.items():
            same = float((r["output"] == runs["eager 1"]["output"]).mean())
            print(f"   throughput_batch B=4 x 512 + 32, {label}: prefill "
                  f"{r['prefill_s'] * 1e3:.1f} ms, decode "
                  f"{r['decode_s'] * 1e3 / 31:.2f} ms per step over 31 steps "
                  f"(capture {r['capture_s'] * 1e3:.1f} ms, not counted), "
                  f"{r['tok_per_s']:.1f} tokens/s; greedy tokens equal to eager "
                  f"1's: {same * 100:.1f} %")
            assert same == 1.0, label
        decode["decode_step_ms"] = {label: r["decode_s"] * 1e3 / 31
                                    for label, r in runs.items()}
        decode["capture_ms"] = out["capture_s"] * 1e3
        assert all(r.done and len(r.generated) == 8 for r in reqs)
        assert dict(server.stats) == {"prefills": 3, "decode_ticks": 7,
                                      "tokens_out": 21}
        print(f"   generate 3 requests (4608, 700, 129 tokens, 8 new each): "
              f"{gen_s:.2f} s, latencies "
              f"{[round(r.latency_s, 3) for r in reqs]} s")
        print(f"   peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

        toks = torch.as_tensor(prompts, dtype=torch.long, device=dev)
        step = {}

        def prefill():
            step["out"] = model.prefill(toks, 1024)

        def decoder(graphed):
            logits, caches, pos = model.prefill(toks, 1024)
            return GreedyDecoder(model, caches, torch.argmax(logits[:, -1:], dim=-1),
                                 pos, cuda_graph=graphed)

        # the first replayed step's logits against the eager step's (step 2
        # of each, at position 513: a graphed decoder's first step is eager)
        first = {}
        for graphed in (False, True):
            dec = decoder(graphed)
            for _ in range(2):
                dec.step()
            torch.cuda.synchronize()
            first[graphed] = dec.logits.float().clone()
            del dec
        logit_diff = float((first[True] - first[False]).abs().max())
        print(f"   first replayed step (position 513): max |graphed - eager| "
              f"logits {logit_diff:.3e}")
        decode["graph_vs_eager_max_logit_diff"] = logit_diff

        eager_dec, graph_dec = decoder(False), decoder(True)
        for _ in range(2):
            graph_dec.step()
        torch.cuda.reset_peak_memory_stats()
        for label, fn in (("prefill B=4 x 512", prefill),
                          ("decode step B=4 at position ~512, eager", eager_dec.step),
                          ("decode step B=4 at position ~512, graph replay",
                           graph_dec.step)):
            wall, dev_ms, n_k, top, by_name = _step_profile(fn)
            attn = {n[:40]: (round(ms, 3), c) for n, (ms, c) in by_name.items()
                    if "attention" in n}
            print(f"   {label} under torch.profiler: {wall:.2f} ms wall, "
                  f"{dev_ms:.2f} ms of device time in {n_k} CUDA kernels "
                  f"(device idle {100 * (1 - dev_ms / wall):.1f} %); most "
                  f"device time: {[(n, round(ms, 3), c) for n, ms, c in top]}; "
                  f"attention kernels (ms, launches): {attn}")
            if "graph" in label:
                decode["graph_step_profile"] = dict(wall_ms=wall, device_ms=dev_ms,
                                                    kernels=n_k)
            elif "eager" in label:
                decode["eager_step_profile"] = dict(wall_ms=wall, device_ms=dev_ms,
                                                    kernels=n_k)
        # a replayed step timed with CUDA events around 10 replays, each
        # after the host has queued it
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        for _ in range(10):
            graph_dec.step()
        ev[1].record()
        ev[1].synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / 10
        print(f"   10 graph replays: {ev[0].elapsed_time(ev[1]) / 10:.3f} ms a step "
              f"between CUDA events, {host_ms:.3f} ms a step on the host clock; "
              f"graph pool: peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        decode["graph_step_event_ms"] = ev[0].elapsed_time(ev[1]) / 10
        del step, eager_dec, graph_dec

        attention.set_attention_impl("torch")
        try:
            plain = Server(cfg, model, max_len=1024).throughput_batch(
                prompts, 32, cuda_graph=False)
        finally:
            attention.set_attention_impl("kernel")
        diff = plain["output"] != out["output"]
        agree = 1.0 - float(diff.mean())
        rows = diff.any(axis=1)
        first = int(diff[rows].argmax(axis=1).min()) if rows.any() else 32
        print(f"   greedy tokens, kernels vs plain attention at 42 layers: "
              f"{agree * 100:.1f} % agree (first divergence at step {first}); "
              "printed, not asserted")
        del model, server
        torch.cuda.empty_cache()

        # The 2-layer cut at full width.  In fp32 the kernels and the plain
        # attention agree to the fp32 tolerance, asserted at 1e-4 on the
        # logits; in bf16 their difference is printed beside the plain path's
        # own (chunk 1024 against chunk 128): both are bf16 rounding noise.
        chunked = attention.chunked_attention
        for dtype in ("float32", "bfloat16"):
            cut = cfg.replace(n_layers=2, dtype=dtype)
            model = init_params(torch.Generator(device=dev).manual_seed(1), cut)
            for toks, max_len in ((prompts, 1024),
                                  (np.asarray(long_prompts[:1]), 5120)):
                toks = torch.as_tensor(toks, dtype=torch.long, device=dev)
                runs = {}
                for impl, chunk in (("kernel", None), ("torch", 1024),
                                    ("torch", 128)):
                    attention.set_attention_impl(impl)
                    attention.chunked_attention = (
                        lambda *a, c=chunk, **k: chunked(*a, chunk=c, **k))
                    try:
                        logits, caches, pos = model.prefill(toks, max_len)
                        nxt = torch.argmax(logits[:, -1:], dim=-1)
                        logits2, _ = model.decode_step(nxt, caches, pos)
                        runs[impl, chunk] = (logits.float(), logits2.float(), nxt)
                    finally:
                        attention.chunked_attention = chunked
                        attention.set_attention_impl("kernel")
                kern, plain, plain128 = runs["kernel", None], runs["torch", 1024], \
                    runs["torch", 128]
                for got in kern[:2]:
                    assert torch.isfinite(got).all()
                errs = [float((a - b).abs().max()) for a, b in zip(kern[:2], plain[:2])]
                noise = [float((a - b).abs().max())
                         for a, b in zip(plain128[:2], plain[:2])]
                same = bool((kern[2] == plain[2]).all())
                print(f"   2-layer cut {dtype}, prompt {tuple(toks.shape)}: "
                      f"prefill / first-decode logits, max |kernels - plain| "
                      f"{errs[0]:.3e} / {errs[1]:.3e}; plain chunk 128 vs 1024 "
                      f"{noise[0]:.3e} / {noise[1]:.3e}; same first token {same}")
                if dtype == "float32":
                    for got, want in zip(kern[:2], plain[:2]):
                        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
            del model
            torch.cuda.empty_cache()


def _phase9_analysis(timings, builds, torch):
    """Phase 9: the static analyzer on the card, the launch geometries the
    wrappers recorded in phases 1-8, and ``fixture_copy`` against its plain
    version and on the faulty fixture grid.  Returns fixture_copy's JSON
    record."""
    from repro_torch import analysis
    from repro_torch.analysis.checkers import launch_geometry
    from repro_torch.analysis.fixtures import (bad_launch_probes,
                                               confirm_unwritten, selftest)
    from repro_torch.analysis.targets import trace_target
    from repro_torch.kernels import (fixture_copy, flash_attention,
                                     gqa_decode_attention, seg_combine)
    from repro_torch.kernels.fixture_copy import fixture_copy_torch
    from repro_torch.kernels.fixture_copy import route as copy_route

    dev = torch.device("cuda")
    copy = {"name": "fixture_copy", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fixture_copy.cu",
            "replaces": "src/repro/analysis/fixtures.py:128",
            "build_s": builds["fixture_copy"]["seconds"]}
    with _phase("9_analysis", timings):
        recorded = launch_geometry.recorded()
        by_kernel = {}
        for p in recorded:
            by_kernel[p.kernel] = by_kernel.get(p.kernel, 0) + 1
        print(f"   launch geometries recorded by the wrappers in phases 1-8: "
              f"{by_kernel}")
        assert set(by_kernel) == {"seg_combine", "flash_attention",
                                  "decode_attention"}, by_kernel
        found = launch_geometry.probe_kernels(recorded)
        assert not found, [f.message for f in found]

        for w in (seg_combine, flash_attention, gqa_decode_attention,
                  fixture_copy):
            w.launches = 0
        t0 = time.perf_counter()
        report = analysis.run_all()
        run_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fired = selftest()
        self_s = time.perf_counter() - t0
        launches = fixture_copy.launches
        others = (seg_combine.launches, flash_attention.launches,
                  gqa_decode_attention.launches)
        baseline = analysis.load_baseline(str(ROOT / analysis.DEFAULT_BASELINE))
        new = report.new_findings(baseline)
        print(f"   run_all on the card: {run_s:.2f} s, checkers "
              f"{report.checkers_run}, {len(report.findings)} finding(s), "
              f"{len(new)} new against {analysis.DEFAULT_BASELINE} "
              f"({len(baseline)} accepted)")
        for f in new:
            print(f"   NEW {f.checker}/{f.kind} in {f.target} at {f.location}: "
                  f"{f.message}")
        assert not new and baseline == set()
        assert not report.coverage_gaps, report.coverage_gaps
        assert set(report.skipped) == {"tpu-model"}, report.skipped
        for name, why in report.skipped.items():
            print(f"   skipped target {name}: {why}")
        print(f"   selftest on the card: {self_s:.2f} s, "
              f"{ {n: len(fs) for n, fs in fired.items()} } finding(s) per checker")
        assert list(fired) == analysis.checker_names()
        assert all(fired.values()), fired
        print(f"   launches in the analyzer's run: fixture_copy {launches}; "
              f"seg_combine, flash_attention, gqa_decode_attention {others}")
        assert launches > 0, "the analyzer's run never launched fixture_copy"
        assert others == (0, 0, 0), others
        copy["launches"] = launches
        for t in analysis.iter_targets():
            if t.traceable:
                tr = trace_target(t, dev)
                print(f"   trace {t.name} on the card: {tr.seconds:.3f} s, "
                      f"{tr.n_nodes} graph nodes")

        coverage = bad_launch_probes()[0]
        n_nan = confirm_unwritten(coverage, dev)
        (claim,) = launch_geometry.probe_kernels([coverage])
        print(f"   faulty grid {coverage.spec.grid[:2]} on the card: {n_nan} "
              f"elements stayed NaN, exactly those the checker named: "
              f"{claim.message}")
        assert n_nan == 400

        gen = torch.Generator(device=dev).manual_seed(9)
        max_err = 0.0
        paths = {}
        for shape, tile in (((4, 1000), (1, 300)), ((333, 1001), (8, 100)),
                            ((16_384, 4096), (16, 512))):
            x = torch.randn(shape, generator=gen, device=dev)
            out = torch.empty_like(x)
            before = dict(fixture_copy.launches_by_variant)
            got = fixture_copy(x, tile, out=out)
            torch.cuda.synchronize()
            taken = [k for k, c in fixture_copy.launches_by_variant.items()
                     if c != before[k]]
            assert taken == [copy_route(*shape, tile, x.data_ptr(), out.data_ptr())]
            assert torch.equal(got, x.clone()), shape
            max_err = max(max_err, float((got - x).abs().max()))
            paths[shape] = taken[0]
        print(f"   fixture_copy paths taken, each equal to x.clone(): {paths}")
        assert paths[(16_384, 4096)] == "vector" and paths[(333, 1001)] == "scalar"
        # device times from CUDA events around calls queued back to back:
        # torch.profiler, asked beside them, records only some of these
        # calls at this point of the script (tools/time_kernels.py, a fresh
        # process, records one a call)
        k_ms = _median_ms(lambda: fixture_copy(x, tile, out=out))
        k_dev = _back_to_back_ms(lambda: fixture_copy(x, tile, out=out))
        k_prof, k_ops, _ = _device_profile(lambda: fixture_copy(x, tile, out=out), 10)
        p_ms = _median_ms(lambda: fixture_copy_torch(x, tile))
        l_ms = _median_ms(lambda: out.copy_(x))
        l_dev = _back_to_back_ms(lambda: out.copy_(x))
        l_prof, l_ops, _ = _device_profile(lambda: out.copy_(x), 10)
        n_bytes = 2 * x.numel() * x.element_size()      # read x, write out
        bound = n_bytes / HBM_BYTES_PER_S * 1e3         # no arithmetic
        print(f"   fixture_copy {tuple(x.shape)} f32 tile {tile}: kernel "
              f"{k_ms:.4f} ms (device {k_dev:.4f} ms back to back; "
              f"torch.profiler {k_prof:.4f} ms in {k_ops} device op(s) a call; "
              f"{100 * bound / k_dev:.1f} % of the bound), plain (x.clone()) "
              f"{p_ms:.4f} ms, out.copy_(x) {l_ms:.4f} ms (device {l_dev:.4f} ms "
              f"back to back; profiler {l_prof:.4f} ms in {l_ops}); kernel / copy_ "
              f"{k_ms / l_ms:.3f}; bound "
              f"{bound:.4f} ms (bytes: {n_bytes} B); max |kernel - x| {max_err}")
        copy.update(max_abs_err=max_err, ms=k_ms, device_ms=k_dev, plain_ms=p_ms,
                    bound_ms=bound, bound_by="bytes", library_ms=l_ms,
                    library_device_ms=l_dev, library="Tensor.copy_",
                    paths={f"{r}x{c}": v for (r, c), v in paths.items()})
    return copy


class _Counted:
    """An evaluator that counts its ``evaluate`` calls and passes everything
    else through."""

    def __init__(self, ev):
        self.ev, self.calls = ev, 0

    def __getattr__(self, name):
        return getattr(self.ev, name)

    def evaluate(self, overrides):
        self.calls += 1
        return self.ev.evaluate(overrides)


def _calibrate_on_card(runs, costs, dev) -> dict:
    """Phase 3's autodiff fit: ``fit_cost_factors_autodiff`` on the card
    (float64), one calibration step under ``torch.profiler``, and both
    fits' relative error on the fit runs.  Returns the readings."""
    import numpy as np
    import torch

    from repro_torch.calib import Observation
    from repro_torch.calib.fit import _stack_configs, build_loss_fn, build_step
    from repro_torch.mapreduce.profiler import (_FIT_COLS,
                                                fit_cost_factors_autodiff,
                                                predict)
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.spec import JobSpec, hadoop_space

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    costs_ad, report = fit_cost_factors_autodiff(runs)
    secs = time.perf_counter() - t0
    print("   autodiff refinement on the card: " + report.summary().replace(
        "\n", "\n      "))
    space = hadoop_space()
    for name, v in report.fitted.items():
        ok = space[name].bounds_mask(np.asarray([v]))
        assert np.isfinite(v) and (ok is None or ok.all()), (name, v)
    assert report.loss <= report.initial_loss, (report.loss, report.initial_loss)

    # one step, as calibrate takes it, under the profiler
    obs = [Observation(spec=JobSpec(r.hp, r.stats, costs), cost=r.wall_s)
           for r in runs]
    cols = _stack_configs(obs, dtype=torch.float64, device=dev)
    y = torch.tensor([o.cost for o in obs], dtype=torch.float64, device=dev)
    loss_fn = build_loss_fn(cols, _FIT_COLS, y, torch.ones_like(y))
    u = {n: torch.tensor(float(space[n].relax(getattr(costs, n))),
                         dtype=torch.float64, device=dev) for n in _FIT_COLS}
    step = build_step(loss_fn, _FIT_COLS, AdamWConfig(
        peak_lr=0.05, warmup_steps=12, total_steps=250, weight_decay=0.0,
        grad_clip_norm=10.0))
    state = adamw_init(u)
    wall, dev_ms, n_k, top, _ = _step_profile(lambda: step(u, state))
    errs = {}
    for label, c in (("lstsq", costs), ("autodiff", costs_ad)):
        errs[label] = [abs(predict(r.hp, r.stats, c) - r.wall_s) / r.wall_s
                       for r in runs]
    steps_per_s = report.steps / secs
    print(f"   {report.steps} steps + 2 loss evaluations in {secs:.3f} s "
          f"({steps_per_s:.1f} steps/s); one step: {wall:.3f} ms wall, "
          f"{dev_ms:.3f} ms of device time in {n_k} CUDA kernels (device idle "
          f"{100 * (1 - dev_ms / wall):.1f} %)")
    for label, e in errs.items():
        print(f"   {label} fit, relative error on the 3 fit runs: "
              + ", ".join(f"{x:.4f}" for x in e) + f" (mean {np.mean(e):.4f})")
    return {"summary": report.summary(), "steps": report.steps,
            "loss": report.loss, "initial_loss": report.initial_loss,
            "seconds": secs, "steps_per_s": steps_per_s,
            "step_wall_ms": wall, "step_device_ms": dev_ms,
            "step_kernels": n_k, "fit_rel_err": errs}


def _gradient_search(counted, ev, ev_cpu, space, spec, np) -> dict:
    """Phase 4's gradient descent on the card beside the CPU's, and through
    ``api.tune``.  Returns the readings."""
    import repro_torch.api as api
    from repro_torch.search import gradient_descent_ev

    t0 = time.perf_counter()
    grad = gradient_descent_ev(counted, space)
    t_gd = time.perf_counter() - t0
    calls, counted.calls = counted.calls, 0
    again = ev.evaluate({k: [v] for k, v in grad.best_assignment.items()})
    assert grad.best_cost == float(again.total_cost[0]), "cost not the evaluator's"
    t0 = time.perf_counter()
    grad_cpu = gradient_descent_ev(ev_cpu, space)
    t_cpu = time.perf_counter() - t0
    ps = ev.param_space
    gap = 0.0
    for k, v in grad_cpu.best_assignment.items():
        got = grad.best_assignment[k]
        if ps[k].kind in ("int", "bool"):
            assert got == v, (k, got, v)
        else:
            np.testing.assert_allclose(got, v, rtol=1e-6)
            gap = max(gap, abs(got - v) / abs(v))
    np.testing.assert_allclose(grad.best_cost, grad_cpu.best_cost, rtol=1e-6)
    gap = max(gap, abs(grad.best_cost - grad_cpu.best_cost) / grad_cpu.best_cost)
    assert grad.evaluations == grad_cpu.evaluations
    via_api = api.tune(spec, space, strategy="gradient")
    assert (via_api.best_assignment, via_api.best_cost, via_api.evaluations) == \
        (grad.best_assignment, grad.best_cost, grad.evaluations)
    print(f"   gradient descent: {grad.best_assignment} {grad.best_cost:.3f} s, "
          f"{grad.evaluations} evals in {calls} evaluator call(s), "
          f"{t_gd:.3f} s on the card ({t_cpu:.3f} s on the host CPU; largest "
          f"relative gap card vs CPU over the float axes and cost {gap:.3e}); "
          "api.tune(strategy='gradient') equal")
    return {"gradient_best_s": grad.best_cost, "gradient_rows": grad.evaluations,
            "gradient_calls": calls, "gradient_wall_s": t_gd,
            "gradient_cpu_wall_s": t_cpu, "card_vs_cpu_max_rel_gap": gap}


def _phase10_distributed(timings, split, dev, torch, np) -> dict:
    """Phase 10: the distributed pipeline over one NCCL rank, the words of
    one split.  Returns the readings (``launches``: the pipeline's
    ``seg_combine`` launches)."""
    import socket

    import torch.distributed as dist

    from repro_torch.core.hadoop.params import HadoopParams
    from repro_torch.kernels import seg_combine
    from repro_torch.kernels.seg_combine import reduce_plan
    from repro_torch.mapreduce import JOBS, MapReduceEngine, make_pipeline, wordcount_map

    with _phase("10_distributed_shuffle", timings):
        torch.cuda.set_device(dev)
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                world_size=1, rank=0, device_id=dev)
        try:
            keys = torch.from_numpy(split[0].astype(np.int32)).to(dev)
            values = torch.from_numpy(split[1]).to(dev)
            pipe = make_pipeline(key_space=DIST_PARTS)
            plain = make_pipeline(key_space=DIST_PARTS, use_kernel=False)
            seg_combine.launches = 0
            seg_combine.launches_by_variant = dict.fromkeys(
                seg_combine.launches_by_variant, 0)
            got = pipe(keys, values)
            torch.cuda.synchronize()
            launches = seg_combine.launches
            by_route = dict(seg_combine.launches_by_variant)
            assert launches > 0 and by_route["bins"] == launches, by_route
            want = plain(keys, values)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=0)

            job = JOBS["wordcount"]
            n = keys.shape[0]
            hp = HadoopParams(pNumMappers=1, pNumReducers=8, pUseCombine=True,
                              pSplitSize=n * job.pair_width)
            jc = MapReduceEngine(hp, job, use_kernel_combine=False).run_job(*split)
            ok, ov = jc.output
            dense = np.zeros(DIST_PARTS, np.float32)
            np.add.at(dense, ok % DIST_PARTS, ov)
            np.testing.assert_allclose(got.cpu().numpy(), dense, rtol=1e-5)

            words, ones = wordcount_map(keys.cpu(), values.cpu(),
                                        key_space=DIST_PARTS)
            plan = reduce_plan(ones[:, None], words, DIST_PARTS)
            assert plan.route == "bins" and plan.passes - plan.bins_passes <= 2, plan

            # timings (their launches are not the pipeline run's)
            counts = (seg_combine.launches, dict(seg_combine.launches_by_variant))
            wall_ms = _host_median_ms(lambda: pipe(keys, values).sum().item())
            plain_ms = _host_median_ms(lambda: plain(keys, values).sum().item())
            p_wall, p_dev, p_k, top, _ = _step_profile(lambda: pipe(keys, values))
            blocks = torch.ones((1, DIST_PARTS), device=dev)
            recv = torch.empty_like(blocks)
            a2a_ms = _median_ms(lambda: dist.all_to_all_single(recv, blocks))
            seg_combine.launches, seg_combine.launches_by_variant = counts
        finally:
            dist.destroy_process_group()
        print(f"   {n} records -> {ones.numel()} words, key_space {DIST_PARTS}, "
              f"one NCCL rank: {launches} seg_combine launch(es), routes "
              f"{by_route}; reduce_plan: {plan.bins_passes} of {plan.passes} "
              f"passes into shared-memory bins, {plan.atomics} global atomics; "
              "equal to index_add_ (rtol 1e-5) and the engine's dense sums")
        print(f"   pipeline {wall_ms:.3f} ms on the host clock (median of 20; "
              f"index_add_ pipeline {plain_ms:.3f} ms); under the profiler "
              f"{p_wall:.3f} ms wall, {p_dev:.4f} ms of device time in {p_k} "
              f"CUDA kernels: {top}; all_to_all_single of one (1, "
              f"{DIST_PARTS}) fp32 block {a2a_ms:.4f} ms (CUDA events, median "
              "of 50)")
    return {"launches": launches, "routes": by_route, "passes": plan.passes,
            "bins_passes": plan.bins_passes, "atomics": plan.atomics,
            "wall_ms": wall_ms, "plain_wall_ms": plain_ms,
            "profiled_wall_ms": p_wall, "device_ms": p_dev, "kernels": p_k,
            "top_kernels": top, "all_to_all_ms": a2a_ms}

# phase 11: the capacity planner's settings (the reference's cluster and cloud
# benchmarks, full mode): 64 Poisson jobs over the 4-class mix, seed 3; a
# planner batch of 2,048 scenarios over these knobs; the cloud batch of 256
PLANNER_BATCH = 2048
PLANNER_JOBS = 64
CLOUD_BATCH = 256


def _wave_rows(cols, nodes, mpn, rpn, policy, slowstart, rate, *, fast=None,
               speedup=None, queue_frac=None, topo=None):
    """(B,)-arrays of cluster knobs + one packed trace -> a wave scenario
    batch; ``fast``/``speedup`` describe a two-class fleet (fast nodes +
    baseline remainder), ``topo`` a (racks, cross_bw, oversub) row each."""
    import numpy as np

    b = len(nodes)
    tile = lambda a: np.tile(a, (b, 1))
    frac = (nodes - 1.0) / nodes
    scen = {
        "arrival": tile(cols["arrival"]) / rate[:, None],
        "n_maps": tile(cols["n_maps"]), "n_reds": tile(cols["n_reds"]),
        "map_cost": tile(cols["map_cost"]), "red_work": tile(cols["red_work"]),
        "shuffle": tile(cols["shuffle"]) * frac[:, None],
        "queue": tile(cols["queue"]), "policy": policy, "slowstart": slowstart,
    }
    if topo is not None:
        scen["topo_racks"], scen["topo_cross_bw"], scen["topo_oversub"] = topo
    if fast is None:
        scen["map_slots"] = nodes * mpn
        scen["red_slots"] = nodes * rpn
    else:
        speedup = np.ones(b) if speedup is None else speedup
        scen["map_slots"] = np.stack([fast * mpn, (nodes - fast) * mpn], 1)
        scen["red_slots"] = np.stack([fast * rpn, (nodes - fast) * rpn], 1)
        scen["speedup"] = np.stack([speedup, np.ones(b)], 1)
    if queue_frac is not None:
        scen["queue_frac"] = np.tile(np.asarray(queue_frac), (b, 1))
    return scen


def _take_rows(scen, idx):
    return {k: v[idx] for k, v in scen.items()}


def _phase11_cluster_cloud(timings, search, torch, np) -> dict:
    """Phase 11: the capacity planner and cloud provisioning on the card
    (slice 4; no TPU kernel on its path).  ``search`` is phase 4's
    (evaluator, space, HadoopParams, ProfileStats, CostFactors), for the
    split-chunk check.  Returns the readings."""
    from repro_torch import api
    from repro_torch.cloud import (CloudEvaluator, ElasticFleet, bill_workload,
                                   pareto_front, wave_columns)
    from repro_torch.cluster import (ClusterConfig, JobArrival, JobClass,
                                     NodeClass, Topology, WorkloadTrace,
                                     default_job_classes, estimate_steps,
                                     pack_trace, poisson_trace, rescale,
                                     simulate_batch, simulate_workload)
    from repro_torch.core.hadoop.params import (CostFactors, HadoopParams,
                                                ProfileStats)
    from repro_torch.core.hadoop.simulator import SimConfig
    from repro_torch.kernels import (fixture_copy, flash_attention,
                                     gqa_decode_attention, seg_combine)
    from repro_torch.obs import observe
    from repro_torch.search import ChunkedEvaluator, space_block

    dev = torch.device("cuda", 0)
    clean = SimConfig(speculative_execution=False)
    wrappers = (seg_combine, flash_attention, gqa_decode_attention, fixture_copy)
    r: dict = {}
    with _phase("11_cluster_and_cloud", timings):
        saved = [w.launches for w in wrappers]
        for w in wrappers:
            w.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        classes = default_job_classes()
        by_name = {c.name: c for c in classes}
        trace = poisson_trace(classes, PLANNER_JOBS, rate=1.0, seed=3)
        cols = pack_trace(trace)
        one = lambda x: np.array([float(x)])

        # -- agreement with the port's DES (the reference's gates) --
        def fleet(n, mpn, rpn, pol, ss, fast=0, spd=1.0, topo=None):
            nc = ()
            if fast > 0 and spd > 1.0:
                nc = (NodeClass(fast, spd),) + (
                    (NodeClass(n - fast, 1.0),) if n > fast else ())
            return ClusterConfig(
                num_nodes=n, map_slots_per_node=mpn, reduce_slots_per_node=rpn,
                scheduler=("fifo", "fair", "fair_preempt", "capacity")[pol],
                reduce_slowstart=ss, node_classes=nc, preempt_timeout=0.0,
                topology=topo)

        big = JobClass("batch", HadoopParams(pNumMappers=64, pNumReducers=8,
                                             pSplitSize=64 * 1024 * 1024),
                       ProfileStats(), CostFactors())
        small = JobClass("adhoc", HadoopParams(pNumMappers=4, pNumReducers=1,
                                               pSplitSize=64 * 1024 * 1024),
                         ProfileStats(), CostFactors())
        big_small = WorkloadTrace((JobArrival(0, big, 0.0),
                                   JobArrival(1, small, 30.0)))
        tight = Topology(num_racks=4, cross_rack_bw=0.5, oversub=2.0)
        burst = WorkloadTrace((JobArrival(0, by_name["sort"], 0.0),
                               JobArrival(1, by_name["filter"], 2.0)))
        fair_burst = WorkloadTrace(tuple(
            JobArrival(i, by_name["filter"], 0.0) for i in range(3)))
        one_sort = WorkloadTrace((JobArrival(0, by_name["sort"], 0.0),))
        # (label, trace, nodes, mpn, rpn, policy, rate, fast, speedup,
        #  queue_frac, topology, gate): gate "rtol" = finish at rtol 1e-3,
        #  "p95" = p95 within 15 %, None = reported
        rows = [
            ("serialized", trace, 4, 2, 2, 0, 0.002, 0, 1.0, None, None, "rtol"),
            ("uncontended", trace, 64, 2, 2, 0, 0.1, 0, 1.0, None, None, "rtol"),
            ("het uncontended", trace, 64, 2, 2, 0, 0.1, 32, 2.0, None, None,
             "rtol"),
            ("contended", trace, 4, 2, 2, 0, 0.1, 0, 1.0, None, None, None),
            ("het contended", trace, 4, 2, 2, 0, 0.1, 2, 2.0, None, None, None),
            ("fair_preempt big/small", big_small, 2, 2, 2, 2, 1.0, 0, 1.0,
             [0.5, 0.5], None, "rtol"),
            ("capacity big/small", big_small, 2, 2, 2, 3, 1.0, 0, 1.0,
             [0.5, 0.5], None, "rtol"),
            ("fair_preempt mixed", trace, 4, 2, 2, 2, 0.02, 0, 1.0, [0.25] * 4,
             None, "p95"),
            ("capacity mixed", trace, 4, 2, 2, 3, 0.02, 0, 1.0, [0.25] * 4,
             None, "p95"),
            ("topo columns, flat", trace, 8, 2, 2, 0, 1.0, 0, 1.0, None,
             Topology.flat(), "rtol"),
            ("topo columns, uncontended", trace, 8, 2, 2, 0, 1.0, 0, 1.0, None,
             Topology(num_racks=2, cross_rack_bw=1e9), "rtol"),
            ("single incast job", one_sort, 8, 2, 2, 0, 1.0, 0, 1.0, None,
             tight, "rtol"),
            ("contended incast burst", burst, 8, 2, 4, 0, 1.0, 0, 1.0, None,
             tight, "p95"),
            ("contended fair-share incast", fair_burst, 8, 2, 4, 1, 1.0, 0, 1.0,
             None, tight, "p95"),
        ]
        agree = []
        t0 = time.perf_counter()
        for (label, tr, n, mpn, rpn, pol, rate, fast, spd, qf, topo,
             gate) in rows:
            cc = fleet(n, mpn, rpn, pol, 0.05, fast, spd,
                       None if topo is None or topo.is_flat else topo)
            des = simulate_workload(rescale(tr, rate) if rate != 1.0 else tr,
                                    cc, clean)
            if "big/small" in label:
                assert des.num_preempted > 0, f"{label}: preemption did not fire"
            topo_cols = None if topo is None else (
                one(topo.num_racks), one(topo.cross_rack_bw), one(topo.oversub))
            out = simulate_batch(_wave_rows(
                cols if tr is trace else pack_trace(tr), one(n), one(mpn),
                one(rpn), one(pol), one(0.05), one(rate),
                fast=one(fast) if fast else None, speedup=one(spd) if fast else None,
                queue_frac=qf, topo=topo_cols))
            assert out["converged"][0] == 1.0, f"{label}: rollout truncated"
            des_fin = np.array([j.finish for j in des.jobs])
            rel = float(np.max(np.abs(out["finish"][0] - des_fin)
                               / np.maximum(des_fin, 1e-9)))
            p95_rel = abs(float(out["p95_latency"][0]) - des.p95_latency) \
                / max(des.p95_latency, 1e-9)
            if gate == "rtol":
                assert rel < 1e-3, f"{label}: DES<->wave mismatch {rel:.2e}"
            elif gate == "p95":
                assert p95_rel < 0.15, f"{label}: p95 drifted {p95_rel:.2%}"
            agree.append([label, gate, rel, p95_rel])
        agree_s = time.perf_counter() - t0
        print(f"   DES <-> wave on the card, {len(rows)} rows in {agree_s:.2f} s "
              "(finish rel. error, p95 rel. error; gates: rtol 1e-3 / p95 15 %):")
        for label, gate, rel, p95_rel in agree:
            print(f"      {label:28s} {rel:.3e}  {p95_rel:.3e}  {gate or 'reported'}")

        # -- the planner batch: 2,048 scenarios, one group per policy --
        rng = np.random.default_rng(0)
        b = PLANNER_BATCH
        nodes = rng.choice([8.0, 16.0, 32.0, 64.0], b)
        mpn = rng.choice([2.0, 4.0], b)
        rpn = rng.choice([2.0, 4.0], b)
        fair = (rng.random(b) > 0.5).astype(np.float64)
        slow = rng.choice([0.05, 0.8], b)
        rates = rng.choice([0.05, 0.1, 0.2], b)
        groups = []
        for mask in (fair < 0.5, fair >= 0.5):
            scen = _wave_rows(cols, nodes[mask], mpn[mask], rpn[mask],
                              fair[mask], slow[mask], rates[mask])
            groups.append((scen, estimate_steps(scen)))

        def planner_batch():
            return [simulate_batch(sc, n_steps=ns) for sc, ns in groups]

        outs = planner_batch()                           # warm-up
        for out in outs:
            assert float(out["converged"].mean()) == 1.0, "unconverged rows"
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            planner_batch()
            times.append(time.perf_counter() - t0)
        batch_s = float(np.median(times))
        vec_rate = b / batch_s
        with observe() as ob:
            planner_batch()
        rounds = ob.registry.snapshot()["vector_sim.rounds"]
        steps = sum(ns for _, ns in groups)
        # one batch under the profiler: kernels a round, device time, idle
        p_dev, p_k, p_wall = _device_profile(planner_batch, 1)
        per_round = p_k / rounds
        t0 = time.perf_counter()
        n_des = 6
        for i in range(n_des):
            cc = ClusterConfig(num_nodes=int(nodes[i]),
                               map_slots_per_node=int(mpn[i]),
                               reduce_slots_per_node=int(rpn[i]),
                               scheduler="fair" if fair[i] else "fifo",
                               reduce_slowstart=float(slow[i]))
            simulate_workload(rescale(trace, float(rates[i])), cc, clean)
        des_rate = n_des / (time.perf_counter() - t0)
        print(f"   planner batch: {b} scenarios x {PLANNER_JOBS} jobs in 2 policy "
              f"groups: {batch_s:.3f} s (host clock, median of 3; "
              f"{sorted(round(t, 3) for t in times)}) = {vec_rate:,.1f} "
              f"scenarios/s; the DES {des_rate:.2f} scenarios/s over {n_des}; "
              f"ratio {vec_rate / des_rate:.1f} (a reading, not a gate)")
        print(f"   rounds run {rounds} against n_steps {steps} "
              f"({[ns for _, ns in groups]}); one batch under torch.profiler: "
              f"{p_wall:.1f} ms wall, {p_dev:.1f} ms of device time in {p_k} "
              f"CUDA kernels over its {rounds} rounds ({per_round:.1f} kernels "
              f"a round), device idle {100 * (1 - p_dev / p_wall):.1f} %")

        # -- the policy mix: all four schedulers, heterogeneous fleets --
        pols = rng.choice([0.0, 1.0, 2.0, 3.0], b)
        fasts = np.minimum(rng.choice([0.0, 4.0, 8.0], b), nodes)
        spds = np.where(fasts > 0, rng.choice([1.5, 2.0], b), 1.0)
        mix = []
        for pcode in (0.0, 1.0, 2.0, 3.0):
            mask = pols == pcode
            scen = _wave_rows(cols, nodes[mask], mpn[mask], rpn[mask],
                              pols[mask], slow[mask], rates[mask],
                              fast=fasts[mask], speedup=spds[mask],
                              queue_frac=[0.25] * 4)
            mix.append((scen, estimate_steps(scen)))
        t0 = time.perf_counter()
        mix_outs = [simulate_batch(sc, n_steps=ns) for sc, ns in mix]
        mix_s = time.perf_counter() - t0
        for out in mix_outs:
            assert float(out["converged"].mean()) == 1.0, "unconverged mix rows"
        # the card against the port's CPU rollout: 16 rows of each group
        worst = 0.0
        t0 = time.perf_counter()
        for (scen, ns), out in zip(mix, mix_outs):
            idx = np.arange(min(16, len(scen["policy"])))
            host = simulate_batch(_take_rows(scen, idx), n_steps=ns, device="cpu")
            for k, v in host.items():
                got = out[k][idx]
                assert got.dtype == v.dtype, k
                np.testing.assert_allclose(got, v, rtol=1e-9, err_msg=k)
                if k != "converged":
                    fin = np.isfinite(v) & (v != 0)
                    if fin.any():
                        worst = max(worst, float(np.max(
                            np.abs(got[fin] - v[fin]) / np.abs(v[fin]))))
        cpu_s = time.perf_counter() - t0
        print(f"   policy mix: {b} scenarios (fifo/fair/fair_preempt/capacity "
              f"{[len(sc['policy']) for sc, _ in mix]}, fleets with 0/4/8 fast "
              f"nodes) in {mix_s:.3f} s, all converged; 64 of its rows equal the "
              f"port's CPU rollout (worst rel. difference {worst:.2e}, rtol 1e-9; "
              f"the CPU took {cpu_s:.2f} s)")

        # -- api.tune("cluster"): the capacity-planning example's grid --
        today = ClusterConfig(num_nodes=8, map_slots_per_node=2,
                              reduce_slots_per_node=2)
        cl_kw = dict(n_jobs=32, n_seeds=2, base=today, base_rate=0.08,
                     objective="p95", chunk=256)
        space = {
            "pNumNodes": [4.0, 8.0, 16.0], "pNumFastNodes": [0.0, 4.0],
            "fastSpeedup": [2.0], "pMaxMapsPerNode": [2.0, 4.0],
            "pMaxRedPerNode": [2.0, 4.0], "schedPolicy": [0.0, 1.0, 2.0, 3.0],
            "pReduceSlowstart": [0.05, 0.8],
        }
        t0 = time.perf_counter()
        top = api.tune("cluster", space, strategy="topk", k=5, **cl_kw)
        tune_s = time.perf_counter() - t0
        best = top.best()
        ev_c = api.get_evaluator("cluster", **cl_kw)
        exact = ev_c.exact_cost(best.assignment)
        assert np.isfinite(best.cost) and np.isfinite(exact)
        print(f"   api.tune('cluster', topk, chunk 256): {top.n_evaluated} configs "
              f"x 2 seeds in {tune_s:.2f} s; best p95 {best.cost:.2f} s at "
              f"{best.assignment}; the DES re-costs it at {exact:.2f} s "
              f"({100 * abs(best.cost - exact) / exact:.1f} % apart)")

        # -- the cloud evaluator at batch 256 --
        n_cloud = 12
        ctrace = poisson_trace(classes, n_cloud, rate=1.0, seed=3)
        ccols = pack_trace(ctrace)
        for label, cc, el in [
            ("predicted autoscale",
             ClusterConfig(num_nodes=2, node_classes=(NodeClass(2, 1.0, 0.40),)),
             ElasticFleet(policy="predicted", max_extra_nodes=2, high_water=2.0,
                          provision_latency=5.0)),
            ("fixed spot mix",
             ClusterConfig(num_nodes=4, node_classes=(
                 NodeClass(2, 1.0, 0.10, spot=True), NodeClass(2, 1.0, 0.40))),
             ElasticFleet()),
        ]:
            des = simulate_workload(rescale(ctrace, 0.002), cc, clean, elastic=el)
            wc = wave_columns(el, cc)
            scen = _wave_rows(ccols, one(cc.num_nodes), one(2), one(2), one(0),
                              one(0.05), one(0.002),
                              fast=one(cc.node_classes[0].count)
                              if len(cc.node_classes) > 1 else None)
            if len(cc.node_classes) == 1:
                scen["map_slots"] = scen["map_slots"][:, None]
                scen["red_slots"] = scen["red_slots"][:, None]
            scen.update({k: np.atleast_1d(v)[None] if k == "reclaim_rate"
                         else np.array([v]) for k, v in wc.items()})
            out = simulate_batch(scen)
            fleet_rate = sum(nc.count * nc.hourly_price for nc in cc.node_classes)
            n_extra = el.max_extra_nodes if el.policy_code > 0 else 0
            wave_usd = (fleet_rate * float(out["makespan"][0])
                        + cc.node_classes[-1].hourly_price * n_extra
                        * float(out.get("extra_billed_s", np.zeros(1))[0])) / 3600
            window = (min(j.submit_time for j in des.jobs), des.makespan)
            des_usd = bill_workload(des, cc, elastic=el, window=window)
            usd_rel = abs(wave_usd - des_usd) / des_usd
            assert usd_rel < 1e-3, f"{label}: dollars mismatch {usd_rel:.2e}"
            print(f"   cloud agreement, {label}: wave ${wave_usd:.6f} vs DES "
                  f"${des_usd:.6f} (rel. {usd_rel:.2e}, rtol 1e-3)")
        ev_d = CloudEvaluator(classes, n_jobs=8, n_seeds=1, chunk=8, sim=clean,
                              base_rate=0.02, on_demand_price=0.36,
                              spot_price=0.09)
        w = ev_d.evaluate({"pOnDemandNodes": one(2), "pSpotNodes": one(2)})
        ex = ev_d.exact_cost({"pOnDemandNodes": 2, "pSpotNodes": 2})
        ev_rel = abs(float(w.outputs["c_dollarsPerJob"][0]) - ex) / ex
        assert ev_rel < 1e-3, f"evaluator dollars mismatch {ev_rel:.2e}"
        ptrace = poisson_trace(classes, n_cloud, seed=5)
        ev_t = CloudEvaluator(classes, traces=[ptrace], n_seeds=1, sim=clean,
                              chunk=CLOUD_BATCH, base_rate=0.05,
                              on_demand_price=0.40, spot_price=0.10,
                              slo_target=0.9)
        od_vals, sp_vals = [1.0, 2.0, 4.0], [0.0, 2.0, 4.0]
        rng_c = np.random.default_rng(0)
        grid = {"pOnDemandNodes": rng_c.choice(od_vals, CLOUD_BATCH),
                "pSpotNodes": rng_c.choice(sp_vals, CLOUD_BATCH),
                "spotReclaimRate": rng_c.choice([0.0, 5e-3], CLOUD_BATCH),
                "autoscalePolicy": rng_c.choice([0.0, 1.0], CLOUD_BATCH),
                "autoscaleHighWater": np.full(CLOUD_BATCH, 2.0)}
        ev_t.evaluate(grid)                               # warm-up
        t0 = time.perf_counter()
        res = ev_t.evaluate(grid)
        cloud_s = time.perf_counter() - t0
        # valid = converged, except where a reclaim rate has no spot node
        # to act on (the declared predicate masks those rows)
        masked = (grid["spotReclaimRate"] > 0) & (grid["pSpotNodes"] == 0)
        assert np.array_equal(res.outputs["valid"] > 0, ~masked), \
            "unconverged cloud rows"
        slo = float(np.percentile(
            [j.finish - j.submit_time for j in simulate_workload(
                rescale(ptrace, 0.05),
                ClusterConfig(num_nodes=3,
                              node_classes=(NodeClass(3, 1.0, 0.40),)),
                clean).jobs], 97.0))
        pr = ev_t.evaluate({
            "pOnDemandNodes": np.repeat(od_vals, len(sp_vals)),
            "pSpotNodes": np.tile(sp_vals, len(od_vals)),
            "sloLatency": np.full(len(od_vals) * len(sp_vals), slo)})
        front = pareto_front(pr.outputs["c_dollarsPerJob"],
                             -pr.outputs["c_sloAttain"])
        assert front.any(), "empty Pareto front"
        print(f"   CloudEvaluator, batch {CLOUD_BATCH}: {cloud_s:.3f} s "
              f"({CLOUD_BATCH / cloud_s:,.1f} configs/s); Pareto front "
              f"{int(front.sum())} of {front.size} fleets at SLO {slo:.1f} s; "
              f"wave $/job vs DES at light load rel. {ev_rel:.2e} (rtol 1e-3)")
        peak = torch.cuda.max_memory_allocated(dev)
        launched = [w.launches for w in wrappers]
        assert launched == [0, 0, 0, 0], launched        # no TPU kernel here
        for wr, n in zip(wrappers, saved):
            wr.launches = n

        # -- queue 1 item 5 on the card: one chunk split over [cuda:0, cuda:0] --
        ev, sp, hp, stats, costs = search
        split_ev = ChunkedEvaluator(hp, stats, costs, chunk=ev.chunk,
                                    devices=[dev, dev])
        block = space_block(sp, 0, ev.chunk)
        a, b2 = ev.evaluate(block), split_ev.evaluate(block)
        for k, v in a.outputs.items():
            assert b2.outputs[k].tobytes() == v.tobytes(), k
        x, y = ev.chunk_topk(block, 10), split_ev.chunk_topk(block, 10)
        assert y.idx.tolist() == x.idx.tolist() and y.n_valid == x.n_valid
        print(f"   peak device memory {peak / 2**20:.1f} MiB; no TPU kernel "
              f"launched ({launched}); ChunkedEvaluator over [cuda:0, cuda:0] "
              f"equals one device bit for bit on phase 4's first chunk "
              f"({ev.chunk} rows)")
    r.update(agreement=agree, planner_batch_s=batch_s, planner_batch_times_s=times,
             scenarios_per_s=vec_rate, des_scenarios_per_s=des_rate,
             ratio=vec_rate / des_rate, rounds=rounds, n_steps=steps,
             profiled_wall_ms=p_wall, device_ms=p_dev, kernels=p_k,
             kernels_per_round=per_round, idle_share=1 - p_dev / p_wall,
             mix_s=mix_s, cpu_subset_worst_rel=worst, tune_s=tune_s,
             tune_best_p95_s=best.cost, tune_des_p95_s=exact,
             cloud_batch_s=cloud_s, pareto=int(front.sum()),
             peak_mib=peak / 2**20)
    return r


def _zero_attention_counts():
    from repro_torch.kernels import flash_attention, gqa_decode_attention

    flash_attention.launches = 0
    flash_attention.launches_by_variant = dict.fromkeys(
        flash_attention.launches_by_variant, 0)
    gqa_decode_attention.launches = 0


def _hold_cut(cfg, prompts, extra, dev, torch):
    """A 2-layer cut of ``cfg`` at full width in fp32: its prefill and first
    decode logits through the kernels held against the plain attention at
    1e-4 (TF32 off).  Returns the largest |kernels - plain| of each."""
    from repro_torch.launch.steps import init_params
    from repro_torch.models import attention

    cut = cfg.replace(n_layers=2, dtype="float32")
    model = init_params(torch.Generator(device=dev).manual_seed(1), cut)
    toks = torch.as_tensor(prompts, dtype=torch.long, device=dev)
    runs = {}
    for impl in ("kernel", "torch"):
        attention.set_attention_impl(impl)
        try:
            logits, caches, pos = model.prefill(toks, SERVE_CACHE, extra_embeds=extra)
            nxt = torch.argmax(logits[:, -1:], dim=-1)
            logits2, _ = model.decode_step(nxt, caches, pos)
            runs[impl] = (logits.float(), logits2.float())
        finally:
            attention.set_attention_impl("kernel")
    errs = []
    for got, want in zip(runs["kernel"], runs["torch"]):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        errs.append(float((got - want).abs().max()))
    del model
    torch.cuda.empty_cache()
    return errs


def _phase12_dense(timings, flash, decode, torch, np):
    """Phase 12: the other four dense configs served at full width and
    depth through the kernels, stablelm-1.6b trained at full width and
    depth, and the fp32 2-layer cuts held against the plain attention."""
    from repro_torch.analysis.checkers import launch_geometry
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, gqa_decode_attention
    from repro_torch.launch.steps import init_params
    from repro_torch.runtime.decode_graph import GreedyDecoder
    from repro_torch.runtime.serve_loop import Server

    dev = torch.device("cuda")
    out = {"serving": {}, "cuts": {}}
    before_geo = {(p.kernel, p.spec, p.shape, p.tile)
                  for p in launch_geometry.recorded()}
    with _phase("12_dense_configs_and_training", timings):
        rng = np.random.default_rng(12)
        for name in SERVE_GEOMETRIES:
            cfg = get_config(name)
            t0 = time.perf_counter()
            model = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
            torch.cuda.synchronize()
            seed_s = time.perf_counter() - t0
            L = len(model.layers)
            n_params = sum(p.numel() for p in model.parameters())
            n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
            prompts = rng.integers(2, cfg.vocab_size, (4, SERVE_PROMPT))
            torch.cuda.reset_peak_memory_stats()
            rec = {"layers": L, "parameters": n_params, "weights_gb": n_bytes / 1e9,
                   "seed_s": seed_s}
            if cfg.frontend == "vision":
                # LM.prefill with 256 patch rows before each prompt, then the
                # decode steps (the Server takes no extra_embeds)
                extra = (torch.randn((4, VISION_ROWS, cfg.d_model),
                                     generator=torch.Generator(device=dev).manual_seed(3),
                                     device=dev) * 0.02).to(torch.bfloat16)
                toks = torch.as_tensor(prompts, dtype=torch.long, device=dev)

                def run(graphed):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    logits, caches, pos = model.prefill(toks, SERVE_CACHE,
                                                        extra_embeds=extra)
                    assert int(pos) == VISION_ROWS + SERVE_PROMPT
                    dec = GreedyDecoder(model, caches, torch.argmax(logits[:, -1:], dim=-1),
                                        pos, cuda_graph=graphed)
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    outs = [dec.step().clone() for _ in range(SERVE_NEW)]
                    torch.cuda.synchronize()
                    return {"prefill_s": t1 - t0,
                            "decode_s": time.perf_counter() - t1 - dec.capture_s,
                            "output": torch.cat(outs, dim=1).cpu().numpy()}

                n_steps = SERVE_NEW
                eager = run(False)
                _zero_attention_counts()
                graphed = run(True)
            else:
                server = Server(cfg, model, max_len=SERVE_CACHE)
                n_steps = SERVE_NEW - 1
                eager = server.throughput_batch(prompts, SERVE_NEW, cuda_graph=False)
                _zero_attention_counts()
                graphed = server.throughput_batch(prompts, SERVE_NEW, cuda_graph=True)
                del server
            n_flash, n_decode = flash_attention.launches, gqa_decode_attention.launches
            by_variant = dict(flash_attention.launches_by_variant)
            same = float((graphed["output"] == eager["output"]).mean())
            assert graphed["output"].shape == (4, SERVE_NEW)
            assert ((graphed["output"] >= 0) & (graphed["output"] < cfg.vocab_size)).all()
            print(f"   {name}: {L} layers, {n_params:,} parameters, {n_bytes / 1e9:.2f} GB "
                  f"of bf16 weights seeded on the card in {seed_s:.2f} s; B 4 x "
                  f"{SERVE_PROMPT}{' after 256 patch rows' if cfg.frontend else ''} + "
                  f"{SERVE_NEW}: prefill {graphed['prefill_s'] * 1e3:.1f} ms, decode "
                  f"{graphed['decode_s'] * 1e3 / n_steps:.2f} ms a step graphed "
                  f"({eager['decode_s'] * 1e3 / n_steps:.2f} eager) over {n_steps} "
                  f"steps; graphed tokens equal to eager: {same * 100:.1f} %; "
                  f"launches flash {n_flash} (want {L}, one prefill) by kernel "
                  f"{by_variant}, decode {n_decode} (want {L} x {n_steps}); peak "
                  f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
            assert same == 1.0, name
            assert n_flash == L, (name, n_flash)
            assert by_variant == {"f32_cuda_cores": 0, "bf16_wgmma": L}
            assert n_decode == L * n_steps, (name, n_decode)
            rec.update(flash_launches=n_flash, decode_launches=n_decode,
                       prefill_ms=graphed["prefill_s"] * 1e3,
                       decode_step_ms=graphed["decode_s"] * 1e3 / n_steps,
                       eager_decode_step_ms=eager["decode_s"] * 1e3 / n_steps,
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            out["serving"][name] = rec
            del model, eager, graphed
            torch.cuda.empty_cache()

            # the 2-layer cut at full width in fp32, through the kernels and
            # through the plain attention
            extra = None
            if cfg.frontend == "vision":
                extra = torch.randn((4, VISION_ROWS, cfg.d_model), device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(4)) * 0.02
            errs = _hold_cut(cfg, prompts, extra, dev, torch)
            print(f"   {name} 2-layer cut, fp32: prefill / first-decode logits, max "
                  f"|kernels - plain| {errs[0]:.3e} / {errs[1]:.3e} (held at 1e-4)")
            out["cuts"][name] = errs
        # each path's launches: phase 8's gemma2-9b, then this phase's
        flash["launches_by_path"] = {"gemma2-9b serving": flash["launches"], **{
            f"{n} serving": r["flash_launches"] for n, r in out["serving"].items()}}
        decode["launches_by_path"] = {"gemma2-9b serving": decode["launches"], **{
            f"{n} serving": r["decode_launches"] for n, r in out["serving"].items()}}

        out["training"] = _train_stablelm(flash, torch, np)
        new_geo = [p for p in launch_geometry.recorded()
                   if (p.kernel, p.spec, p.shape, p.tile) not in before_geo]
        found = launch_geometry.probe_kernels(new_geo)
        print(f"   launch geometries phase 12 recorded: {len(new_geo)} new, "
              f"{len(found)} finding(s)")
        assert new_geo and not found, [f.message for f in found]
    for rec in (flash, decode):
        rec["launches"] = sum(rec["launches_by_path"].values())
    return out


def _serve_encdec(model, src, toks, graphed, torch):
    """seamless's serving path: ``EncDec.prefill`` over the source frames
    and the target prompt, then ``SERVE_NEW`` greedy steps through a
    ``GreedyDecoder`` (the ``Server`` serves no enc-dec, as the reference's
    does not)."""
    from repro_torch.runtime.decode_graph import GreedyDecoder

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches, pos = model.prefill(src, toks, SERVE_CACHE)
    dec = GreedyDecoder(model, caches, torch.argmax(logits[:, -1:], dim=-1), pos,
                        cuda_graph=graphed)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    outs = [dec.step().clone() for _ in range(SERVE_NEW)]
    torch.cuda.synchronize()
    return {"prefill_s": t1 - t0, "decode_s": time.perf_counter() - t1 - dec.capture_s,
            "output": torch.cat(outs, dim=1).cpu().numpy()}


def _hold_family_cut(cfg, prompts, src, dev, torch):
    """Slice 5b's fp32 cut at full width: its prefill and first-decode
    logits through the kernels against the plain attention at 1e-4 (TF32
    off); mamba2-130m, which has no attention layer, against the same
    weights run on the CPU.  Returns the largest |kernels - plain| of
    each."""
    from repro_torch.launch.steps import init_params
    from repro_torch.models import attention
    from repro_torch.models.weights import init

    if cfg.is_encdec:
        cut = cfg.replace(n_layers=2, n_enc_layers=2, dtype="float32")
    else:
        cut = cfg.replace(n_layers=FAMILY_CUT_LAYERS.get(cfg.name, 2), dtype="float32")
    model = init_params(torch.Generator(device=dev).manual_seed(1), cut)
    toks = torch.as_tensor(prompts, dtype=torch.long, device=dev)
    src = None if src is None else src.float()

    def run(m, impl, device):
        attention.set_attention_impl(impl)
        try:
            t = toks.to(device)
            if cut.is_encdec:
                logits, caches, pos = m.prefill(src.to(device), t, SERVE_CACHE)
            else:
                logits, caches, pos = m.prefill(t, SERVE_CACHE)
            logits2, _ = m.decode_step(torch.argmax(logits[:, -1:], dim=-1), caches, pos)
            return logits.float().cpu(), logits2.float().cpu()
        finally:
            attention.set_attention_impl("kernel")

    got = run(model, "kernel", dev)
    if cut.name == "mamba2-130m":
        cpu = init(cut, torch.Generator().manual_seed(0), device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        del model
        want = run(cpu, "kernel", torch.device("cpu"))
    else:
        want = run(model, "torch", dev)
        del model
    torch.cuda.empty_cache()
    errs = []
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
        errs.append(float((g - w).abs().max()))
    return errs


def _phase13_families(timings, flash, decode, torch, np):
    """Phase 13: slice 5b's five configs served at full width and depth
    through the attention kernels, one at a time, and their fp32 cuts held
    against the plain attention (mamba2-130m: against the CPU)."""
    from repro_torch.analysis.checkers import launch_geometry
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, gqa_decode_attention
    from repro_torch.launch.steps import init_params
    from repro_torch.runtime.serve_loop import Server

    dev = torch.device("cuda")
    out = {"serving": {}, "cuts": {}}
    # the geometries this phase launches, apart from the ones recorded before
    earlier = {w: set(w.geometries) for w in (flash_attention, gqa_decode_attention)}
    for w in earlier:
        w.geometries.clear()
    with _phase("13_moe_ssm_rglru_encdec", timings):
        rng = np.random.default_rng(13)
        for name in FAMILIES:
            cfg = get_config(name)
            t0 = time.perf_counter()
            model = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
            torch.cuda.synchronize()
            seed_s = time.perf_counter() - t0
            n_params = sum(p.numel() for p in model.parameters())
            n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
            torch.cuda.reset_peak_memory_stats()
            if cfg.is_encdec:
                # the encoder's layers, and self and cross in each decoder layer
                n_attn = n_flash_want = cfg.n_enc_layers + 2 * cfg.n_layers
                prompts = rng.integers(2, cfg.vocab_size, (4, ENCDEC_PROMPT))
                src = torch.randn((4, ENCDEC_SRC, cfg.d_model), device=dev,
                                  generator=torch.Generator(device=dev).manual_seed(3)
                                  ).to(torch.bfloat16)
                toks = torch.as_tensor(prompts, dtype=torch.long, device=dev)
                n_steps, n_decode_layers = SERVE_NEW, 2 * cfg.n_layers
                eager = _serve_encdec(model, src, toks, False, torch)
                _zero_attention_counts()
                graphed = _serve_encdec(model, src, toks, True, torch)
                what = (f"{ENCDEC_SRC} source frames + a {ENCDEC_PROMPT}-token prompt, "
                        f"{SERVE_NEW} new")
            else:
                n_attn = sum(layer.mixer in ("attn", "local") for layer in model.layers)
                n_flash_want, n_decode_layers = n_attn, n_attn
                prompts = rng.integers(2, cfg.vocab_size, (4, SERVE_PROMPT))
                src = None
                server = Server(cfg, model, max_len=SERVE_CACHE)
                n_steps = SERVE_NEW - 1
                eager = server.throughput_batch(prompts, SERVE_NEW, cuda_graph=False)
                _zero_attention_counts()
                graphed = server.throughput_batch(prompts, SERVE_NEW, cuda_graph=True)
                del server
                what = f"{SERVE_PROMPT} + {SERVE_NEW}"
            n_flash, n_decode = flash_attention.launches, gqa_decode_attention.launches
            by_variant = dict(flash_attention.launches_by_variant)
            peak = torch.cuda.max_memory_allocated()
            same = float((graphed["output"] == eager["output"]).mean())
            assert graphed["output"].shape == (4, SERVE_NEW)
            assert ((graphed["output"] >= 0) & (graphed["output"] < cfg.vocab_size)).all()
            print(f"   {name}: {cfg.n_layers + cfg.n_enc_layers} layers ({n_attn} "
                  f"attention), {n_params:,} parameters, {n_bytes / 1e9:.2f} GB of "
                  f"weights seeded on the card in {seed_s:.2f} s; B 4 x {what}: "
                  f"prefill {graphed['prefill_s'] * 1e3:.1f} ms, decode "
                  f"{graphed['decode_s'] * 1e3 / n_steps:.2f} ms a step graphed "
                  f"({eager['decode_s'] * 1e3 / n_steps:.2f} eager) over {n_steps} "
                  f"steps; graphed tokens equal to eager: {same * 100:.1f} %; "
                  f"launches flash {n_flash} (want {n_flash_want}, one prefill) by "
                  f"kernel {by_variant}, decode {n_decode} (want {n_decode_layers} x "
                  f"{n_steps}); peak device memory {peak / 1e9:.2f} GB")
            assert same == 1.0, name
            assert n_flash == n_flash_want, (name, n_flash)
            assert by_variant == {"f32_cuda_cores": 0, "bf16_wgmma": n_flash_want}
            assert n_decode == n_decode_layers * n_steps, (name, n_decode)
            assert peak < CARD_BYTES, (name, peak)
            out["serving"][name] = dict(
                layers=cfg.n_layers + cfg.n_enc_layers, attention_layers=n_attn,
                parameters=n_params, weights_gb=n_bytes / 1e9, seed_s=seed_s,
                flash_launches=n_flash, decode_launches=n_decode,
                prefill_ms=graphed["prefill_s"] * 1e3,
                decode_step_ms=graphed["decode_s"] * 1e3 / n_steps,
                eager_decode_step_ms=eager["decode_s"] * 1e3 / n_steps, peak_gb=peak / 1e9)
            del model, eager, graphed
            torch.cuda.empty_cache()

            errs = _hold_family_cut(cfg, prompts, src, dev, torch)
            against = "the CPU" if name == "mamba2-130m" else "plain attention"
            print(f"   {name} fp32 cut: prefill / first-decode logits, max |kernels - "
                  f"{against}| {errs[0]:.3e} / {errs[1]:.3e} (held at 1e-4)")
            out["cuts"][name] = errs
        for rec, key in ((flash, "flash_launches"), (decode, "decode_launches")):
            rec["launches_by_path"].update({
                f"{n} serving": r[key] for n, r in out["serving"].items()})
            rec["launches"] = sum(rec["launches_by_path"].values())
        probes = [p for p in launch_geometry.recorded()
                  if p.kernel in ("flash_attention", "decode_attention")]
        found = launch_geometry.probe_kernels(probes)
        print(f"   launch geometries phase 13 launched: {len(probes)}, "
              f"{len(found)} finding(s)")
        assert probes and not found, [f.message for f in found]
        for w, geo in earlier.items():
            w.geometries |= geo
    return out


# the profiler ranges of a train step (launch/steps.py, models/lm.py,
# kernels/ops.py)
RANGES = ("train_step.forward", "train_step.backward", "lm.layer",
          "flash_attention.backward")


def _kernel_us(e) -> float:
    """Device time (us) of the kernels launched under the profiler event
    ``e`` and its descendants on its thread."""
    own = sum(k.duration for k in e.kernels if k.name not in RANGES)
    return own + sum(_kernel_us(c) for c in e.cpu_children)


def _range_device_ms(events) -> dict:
    """Device ms under a train step's ranges: ``train_step.forward``,
    ``lm.layer`` started inside a ``train_step.backward`` (the recomputation
    under remat, run on autograd's thread) and ``flash_attention.backward``,
    with the number of each range."""
    cpu = [e for e in events if e.device_type.name == "CPU"]
    fwd = [e for e in cpu if e.name == "train_step.forward"]
    bwd = [(e.time_range.start, e.time_range.end) for e in cpu
           if e.name == "train_step.backward"]
    rec = [e for e in cpu if e.name == "lm.layer"
           and any(a <= e.time_range.start <= b for a, b in bwd)]
    fb = [e for e in cpu if e.name == "flash_attention.backward"]
    return {"forward": sum(map(_kernel_us, fwd)) / 1e3, "n_forward": len(fwd),
            "recompute": sum(map(_kernel_us, rec)) / 1e3, "n_recompute": len(rec),
            "flash_backward": sum(map(_kernel_us, fb)) / 1e3,
            "n_flash_backward": len(fb)}


def _train_stablelm(flash, torch, np):
    """stablelm-1.6b at full width and depth: fp32 master weights, bf16
    compute, TRAIN_STEPS AdamW steps on the token pipeline; then a 2-layer
    fp32 cut held against the plain attention and its accumulated
    gradients at 2 microbatches against 1."""
    from repro_torch.configs import get_config
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.kernels import flash_attention, gqa_decode_attention
    from repro_torch.launch.steps import (accumulate_grads, init_params, make_train_step,
                                          micro_depth)
    from repro_torch.models import attention
    from repro_torch.optim import AdamWConfig, adamw_init
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    cfg = get_config("stablelm-1.6b")
    pipe = TokenPipeline(PipelineConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH, seed=0))
    n_micro = micro_depth(TRAIN_BATCH, TRAIN_SEQ, 1)
    assert n_micro == 2, n_micro
    torch.cuda.reset_peak_memory_stats()
    model = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                        param_dtype=torch.float32)
    L = len(model.layers)
    state = adamw_init(dict(model.named_parameters()))
    step = make_train_step(cfg, AdamWConfig(), n_micro)
    batches = [pipe.batch(i) for i in range(TRAIN_STEPS + 1)]
    _zero_attention_counts()
    retries0 = torch.cuda.memory_stats()["num_alloc_retries"]
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, state, metrics = step(model, state, batches[i])
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t0)
    n_flash, n_decode = flash_attention.launches, gqa_decode_attention.launches
    by_variant = dict(flash_attention.launches_by_variant)
    peak = torch.cuda.max_memory_allocated() / 1e9
    retries = torch.cuda.memory_stats()["num_alloc_retries"] - retries0
    # forward and the per-layer recomputation under remat, per microbatch
    want = TRAIN_STEPS * n_micro * L * 2
    print(f"   stablelm-1.6b training, {L} layers at full width, fp32 master "
          f"weights, bf16 compute, batch {TRAIN_BATCH} x {TRAIN_SEQ} in {n_micro} "
          f"microbatches: losses {[round(x, 4) for x in losses]}; step "
          f"{[round(t, 3) for t in times]} s ({TRAIN_BATCH * TRAIN_SEQ / np.median(times):,.0f} "
          f"tokens/s at the median); peak device memory {peak:.2f} GB ({retries} "
          f"allocator retries, each a cudaFree of the cache); flash launches "
          f"{n_flash} (want {TRAIN_STEPS} steps x {n_micro} x {L} layers x 2, forward "
          f"and recomputation; 0 backward) by kernel {by_variant}, decode {n_decode}")
    assert all(np.isfinite(losses)), losses
    assert n_flash == want and by_variant["bf16_wgmma"] == want, (n_flash, by_variant)
    assert n_decode == 0
    flash["launches_by_path"]["stablelm-1.6b training"] = n_flash

    # one more step under torch.profiler: device time, idle share, and the
    # device time under each of the step's profiler ranges
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model, state, metrics = step(model, state, batches[TRAIN_STEPS])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    kern = [e for e in events if e.device_type.name == "CUDA" and e.name not in RANGES]
    dev_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    by_name: dict[str, float] = {}
    for e in kern:
        by_name[e.name[:50]] = by_name.get(e.name[:50], 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda t: -t[1])[:6]
    split = _range_device_ms(events)
    flash_ms = sum(e.time_range.elapsed_us() for e in kern if "flash" in e.name) / 1e3
    rest = dev_ms - split["forward"] - split["recompute"] - split["flash_backward"]
    print(f"   one training step under torch.profiler: {wall:.1f} ms wall, {dev_ms:.1f} ms "
          f"of device time in {len(kern)} CUDA kernels (device idle "
          f"{100 * (1 - dev_ms / wall):.1f} %); most device time "
          f"{[(n, round(ms, 1)) for n, ms in top]}")
    print(f"   its device time by profiler range: forward {split['forward']:.1f} ms "
          f"({split['n_forward']} ranges), the layers' recomputation under remat "
          f"{split['recompute']:.1f} ms ({split['n_recompute']} ranges), "
          f"flash_attention.backward (plain, chunked) {split['flash_backward']:.1f} ms "
          f"({split['n_flash_backward']} ranges), the rest (the other backward ops, "
          f"accumulation, AdamW) {rest:.1f} ms; the flash kernel itself {flash_ms:.1f} "
          f"ms (forward and recomputation)")
    assert split["n_forward"] == n_micro and split["n_recompute"] == n_micro * L
    assert split["n_flash_backward"] == n_micro * L
    rec = {"losses": losses, "step_s": times, "peak_gb": peak, "alloc_retries": retries,
           "flash_launches": n_flash,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / float(np.median(times)),
           "profiled_wall_ms": wall, "profiled_device_ms": dev_ms,
           "profiled_kernels": len(kern), "profiled_flash_kernel_ms": flash_ms,
           "profiled_rest_ms": rest,
           **{f"profiled_{k}_ms": v for k, v in split.items() if not k.startswith("n_")}}
    del model, state, metrics
    torch.cuda.empty_cache()

    # the 2-layer cut in fp32: loss and every gradient through the kernel
    # forward against the plain attention; then its step at 2 microbatches
    # against 1
    cut = cfg.replace(n_layers=2, dtype="float32")
    small = TokenPipeline(PipelineConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                         global_batch=4, seed=1)).batch(0)
    model = init_params(torch.Generator(device=dev).manual_seed(1), cut,
                        param_dtype=torch.float32)
    dbatch = {k: torch.as_tensor(v).to(dev) for k, v in small.items()}
    grads = {}
    for impl in ("kernel", "torch"):
        attention.set_attention_impl(impl)
        try:
            total, _ = model.loss_fn(dbatch)
            grads[impl] = [total.detach(), *torch.autograd.grad(
                total, list(model.parameters()))]
        finally:
            attention.set_attention_impl("kernel")
    worst = scaled = 0.0
    for got, want in zip(grads["kernel"], grads["torch"]):
        # rtol 1e-4 elementwise, atol 1e-4 of the tensor's largest element
        tol = 1e-4 * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=tol)
        worst = max(worst, float(((got - want).abs() / (want.abs() + tol)).max()))
        scaled = max(scaled, float((got - want).abs().max()) / (tol * 1e4))
    print(f"   stablelm-1.6b 2-layer cut, fp32, batch 4 x {TRAIN_SEQ}: loss "
          f"{float(grads['kernel'][0]):.6f} through the kernels, "
          f"{float(grads['torch'][0]):.6f} plain; loss and {len(grads['kernel']) - 1} "
          f"gradients held at rtol 1e-4 (atol 1e-4 of each tensor's largest "
          f"element); largest |kernels - plain| / (|plain| + atol) {worst:.2e}, "
          f"largest max |kernels - plain| / max |plain| of a tensor {scaled:.2e}")
    del grads
    # 2 microbatches against 1: the accumulated fp32 gradients before the
    # update (Adam's g / (|g| + eps) would amplify rounding where g is near
    # eps), held as the kernel-vs-plain gradients are
    after = {n: accumulate_grads(model, small, n) for n in (1, 2)}
    g_worst = g_scaled = 0.0
    for k, want in after[1][0].items():
        got = after[2][0][k]
        tol = 1e-4 * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=tol, msg=k)
        g_worst = max(g_worst, float(((got - want).abs() / (want.abs() + tol)).max()))
        g_scaled = max(g_scaled, float((got - want).abs().max()) / (tol * 1e4))
    l1, l2 = float(after[1][1]), float(after[2][1])
    print(f"   its accumulated gradients at 2 microbatches against 1: loss {l2:.6f} / "
          f"{l1:.6f} (held at rtol 1e-5); {len(after[1][0])} fp32 gradients held at "
          f"rtol 1e-4 (atol 1e-4 of each tensor's largest element), largest "
          f"|2 - 1| / (|1| + atol) {g_worst:.2e}, largest max |2 - 1| / max |1| of "
          f"a tensor {g_scaled:.2e}")
    assert abs(l2 - l1) <= 1e-5 * abs(l1)
    rec.update(cut_worst=worst, cut_scaled=scaled, micro_grad_worst=g_worst,
               micro_grad_scaled=g_scaled)
    del after, model
    torch.cuda.empty_cache()
    return rec


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
    from repro_torch.kernels._build import build
    from repro_torch.kernels.seg_combine import seg_combine_torch
    from repro_torch.mapreduce import JOBS, MapReduceEngine, make_input
    from repro_torch.mapreduce.profiler import (fit_cost_factors, predict,
                                                prediction_error_from_runs,
                                                run_measured)
    from repro_torch.search import (
        ChunkedEvaluator,
        WhatIfService,
        coordinate_descent_ev,
        evaluate_unchunked,
        search_topk,
        space_block,
        space_size,
    )
    from repro_torch.spec import JobSpec

    dev = torch.device("cuda")
    timings: dict[str, float] = {}
    readings: dict[str, dict] = {}
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
        builds = build("seg_combine", "flash_attention_wgmma", "flash_attention",
                       "decode_attention", "fixture_copy")
        print(f"built {len(builds)} kernels in {time.perf_counter() - t0:.2f} s, "
              "in parallel")
        for name, b in builds.items():
            print(f"   {name}: {b['path'].name} in {b['seconds']:.2f} s")
            for line in b["log"].splitlines():
                if ("registers" in line or "spill" in line
                        or "Performance Loss" in line):
                    print(f"      {line.strip()}")
        for inst, regs, spill in _ptxas_summary(builds["flash_attention_wgmma"]["log"]):
            print(f"   flash_attention_wgmma, padded hd {inst}: {regs} registers "
                  f"at launch (setmaxnreg: consumers 240, producer 24), "
                  f"{spill} bytes of spill stores")
        for inst, regs, spill in _decode_ptxas(builds["decode_attention"]["log"]):
            print(f"   decode_attention, {inst}: {regs} registers, {spill} bytes "
                  f"of spill stores")
        build_s = builds["seg_combine"]["seconds"]

    # ---------------------------------------------------------------- 1
    job = JOBS["wordcount"]
    n_maps = 4
    n_records = n_maps * RECORDS_PER_MAP
    hp = HadoopParams(pNumMappers=n_maps, pNumReducers=8, pUseCombine=True,
                      pSortMB=100.0, pSplitSize=128 * MiB)
    keys, values = make_input(job, n_records, seed=0)
    # the first map task's split (run_job splits the records in 4)
    split = (keys[:RECORDS_PER_MAP], values[:RECORDS_PER_MAP])
    spill = _engine_first_spill(job, hp, *split)

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

        # the engine's first spill, as _combine builds it, and the
        # distributed caller's map output of the same split: words mod
        # 8,192, unsorted, half of them in 64 hot keys
        ids_spill = torch.from_numpy(spill["ids"]).to(dev)
        p_spill = spill["num_parts"]
        ones_spill = torch.from_numpy(spill["vals"][:, None]).to(dev)
        check(ones_spill, ids_spill, p_spill, exact=True)
        check(vals_main, ids_spill, p_spill)
        check(vals_main.to(torch.bfloat16), ids_spill, p_spill)
        words, _ = job.map_fn(*split)
        ids_dist = torch.from_numpy((words % DIST_PARTS).astype(np.int32)).to(dev)
        ones_dist = torch.ones((ids_dist.numel(), 1), device=dev)
        check(ones_dist, ids_dist, DIST_PARTS, exact=True)
        check(ones_dist.to(torch.bfloat16), ids_dist, DIST_PARTS, exact=True)
        check(torch.from_numpy(rng.standard_normal((ids_dist.numel(), 1))
                               .astype(np.float32)).to(dev), ids_dist, DIST_PARTS)
        print(f"   held to the plain version: max |kernel - plain| {max_err:.3e} "
              f"(rtol {RTOL}, atol {ATOL}; counts exact)")

        records = {label: _time_seg_combine(label, v, ids, p, torch)
                   for label, (v, ids, p) in (
                       ("uniform", (ones, ids_main, MAIN_SHAPE[2])),
                       ("engine", (ones_spill, ids_spill, p_spill)),
                       ("distributed", (ones_dist, ids_dist, DIST_PARTS)))}
        kernel.update(records["uniform"])
        for label in ("engine", "distributed"):
            kernel.update({f"{label}_{k}": v for k, v in records[label].items()})
        kernel.update(max_abs_err=max_err, build_s=build_s)

    # ------------------------------------------------------ main path: 2-6
    seg_combine.launches = 0
    seg_combine.launches_by_variant = dict.fromkeys(seg_combine.launches_by_variant, 0)

    with _phase("2_engine", timings):
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
        assert m0.spillBufferPairs == MAIN_SHAPE[0], m0.spillBufferPairs
        print(f"   {n_records} records, {n_maps} maps x {m0.numSpills} spills of "
              f"{m0.spillBufferPairs} pairs; {launches_engine} launches "
              f"({launches_engine / n_maps:.2f} per map task, routes "
              f"{seg_combine.launches_by_variant}); engine {t_kernel:.2f} s with "
              f"the kernel, {t_numpy:.2f} s with numpy")

        # the engine's whole combine call for its first spill, and the part
        # of it on the card (copies in, wrapper, copy out); these timing
        # launches are taken back out of the main path's counts
        counts = (seg_combine.launches, dict(seg_combine.launches_by_variant))

        def on_card():
            v = torch.from_numpy(spill["vals"][:, None])
            i = torch.from_numpy(spill["ids"])
            return seg_combine(v.to(dev), i.to(dev), spill["num_parts"])[:, 0].cpu()

        combine_ms = _host_median_ms(
            lambda: engine._combine(spill["part"], spill["keys"], spill["vals"]))
        card_ms = _host_median_ms(on_card)
        seg_combine.launches, seg_combine.launches_by_variant = counts
        wrapper_ms = kernel["engine_ms"]
        print(f"   the engine's combine of its first spill ({MAIN_SHAPE[0]} pairs, "
              f"P {spill['num_parts']}): {combine_ms:.3f} ms on the host clock, "
              f"median of 20; of it copies in + wrapper + copy out {card_ms:.3f} ms "
              f"({100 * card_ms / combine_ms:.1f} %), the wrapper alone "
              f"{wrapper_ms:.4f} ms ({100 * wrapper_ms / combine_ms:.2f} %, phase 1)")
        kernel.update(engine_combine_ms=combine_ms, engine_combine_card_ms=card_ms)

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
        readings["calibration"] = _calibrate_on_card(runs, costs, dev)

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
        counted = _Counted(ev)
        t0 = time.perf_counter()
        tuned = coordinate_descent_ev(counted, space)
        t_cd = time.perf_counter() - t0
        cd_calls, counted.calls = counted.calls, 0
        assert tuned.best_cost >= top.best().cost * (1 - 1e-12)
        print(f"   grid {n_grid} configs: top-k median {rates[2]:,.0f} "
              f"configs/s on the card over 5 runs (min {rates[0]:,.0f}, max "
              f"{rates[-1]:,.0f}), {top_cpu.configs_per_sec:,.0f} on the "
              f"host CPU; best {top.best().cost:.3f} s")
        print(f"   coordinate descent: {tuned.best_assignment} "
              f"{tuned.best_cost:.3f} s, {tuned.evaluations} evals in "
              f"{cd_calls} evaluator calls, {t_cd:.3f} s "
              f"({tuned.evaluations / t_cd:,.0f} configs/s)")
        readings["gradient_search"] = _gradient_search(
            counted, ev, ev_cpu, space, JobSpec(hp, stats, costs), np)
        readings["gradient_search"].update(
            coordinate_best_s=tuned.best_cost, coordinate_rows=tuned.evaluations,
            coordinate_calls=cd_calls, coordinate_wall_s=t_cd,
            grid_best_s=top.best().cost)

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
        fits = {}
        for fit in ("lstsq", "autodiff"):
            t0 = time.perf_counter()
            fits[fit] = prediction_error_from_runs(runs, [before, after], fit=fit)
            secs = time.perf_counter() - t0
            rows = fits[fit]["rows"]
            print(f"   {fit} fit on phase 3's runs: predicted "
                  f"{rows[0]['predicted_s']:.3f} s (default) and "
                  f"{rows[1]['predicted_s']:.3f} s (tuned) against measured "
                  f"{before.wall_s:.3f} / {after.wall_s:.3f} s: mean relative "
                  f"error {fits[fit]['mean_rel_err']:.4f}, max "
                  f"{fits[fit]['max_rel_err']:.4f} ({secs:.2f} s)")
        gap = fits["autodiff"]["mean_rel_err"] - fits["lstsq"]["mean_rel_err"]
        print(f"   held-out mean relative error, autodiff - lstsq: {gap:+.4f} "
              "(two runs; a reading, not a claim)")
        readings["held_out"] = {
            fit: {"mean_rel_err": r["mean_rel_err"], "max_rel_err": r["max_rel_err"],
                  "predicted_s": [row["predicted_s"] for row in r["rows"]]}
            for fit, r in fits.items()}
        readings["held_out"]["measured_s"] = [before.wall_s, after.wall_s]
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

    flash, decode = _phase7_attention(timings, builds, torch, np)
    _phase8_serving(timings, flash, decode, torch, np)
    copy = _phase9_analysis(timings, builds, torch)
    readings["distributed"] = _phase10_distributed(timings, split,
                                                   torch.device("cuda", 0), torch, np)
    readings["cluster_cloud"] = _phase11_cluster_cloud(
        timings, (ev, space, hp, stats, costs), torch, np)
    readings["dense"] = _phase12_dense(timings, flash, decode, torch, np)
    readings["families"] = _phase13_families(timings, flash, decode, torch, np)
    kernel["main_path_launches"] = kernel["launches"]
    kernel["distributed_launches"] = readings["distributed"]["launches"]
    kernel["launches"] += kernel["distributed_launches"]

    print(json.dumps({"readings": readings}))
    print(json.dumps({"phases_s": timings}))
    print(json.dumps({"kernels": [kernel, flash, decode, copy]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
