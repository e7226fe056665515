#!/usr/bin/env python3
"""Time the port's ``seg_combine``, ``fixture_copy``, fp32
``flash_attention`` and ``mla_decode`` through their public wrappers, at
``chip_smoke.py``'s phase 1, 9, 7 and 18 shapes, so that two checkouts of
the port can be compared on one card.

    python3 tools/time_kernels.py                  # this checkout
    python3 tools/time_kernels.py --src DIR/src    # the port under DIR/src
    python3 tools/time_kernels.py --ab DIR         # DIR, this, this, DIR

``--ab`` runs each side in a process of its own, in the order other, this,
this, other (DIR is another checkout, for example the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists),
and prints every run.  Each run prints one JSON line: the card and its
power limit, and per shape the wrapper's ms (CUDA events around one call,
median of 50) and the device ms and device ops a call (``torch.profiler``
over 20 calls; for ``fixture_copy`` and ``Tensor.copy_``, 10 calls, and
CUDA events around 20 calls queued back to back besides).  The shapes: ``seg_combine`` on the uniform sorted ids of
``MAIN_SHAPE``, the engine's first spill and the distributed caller's
unsorted words (values ones); ``fixture_copy`` at (16384, 4096) in (16, 512)
tiles, beside ``Tensor.copy_``; ``flash_attention`` in fp32 (TF32 off) at
``FLASH_MAIN``, ``FLASH_E2E``, ``FLASH_ENCODER`` and ``FLASH_DEEPSEEK``
(wrapper ms, device ms back to back, and max |kernel - plain|, held at
1e-5); ``mla_decode`` at ``MLA_SHAPES`` (max |kernel - plain| over each
shape's positions, held at bf16's 2e-2, two calls bit-equal; device ms a
call at the first position, the median of 3 back-to-back windows, beside
the bound: live rows, q and the output at 3.35 TB/s).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(src: str) -> dict:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                 # puts this checkout's src on the path

    sys.path.insert(0, src)                 # ahead of it: the side timed
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.core.hadoop.params import HadoopParams
    from repro_torch.kernels import (fixture_copy, flash_attention, mla_decode_attention,
                                     seg_combine)
    from repro_torch.kernels.flash_attention import flash_attention_torch
    from repro_torch.kernels.mla_decode import mla_decode_torch
    from repro_torch.models.mla import softmax_scale
    from repro_torch.mapreduce import JOBS, make_input

    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: needs a CUDA card")
    dev = torch.device("cuda")
    out = {"src": str(Path(repro_torch.__file__).resolve().parents[1]),
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               check=True).stdout.strip().splitlines()[0]}
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(7)
    for label, shape in (("main", cs.FLASH_MAIN), ("train_e2e", cs.FLASH_E2E),
                         ("encoder", cs.FLASH_ENCODER), ("deepseek", cs.FLASH_DEEPSEEK)):
        B, H, KV, Sq, Sk, hd = shape[:6]
        q, k, v = (torch.randn(s, generator=gen, device=dev)
                   for s in ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd)))
        kw = dict(causal=shape[6], window=shape[7], logit_cap=shape[8],
                  q_offset=shape[9])
        err = float((flash_attention(q, k, v, **kw)
                     - flash_attention_torch(q, k, v, **kw)).abs().max())
        assert err <= 1e-5, (label, err)
        out[f"flash_f32_{label}"] = dict(
            ms=cs._median_ms(lambda: flash_attention(q, k, v, **kw)),
            device_ms=cs._back_to_back_ms(lambda: flash_attention(q, k, v, **kw)),
            max_abs_err=err)
    job = JOBS["wordcount"]
    hp = HadoopParams(pNumMappers=4, pNumReducers=8, pUseCombine=True,
                      pSortMB=100.0, pSplitSize=128 * cs.MiB)
    keys, values = make_input(job, 4 * cs.RECORDS_PER_MAP, seed=0)
    split = (keys[:cs.RECORDS_PER_MAP], values[:cs.RECORDS_PER_MAP])
    spill = cs._engine_first_spill(job, hp, *split)
    words, _ = job.map_fn(*split)
    n, _, p = cs.MAIN_SHAPE
    rng = np.random.default_rng(0)
    shapes = {
        "uniform": (np.sort(rng.integers(0, p, n)), p),
        "engine": (spill["ids"], spill["num_parts"]),
        "distributed": (words % cs.DIST_PARTS, cs.DIST_PARTS),
    }
    for label, (ids, parts) in shapes.items():
        i = torch.from_numpy(ids.astype(np.int32)).to(dev)
        v = torch.ones((i.numel(), 1), device=dev)
        want = torch.bincount(i.long(), minlength=parts).float()[:, None]
        assert torch.equal(seg_combine(v, i, parts), want), label
        ms = cs._median_ms(lambda: seg_combine(v, i, parts))
        dev_ms, ops, _ = cs._device_profile(lambda: seg_combine(v, i, parts), 20)
        out[f"seg_combine_{label}"] = dict(ms=ms, device_ms=dev_ms, device_ops=ops)
    x = torch.randn((16_384, 4096), device=dev)
    o = torch.empty_like(x)
    fixture_copy(x, (16, 512), out=o)
    assert torch.equal(o, x)
    for label, fn in (("fixture_copy", lambda: fixture_copy(x, (16, 512), out=o)),
                      ("copy_", lambda: o.copy_(x))):
        ms = cs._median_ms(fn)
        b2b = cs._back_to_back_ms(fn)
        dev_ms, ops, _ = cs._device_profile(fn, 10)
        out[label] = dict(ms=ms, device_ms=dev_ms, device_ops=ops,
                          back_to_back_ms=b2b)
    del x, o
    gen = torch.Generator(device=dev).manual_seed(18)
    scale = softmax_scale(get_config("deepseek-v2-lite"))
    for label, (B, H, S, D, V), positions in cs.MLA_SHAPES:
        q = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
        lat = torch.randn((B, S, D), generator=gen, device=dev).to(torch.bfloat16)
        err = 0.0
        for pos in positions:
            p = torch.tensor(pos, dtype=torch.int32, device=dev)
            got = mla_decode_attention(q, lat, p, scale=scale, v_dim=V)
            assert torch.equal(got, mla_decode_attention(q, lat, p, scale=scale, v_dim=V))
            want = torch.cat([mla_decode_torch(q[i:i + 1], lat[i:i + 1], p, scale=scale,
                                               v_dim=V) for i in range(B)])
            err = max(err, float((got.float() - want.float()).abs().max()))
        assert err <= cs.ATTN_TOL["bfloat16"], (label, err)
        p = torch.tensor(positions[0], dtype=torch.int32, device=dev)
        ms = statistics.median(cs._back_to_back_ms(
            lambda: mla_decode_attention(q, lat, p, scale=scale, v_dim=V)) for _ in range(3))
        live = max(min(positions[0], S - 1) + 1, 0)
        bound_ms = (B * live * D + B * H * D + B * H * V) * 2 / cs.HBM_BYTES_PER_S * 1e3
        out[f"mla_decode_{label}"] = dict(device_ms=ms, bound_ms=bound_ms,
                                          roofline_pct=100 * bound_ms / ms, max_abs_err=err)
        del q, lat, got, want
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory of the port to time")
    ap.add_argument("--ab", metavar="DIR",
                    help="another checkout: time DIR, this, this, DIR in turn")
    args = ap.parse_args()
    if args.ab is None:
        print(json.dumps(_run(str(Path(args.src).resolve()))))
        return 0
    other = str(Path(args.ab).resolve() / "src")
    for src in (other, str(ROOT / "src"), str(ROOT / "src"), other):
        subprocess.run([sys.executable, __file__, "--src", src], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
