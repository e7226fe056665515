"""Serving on the PyTorch port: batched generation + request-level serving
with KV caches on a gemma2-family model (local/global attention, ring
caches, logit soft-capping) at smoke scale.

The prompts go through the ``flash_attention`` kernel (prefill) and the
steps through ``decode_attention``, on the card.

Run:  PYTHONPATH=src python examples/torch_serve_requests.py [--device cpu] [--smoke]

The model runs on the CUDA card unless ``--device cpu`` is given;
``--smoke`` serves fewer and shorter requests.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.configs import get_config
from repro_torch.launch.steps import init_params
from repro_torch.runtime.serve_loop import Request, Server


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="serving walkthrough")
    ap.add_argument("--device", default=None,
                    help="where the model runs (default: the CUDA card)")
    ap.add_argument("--smoke", action="store_true", help="fewer, shorter requests")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config("gemma2-9b").smoke()
    model = init_params(torch.Generator(device=device).manual_seed(0), cfg,
                        device=device)
    server = Server(cfg, model, max_len=128, temperature=0.8, device=device)
    n_req, new = (2, 6) if args.smoke else (4, 12)

    # ---- request-level serving ----
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, 8 + 4 * i).tolist(),
                    max_new_tokens=new) for i in range(n_req)]
    t0 = time.perf_counter()
    done = server.generate(reqs)
    wall = time.perf_counter() - t0
    stats = dict(server.stats)
    print("== request serving ==")
    for r in done:
        print(f"  req {r.rid}: prompt {len(r.prompt):2d} toks -> "
              f"{len(r.generated)} new, e2e latency {r.latency_s*1e3:.0f}ms")
    print(f"  {stats['tokens_out']} tokens in {wall:.2f}s; "
          f"stats={stats} p50={server.latency.p50*1e3:.0f}ms "
          f"p99={server.latency.p99*1e3:.0f}ms")

    # ---- throughput batch (greedy) ----
    B, S, T = (4, 8, 8) if args.smoke else (8, 16, 16)
    prompts = rng.integers(2, cfg.vocab_size, (B, S))
    out = server.throughput_batch(prompts, new_tokens=T)
    print("\n== batched throughput ==")
    print(f"  B={B} prefill {out['prefill_s']*1e3:.0f}ms, "
          f"decode {out['decode_s']*1e3:.0f}ms, {out['tok_per_s']:.0f} tok/s")
    print(f"  sample: {out['output'][0].tolist()}")
    return {"cfg": cfg, "model": model, "server": server, "done": done, "stats": stats,
            "prompts": prompts, "new_tokens": T, "batch": out}


if __name__ == "__main__":
    main()
