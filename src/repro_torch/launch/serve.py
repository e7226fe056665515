"""Serving launcher: batched generation with KV caches.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b --smoke \
        --device cpu --batch 4 --prompt-len 32 --new-tokens 16

Without ``--device`` it runs on the CUDA card and raises without one.
``--arch`` takes each decoder-only architecture (:data:`SERVABLE`); the
``Server`` serves no encoder-decoder, as the reference's does not.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.steps import init_params
from repro_torch.runtime.serve_loop import Server

#: the architectures the Server serves
SERVABLE = sorted(a for a in ARCHS if not get_config(a).is_encdec)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="gemma2-9b", choices=SERVABLE)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    device = resolve_device(args.device)
    generator = torch.Generator(device=device).manual_seed(0)
    model = init_params(generator, cfg, device=device)
    server = Server(cfg, model, max_len=args.max_len, device=device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(2, cfg.vocab_size, (args.batch, args.prompt_len))
    out = server.throughput_batch(prompts, args.new_tokens)
    print(
        f"arch={cfg.name} device={device} B={args.batch} "
        f"prompt={args.prompt_len} prefill {out['prefill_s']*1e3:.1f}ms "
        f"decode {out['decode_s']*1e3:.1f}ms ({out['tok_per_s']:.1f} tok/s)"
    )
    print("sample tokens:", out["output"][0, :12].tolist())


if __name__ == "__main__":
    main()
