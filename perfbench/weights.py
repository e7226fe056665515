"""Seeded weights and inputs, made by the benchmark and handed to both
sides: the program under test and the reference.

:func:`layout` lists every parameter of a configuration in a fixed order
with its shape and its initialisation: a matmul weight (and the embedding)
is normal, times its fan-in ``** -0.5`` (the embedding ``d ** -0.5``, ``o``
``(H * hd) ** -0.5``, an expert stack its middle axis); a norm's scale is
``1 + NORM_STD * N(0, 1)`` and its bias ``NORM_STD * N(0, 1)``, so that a
side that ignored or swapped norm weights would not read alike.
:func:`make` draws the matmul leaves into one flat buffer on the device,
with a ``torch.Generator`` there, in a few large calls, in the dtype they
are served or trained in, and the norm leaves into a second, float32 one,
and returns a view of a buffer per leaf.  The same seed gives the same
bits, so the reference draws the weights again after the program's run is
over.
"""

from __future__ import annotations

import math

import torch

__all__ = ["CHUNK", "NORM_STD", "layout", "make", "sub_seed", "tokens"]

#: elements drawn by one call
CHUNK = 1 << 30

#: the spread of a norm's scale around 1, and of its bias around 0
NORM_STD = 0.1


def sub_seed(seed: int, *keys: int) -> int:
    """A generator seed for the stream ``keys`` of run ``seed`` (any whole
    number, negative or beyond 64 bits included)."""
    h = seed % (1 << 64)
    for k in keys:
        h = (h * 0x9E3779B97F4A7C15 + k + 1) % (1 << 64)
    return h % (1 << 63)


def layout(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """``(name, shape, kind, value)``: kind ``"normal"`` (value: its std;
    drawn in the compute dtype) or ``"norm"`` (value: its mean; std
    ``NORM_STD``, float32)."""
    d, V = cfg["d_model"], cfg["vocab_size"]
    H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    out = []

    def w(name, shape, fan):
        out.append((name, shape, "normal", fan ** -0.5))

    def n(name):
        out.append((name + ".scale", (d,), "norm", 1.0))
        if cfg["norm_type"] == "layernorm":
            out.append((name + ".bias", (d,), "norm", 0.0))

    w("embed", (V, d), d)
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}."
        n(p + "ln1")
        w(p + "attn.q", (d, H, hd), d)
        w(p + "attn.k", (d, KV, hd), d)
        w(p + "attn.v", (d, KV, hd), d)
        w(p + "attn.o", (H, hd, d), H * hd)
        n(p + "ln2")
        if cfg.get("n_experts", 0) and i >= cfg.get("moe_layer_start", 0):
            E, de = cfg["n_experts"], cfg["d_expert"]
            w(p + "moe.router", (d, E), d)
            w(p + "moe.experts.wi", (E, d, de), d)
            w(p + "moe.experts.wg", (E, d, de), d)
            w(p + "moe.experts.wo", (E, de, d), de)
            if cfg.get("n_shared_experts", 0):
                ff = cfg["n_shared_experts"] * de
                w(p + "moe.shared.wi", (d, ff), d)
                w(p + "moe.shared.wg", (d, ff), d)
                w(p + "moe.shared.wo", (ff, d), ff)
        else:
            ff = cfg["d_ff_dense"] if cfg.get("n_experts", 0) and cfg.get(
                "d_ff_dense") else cfg["d_ff"]
            w(p + "mlp.wi", (d, ff), d)
            w(p + "mlp.wg", (d, ff), d)
            w(p + "mlp.wo", (ff, d), ff)
    n("final_norm")
    w("lm_head", (d, V), d)
    return out


@torch.no_grad()
def make(cfg: dict, seed: int, dtype: torch.dtype, device) -> dict[str, torch.Tensor]:
    """Every parameter of ``cfg`` from ``seed``: matmul leaves as views of
    one flat ``dtype`` buffer drawn on ``device``, norm leaves as views of
    one float32 buffer drawn there from a stream of their own."""
    leaves = layout(cfg)
    flats, offs = {}, {}
    for stream, kind, dt in ((0, "normal", dtype), (1, "norm", torch.float32)):
        total = sum(math.prod(s) for _, s, k, _ in leaves if k == kind)
        flat = torch.empty(total, dtype=dt, device=device)
        gen = torch.Generator(device=device).manual_seed(sub_seed(seed, stream))
        for lo in range(0, total, CHUNK):
            flat[lo:lo + CHUNK].normal_(generator=gen)
        flats[kind], offs[kind] = flat, 0
    out = {}
    for name, shape, kind, value in leaves:
        size, off = math.prod(shape), offs[kind]
        leaf = flats[kind][off:off + size].view(shape)
        out[name] = leaf.mul_(value) if kind == "normal" else leaf.mul_(NORM_STD).add_(value)
        offs[kind] = off + size
    return out


def tokens(seed: int, stream: int, index: int, shape: tuple, vocab: int,
           device) -> torch.Tensor:
    """Token ids of item ``index`` of stream ``stream``, uniform over the
    vocabulary, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, stream, index))
    return torch.randint(vocab, shape, generator=gen, device=device)
