"""GQA attention for prefill and decode, over full and ring KV caches.

The port of ``repro/models/attention.py``.  Two implementations, chosen by
:func:`set_attention_impl` (the reference's ``"pallas"`` / ``"xla"``
switch):

* ``"kernel"`` (the default) — the hand-written CUDA kernels through their
  checked, counted wrappers, :func:`repro_torch.kernels.flash_attention`
  for prefill and :func:`repro_torch.kernels.gqa_decode_attention` for
  decode.  On a CPU tensor the wrappers take the kernels' plain versions.
* ``"torch"`` — plain PyTorch: :func:`chunked_attention`, the reference's
  online softmax over KV chunks, and :func:`decode_attention`.  With
  ``OptFlags.flash_bwd`` set, prefill takes :func:`flash_attention_chunked`,
  the reference's ``flash_attention_xla``: the same forward, whose backward
  recomputes the scores chunk by chunk from (q, k, v, out, m, l) instead of
  saving every chunk's fp32 scores.

Four kinds of attention layer: ``"attn"`` (causal), ``"local"`` (causal
within a window), and the encoder-decoder's ``"encoder"`` (bidirectional,
with RoPE) and ``"cross"`` (q from the decoder, k and v from the encoder's
output, bidirectional, no RoPE; its decode reads a static cache).

KV caches come in two layouts (chosen per layer kind):

* **full** — slot ``i`` holds position ``i``; size = max context.
* **ring** — slot ``i`` holds the latest position ``p == i (mod W)``; size =
  window ``W``.  Local-attention layers use ring caches.

Unlike the reference, whose arrays are immutable, the port preallocates each
cache at prefill and updates it **in place** (``index_copy_`` at the slot) in
every decode step: :func:`attn_block_decode` returns the cache it was given.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _flash_kernel
from repro_torch.kernels import gqa_decode_attention as _decode_kernel
from repro_torch.kernels.decode_attention import decode_attention_torch
from repro_torch.kernels.flash_attention import chunked_backward, chunked_forward

from .layers import apply_rope
from .opt_flags import get_flags

__all__ = [
    "attention_projections",
    "project_heads",
    "chunked_attention",
    "flash_attention_chunked",
    "decode_attention",
    "attn_block_prefill",
    "attn_block_decode",
    "init_kv_cache",
    "ring_slot_positions",
    "full_slot_positions",
    "set_attention_impl",
    "KINDS",
]

# "kernel" (repro_torch.kernels) | "torch" (plain PyTorch).
_IMPL = "kernel"

#: the attention kinds of a prefill: causal, causal within the window,
#: bidirectional with RoPE, bidirectional over the encoder's keys
KINDS = ("attn", "local", "encoder", "cross")


def set_attention_impl(impl: str) -> None:
    if impl not in ("kernel", "torch"):
        raise ValueError(f"attention impl must be 'kernel' or 'torch', not {impl!r}")
    global _IMPL
    _IMPL = impl


def _dispatch_prefill(q, k, v, *, causal, window, logit_cap, q_offset):
    if _IMPL == "kernel":
        return _flash_kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=causal, window=window, logit_cap=logit_cap,
                             q_offset=q_offset)
    if get_flags().flash_bwd:
        return flash_attention_chunked(q, k, v, causal=causal, window=window,
                                       logit_cap=logit_cap, q_offset=q_offset)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             logit_cap=logit_cap, q_offset=q_offset)


def _dispatch_decode(q, k_cache, v_cache, slot_pos, pos, *, window, logit_cap,
                     layout):
    if _IMPL == "kernel":
        return _decode_kernel(q.contiguous(), k_cache, v_cache, slot_pos, pos,
                              window=window, logit_cap=logit_cap, layout=layout)
    return decode_attention(q, k_cache, v_cache, slot_pos, pos, window=window,
                            logit_cap=logit_cap)


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) @ (d, n, hd) -> (B, n, S, hd); ``w`` cast to x's dtype."""
    B, S, _ = x.shape
    n, hd = w.shape[1], w.shape[2]
    w = w.to(x.dtype).reshape(w.shape[0], n * hd)
    return (x @ w).view(B, S, n, hd).transpose(1, 2)


def _out_project(out: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, H, S, hd) @ (H, hd, d) -> (B, S, d); ``w`` cast to out's dtype."""
    B, H, S, hd = out.shape
    w = w.to(out.dtype).reshape(H * hd, w.shape[2])
    return out.transpose(1, 2).reshape(B, S, H * hd) @ w


def attention_projections(p, x: torch.Tensor):
    """x: (B, S, d) -> q (B, H, S, hd), k/v (B, KV, S, hd)."""
    return project_heads(x, p["q"]), project_heads(x, p["k"]), project_heads(x, p["v"])


def chunked_attention(
    q: torch.Tensor,            # (B, H, Sq, hd)
    k: torch.Tensor,            # (B, KV, Sk, hd)
    v: torch.Tensor,            # (B, KV, Sk, hd)
    *,
    causal: bool = True,
    window: int | None = None,
    logit_cap: float | None = None,
    q_offset: int = 0,
    chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks: O(Sq * chunk) temporaries.

    The reference's ``chunked_attention``, with the products in fp32 from
    inputs cast to fp32 and one rounding at the end, as the flash kernel
    computes them (the reference's XLA path rounds bf16 scores and
    probabilities; in fp32 the two are the same arithmetic).
    """
    out, _, _ = chunked_forward(q, k, v, causal=causal, window=window,
                                    logit_cap=logit_cap, q_offset=q_offset,
                                    chunk=chunk)
    return out.to(q.dtype)


class _FlashChunked(torch.autograd.Function):
    """:func:`chunked_attention` forward; the backward recomputes each
    chunk's probabilities from the saved m, l (the reference's
    ``_flashx_fwd`` / ``_flashx_bwd``), all in fp32."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        out, m, l = chunked_forward(q, k, v, **kw)
        ctx.kw = kw
        ctx.save_for_backward(q, k, v, out, m, l)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        return (*chunked_backward(*ctx.saved_tensors, dout, **ctx.kw), None)


def flash_attention_chunked(
    q: torch.Tensor,            # (B, H, Sq, hd)
    k: torch.Tensor,            # (B, KV, Sk, hd)
    v: torch.Tensor,            # (B, KV, Sk, hd)
    *,
    causal: bool = True,
    window: int | None = None,
    logit_cap: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """:func:`chunked_attention` (chunks of 1024 keys) with an O(Sq + chunk)
    backward: the reference's ``flash_attention_xla``.  Autodiff through
    :func:`chunked_attention` saves every chunk's fp32 scores and
    probabilities; this saves (q, k, v, out, m, l) and recomputes the
    scores chunk by chunk with :func:`~repro_torch.kernels.flash_attention.
    chunked_backward`, the backward of the kernel's forward too."""
    return _FlashChunked.apply(q, k, v, dict(causal=causal, window=window,
                                             logit_cap=logit_cap,
                                             q_offset=q_offset))


def decode_attention(
    q: torch.Tensor,            # (B, H, 1, hd)
    k_cache: torch.Tensor,      # (B, KV, S_cache, hd)
    v_cache: torch.Tensor,      # (B, KV, S_cache, hd)
    slot_pos: torch.Tensor,     # (S_cache,) int32: position held by each slot
    pos: torch.Tensor,          # 0-dim int32: current position
    *,
    window: int | None = None,
    logit_cap: float | None = None,
) -> torch.Tensor:
    """Single-token attention over a (full or ring) KV cache, in plain
    PyTorch: the decode kernel's plain version in the model's layout."""
    B, H, _, hd = q.shape
    KV = k_cache.shape[1]
    out = decode_attention_torch(q.reshape(B, KV, H // KV, hd), k_cache, v_cache,
                                 slot_pos, pos, window=window, logit_cap=logit_cap)
    return out.reshape(B, H, 1, hd)


# ------------------------------------------------------------------ caches

def init_kv_cache(batch: int, n_kv: int, size: int, head_dim: int, dtype,
                  device) -> dict:
    """Zeroed cache, for both full (size=max ctx) and ring (size=window)."""
    shape = (batch, n_kv, size, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def ring_slot_positions(pos: torch.Tensor, size: int) -> torch.Tensor:
    """Position stored in each ring slot at decode time ``pos`` (int32).

    Slot ``i`` holds the latest position p <= pos with p == i (mod size): the
    floored ``pos - ((pos - i) mod size)``.  A slot never written gets
    p < 0 and is masked by the attention.
    """
    i = torch.arange(size, dtype=torch.int32, device=pos.device)
    return pos - torch.remainder(pos - i, size)


def full_slot_positions(size: int, device) -> torch.Tensor:
    return torch.arange(size, dtype=torch.int32, device=device)


# ------------------------------------------------------------------ blocks

def attn_block_prefill(
    p,
    x: torch.Tensor,            # (B, S, d)
    inv_freq: torch.Tensor,
    *,
    kind: str,                  # "attn" | "local" | "encoder" | "cross"
    window: int,
    logit_cap: float | None,
    cache_size: int | None = None,   # build a cache of this size if not None
    kv_override: tuple | None = None,  # (k, v) for cross-attention
    q_offset: int = 0,
):
    """Prefill attention; returns (y, cache or None).

    ``"attn"`` and ``"local"`` are causal (``"local"`` within ``window``);
    ``"encoder"`` is bidirectional with RoPE; ``"cross"`` projects only q
    and attends, without RoPE and bidirectionally, over ``kv_override``
    (k, v) (B, KV, Sk, hd), the encoder's keys and values (Sk may differ
    from S)."""
    if kind not in KINDS:
        raise ValueError(f"attention kind must be one of {KINDS}, not {kind!r}")
    if (kind == "cross") != (kv_override is not None):
        raise ValueError("kv_override is given exactly for kind 'cross'")
    B, S, _ = x.shape
    if kv_override is None:
        q, k, v = attention_projections(p, x)
    else:
        q = project_heads(x, p["q"])
        k, v = kv_override
    positions = q_offset + torch.arange(S, device=x.device)
    if kind != "cross":
        q = apply_rope(q, positions[None, None, :], inv_freq)
        k = apply_rope(k, positions[None, None, :], inv_freq)
    win = window if kind == "local" else None
    out = _dispatch_prefill(q, k, v, causal=kind in ("attn", "local"), window=win,
                            logit_cap=logit_cap, q_offset=q_offset)
    y = _out_project(out, p["o"])

    cache = None
    if cache_size is not None:
        cache = init_kv_cache(B, k.shape[1], cache_size, k.shape[3], x.dtype,
                              x.device)
        if kind == "local" and cache_size < S:
            take = cache_size
            slots = torch.remainder(positions[S - take:], cache_size)
            cache["k"].index_copy_(2, slots, k[:, :, S - take:])
            cache["v"].index_copy_(2, slots, v[:, :, S - take:])
        else:
            upto = min(S, cache_size)
            cache["k"][:, :, :upto] = k[:, :, :upto]
            cache["v"][:, :, :upto] = v[:, :, :upto]
    return y, cache


def attn_block_decode(
    p,
    x: torch.Tensor,            # (B, 1, d)
    cache: dict,
    pos: torch.Tensor,          # 0-dim int32 on the device: this token's position
    inv_freq: torch.Tensor,
    *,
    kind: str,                  # "attn" | "local" | "cross"
    window: int,
    logit_cap: float | None,
    slot_pos: torch.Tensor | None = None,
):
    """One decode step: write this token's k, v into ``cache`` in place and
    attend over it.  ``slot_pos`` may be passed in when several layers share
    the cache size (it is computed from ``pos`` otherwise); it must be the
    layout of ``kind``: :func:`ring_slot_positions` at ``pos`` for a local
    layer, :func:`full_slot_positions` otherwise, which the decode kernel is
    told, so that it reads only the live span.  Returns (y, cache).

    ``"cross"`` attends over the encoder's static cache without writing it
    and without RoPE: every slot is seen, so ``pos`` must be the cache size
    (the reference's ``jnp.asarray(size)``).  The caller keeps that 0-dim
    tensor from prefill on: made inside a CUDA graph's capture it would be a
    host-to-device copy, which capture refuses."""
    if kind not in ("attn", "local", "cross"):
        raise ValueError(f"attention kind {kind!r} has no decode step")
    B = x.shape[0]
    size = cache["k"].shape[2]
    if kind == "cross":
        if slot_pos is None:
            slot_pos = full_slot_positions(size, x.device)
        out = _dispatch_decode(project_heads(x, p["q"]), cache["k"], cache["v"],
                               slot_pos, pos, window=None, logit_cap=logit_cap,
                               layout="full")
        return _out_project(out, p["o"]), cache
    q, k, v = attention_projections(p, x)
    posb = pos.reshape(1, 1, 1).expand(B, 1, 1)
    q = apply_rope(q, posb, inv_freq)
    k = apply_rope(k, posb, inv_freq)
    if kind == "local":
        slot = torch.remainder(pos, size)
        if slot_pos is None:
            slot_pos = ring_slot_positions(pos, size)
        win, layout = window, "ring"
    else:
        slot = pos
        if slot_pos is None:
            slot_pos = full_slot_positions(size, x.device)
        win, layout = None, "full"
    index = slot.reshape(1).long()
    cache["k"].index_copy_(2, index, k)
    cache["v"].index_copy_(2, index, v)
    out = _dispatch_decode(q, cache["k"], cache["v"], slot_pos, pos,
                           window=win, logit_cap=logit_cap, layout=layout)
    return _out_project(out, p["o"]), cache
