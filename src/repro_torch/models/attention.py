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
  computes the scores again in blocks of query rows from (q, k, v) instead
  of saving every chunk's fp32 scores.

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

Over a ``model`` mesh axis (:mod:`~repro_torch.models.tensor_parallel`) the
blocks are Megatron's: q, k and v column-parallel (a rank holds its heads;
:func:`project_heads` reads the head count from the weight), ``o``
row-parallel and followed by one SUM all-reduce, the block's input under
``copy_to_model``.  The blocks take ``heads=(n_heads, n_kv_heads)``, the
whole counts, to tell a split weight from a whole one; where the rules shard
q but replicate k and v (``n_kv_heads % tp != 0``), a rank slices out the kv
heads its q heads read (:func:`~repro_torch.models.tensor_parallel.
kv_head_slice`), so its group size is (H / tp) / (its kv heads).  Caches
hold the rank's kv heads.  The kernels run at the rank's head counts.

Where the rules shard a kv cache's **sequence** (``sharding.cache_seq_axes``:
over ``model`` where ``n_kv_heads % tp != 0``), the model group carries the
sequence group (:func:`~repro_torch.models.tensor_parallel.seq_span`) and
each rank holds
its span of every cache's slots, for every kv head the rules give it.
Prefill computes the whole prompt's k and v on every rank (the rules
replicate the k and v weights then), attends as above and fills the rank's
span.  A decode step writes the token's k and v only on the rank whose span
holds its slot (a masked write on the device: ``pos`` is never read on the
host), attends over the rank's span with every q head (gathered over
``model`` where the sequence is on it and q is sharded) through the decode
kernel with ``layout=None`` and ``return_lse=True``, merges the ranks'
partial softmaxes (:func:`~repro_torch.models.tensor_parallel.
merge_partials`) and projects the rank's q heads through ``o``.  The split
must be even; a rank's cache of n slots is then one of ``seq_size()`` equal
spans.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _flash_kernel
from repro_torch.kernels import gqa_decode_attention as _decode_kernel
from repro_torch.kernels.decode_attention import decode_attention_torch
from repro_torch.kernels.flash_attention import FlashAttentionFunction, chunked_forward

from . import tensor_parallel as tp
from .layers import apply_rope
from .opt_flags import get_flags

__all__ = [
    "attention_projections",
    "kv_projection",
    "model_split",
    "project_heads",
    "chunked_attention",
    "flash_attention_chunked",
    "decode_attention",
    "attn_block_prefill",
    "attn_block_decode",
    "init_kv_cache",
    "ring_slot_positions",
    "full_slot_positions",
    "get_attention_impl",
    "set_attention_impl",
    "KINDS",
]

# "kernel" (repro_torch.kernels) | "torch" (plain PyTorch).
_IMPL = "kernel"

#: the attention kinds of a prefill: causal, causal within the window,
#: bidirectional with RoPE, bidirectional over the encoder's keys
KINDS = ("attn", "local", "encoder", "cross")


def get_attention_impl() -> str:
    return _IMPL


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
                     layout, return_lse=False):
    if _IMPL == "kernel":
        return _decode_kernel(q.contiguous(), k_cache, v_cache, slot_pos, pos,
                              window=window, logit_cap=logit_cap, layout=layout,
                              return_lse=return_lse)
    return decode_attention(q, k_cache, v_cache, slot_pos, pos, window=window,
                            logit_cap=logit_cap, return_lse=return_lse)


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


def attention_projections(p, x: torch.Tensor, kv_heads: tuple | None = None):
    """x: (B, S, d) -> q (B, H, S, hd), k/v (B, KV, S, hd); ``kv_heads``
    (lo, hi) projects only those heads of k and v."""
    return project_heads(x, p["q"]), *kv_projection(p, x, kv_heads)


def kv_projection(p, x: torch.Tensor, kv_heads: tuple | None = None):
    """k and v (B, KV, S, hd) of ``x`` through ``p["k"]``, ``p["v"]``, or
    through their heads ``kv_heads`` = (lo, hi) only."""
    if kv_heads is None:
        return project_heads(x, p["k"]), project_heads(x, p["v"])
    lo, hi = kv_heads
    return project_heads(x, p["k"][:, lo:hi]), project_heads(x, p["v"][:, lo:hi])


def model_split(p, heads: tuple | None):
    """``(split, kv_heads)`` of a block's weights over the model axis:
    ``split`` when this rank holds a part of the heads (its input goes
    under ``copy_to_model``, its output under ``reduce_from_model``), and
    the kv heads its q heads read (None: all it holds).  ``heads`` is the
    config's (n_heads, n_kv_heads); None means the weights are whole."""
    if heads is None:
        return False, None
    kv = tp.kv_head_slice(p["q"].shape[1], p["k"].shape[1], *heads)
    if kv is None:
        return False, None
    return True, (None if kv == (0, p["k"].shape[1]) else kv)


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
    return chunked_forward(q, k, v, causal=causal, window=window,
                           logit_cap=logit_cap, q_offset=q_offset,
                           chunk=chunk).to(q.dtype)


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
    """:func:`chunked_attention` (chunks of 1024 keys) with a backward in
    blocks of query rows: the reference's ``flash_attention_xla``.  Autodiff
    through :func:`chunked_attention` saves every chunk's fp32 scores and
    probabilities; this saves (q, k, v) and computes each block's scores
    again over only the keys its rows see, with
    :func:`~repro_torch.kernels.flash_attention.chunked_backward`, the
    backward of the kernel's forward too
    (:class:`~repro_torch.kernels.flash_attention.FlashAttentionFunction`)."""
    return FlashAttentionFunction.apply(
        chunked_attention, q, k, v,
        dict(causal=causal, window=window, logit_cap=logit_cap, q_offset=q_offset))


def decode_attention(
    q: torch.Tensor,            # (B, H, 1, hd)
    k_cache: torch.Tensor,      # (B, KV, S_cache, hd)
    v_cache: torch.Tensor,      # (B, KV, S_cache, hd)
    slot_pos: torch.Tensor,     # (S_cache,) int32: position held by each slot
    pos: torch.Tensor,          # 0-dim int32: current position
    *,
    window: int | None = None,
    logit_cap: float | None = None,
    return_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Single-token attention over a (full or ring) KV cache, in plain
    PyTorch: the decode kernel's plain version in the model's layout; with
    ``return_lse`` also each row's (B, H, 1) log-sum-exp, as
    ``gqa_decode_attention`` gives it."""
    B, H, _, hd = q.shape
    KV = k_cache.shape[1]
    out = decode_attention_torch(q.reshape(B, KV, H // KV, hd), k_cache, v_cache,
                                 slot_pos, pos, window=window, logit_cap=logit_cap,
                                 return_lse=return_lse)
    if return_lse:
        return out[0].reshape(B, H, 1, hd), out[1].reshape(B, H, 1)
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
    heads: tuple | None = None,      # (n_heads, n_kv_heads): split over model
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
    split, kv_heads = model_split(p, heads)
    if split:
        x = tp.copy_to_model(x)
    # a cache whose sequence is split over model holds every kv head
    all_kv = cache_size is not None and tp.seq_on_model()
    if kv_override is None:
        q, k, v = attention_projections(p, x, None if all_kv else kv_heads)
    else:
        q = project_heads(x, p["q"])
        k, v = kv_override
    positions = q_offset + torch.arange(S, device=x.device)
    if kind != "cross":
        q = apply_rope(q, positions[None, None, :], inv_freq)
        k = apply_rope(k, positions[None, None, :], inv_freq)
    win = window if kind == "local" else None
    ka, va = k, v
    if kv_heads is not None and k.shape[1] == heads[1]:
        # every kv head, for a cache split over its sequence: attend over
        # those the rank's q heads read
        ka, va = k[:, kv_heads[0]:kv_heads[1]], v[:, kv_heads[0]:kv_heads[1]]
    out = _dispatch_prefill(q, ka, va, causal=kind in ("attn", "local"), window=win,
                            logit_cap=logit_cap, q_offset=q_offset)
    y = _out_project(out, p["o"])
    if split:
        y = tp.reduce_from_model(y)

    cache = None
    if cache_size is not None and tp.seq_size() > 1:
        cache = _span_cache(k, v, cache_size, ring=kind == "local")
    elif cache_size is not None:
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


def _span_cache(k: torch.Tensor, v: torch.Tensor, size: int, *, ring: bool) -> dict:
    """The rank's span of a cache of ``size`` slots filled from a prompt's
    k and v (B, KV, S, hd), as the whole cache would hold them: a ring's
    global slot s the latest position p < S with p == s (mod size), a full
    cache's slot s position s; slots holding none stay zero."""
    B, KV, S, hd = k.shape
    first, n = tp.seq_span(size)
    cache = init_kv_cache(B, KV, n, hd, k.dtype, k.device)
    slots = torch.arange(first, first + n)
    src = (S - 1) - torch.remainder(S - 1 - slots, size) if ring else slots
    held = (src >= 0) & (src < S)
    local = torch.arange(n)[held].to(k.device)
    src = src[held].to(k.device)
    cache["k"].index_copy_(2, local, k.index_select(2, src))
    cache["v"].index_copy_(2, local, v.index_select(2, src))
    return cache


def _write_token(cache: dict, k: torch.Tensor, v: torch.Tensor, slot: torch.Tensor,
                 first: int) -> None:
    """Write one token's k and v (B, KV, 1, hd) at the global ``slot``
    (0-dim, on the device) of a cache whose local slots start at global slot
    ``first``.  Under a sequence split only the rank whose span holds the
    slot changes its cache: every rank writes at the slot clamped into its
    span either the new row or the row already there."""
    n = cache["k"].shape[2]
    if tp.seq_size() == 1:
        index = slot.reshape(1).long()
        cache["k"].index_copy_(2, index, k)
        cache["v"].index_copy_(2, index, v)
        return
    local = slot - first
    own = (local >= 0) & (local < n)
    index = local.clamp(0, n - 1).reshape(1).long()
    for key, new in (("k", k), ("v", v)):
        c = cache[key]
        c.index_copy_(2, index, torch.where(own, new, c.index_select(2, index)))


def _attend(q: torch.Tensor, cache: dict, slot_pos, pos, *, window, logit_cap,
            layout, gather: bool) -> torch.Tensor:
    """One token's attention over ``cache``; under a sequence split the
    rank's span with every q head (``gather``: q's heads gathered over
    ``model`` first, the rank's own kept after), merged over the sequence
    group."""
    if tp.seq_size() == 1:
        return _dispatch_decode(q, cache["k"], cache["v"], slot_pos, pos,
                                window=window, logit_cap=logit_cap, layout=layout)
    h = q.shape[1]
    if gather:
        q = tp.gather_from_model(q, dim=1)
    out, lse = _dispatch_decode(q, cache["k"], cache["v"], slot_pos, pos,
                                window=window, logit_cap=logit_cap, layout=None,
                                return_lse=True)
    out = tp.merge_partials(out, lse)
    return out.narrow(1, tp.model_rank() * h, h) if gather else out


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
    heads: tuple | None = None,      # (n_heads, n_kv_heads): split over model
):
    """One decode step: write this token's k, v into ``cache`` in place and
    attend over it.  ``slot_pos`` may be passed in when several layers share
    the cache size (it is computed from ``pos`` otherwise); it must be the
    layout of ``kind``: :func:`ring_slot_positions` at ``pos`` for a local
    layer, :func:`full_slot_positions` otherwise, which the decode kernel is
    told, so that it reads only the live span.  Under a sequence split it
    is the rank's span of that layout (the whole cache's positions, sliced).
    Returns (y, cache).

    ``"cross"`` attends over the encoder's static cache without writing it
    and without RoPE: every slot is seen, so ``pos`` must be the cache size
    (the reference's ``jnp.asarray(size)``).  The caller keeps that 0-dim
    tensor from prefill on: made inside a CUDA graph's capture it would be a
    host-to-device copy, which capture refuses."""
    if kind not in ("attn", "local", "cross"):
        raise ValueError(f"attention kind {kind!r} has no decode step")
    B = x.shape[0]
    size = cache["k"].shape[2] * tp.seq_size()      # the whole cache's slots
    first, n = tp.seq_span(size)
    split, kv_heads = model_split(p, heads)
    if split:
        x = tp.copy_to_model(x)
    all_kv = tp.seq_on_model()
    gather = all_kv and heads is not None and p["q"].shape[1] < heads[0]
    if kind == "cross":
        if slot_pos is None:
            slot_pos = full_slot_positions(size, x.device)[first:first + n]
        out = _attend(project_heads(x, p["q"]), cache, slot_pos, pos, window=None,
                      logit_cap=logit_cap, layout="full", gather=gather)
        y = _out_project(out, p["o"])
        return (tp.reduce_from_model(y) if split else y), cache
    q, k, v = attention_projections(p, x, None if all_kv else kv_heads)
    posb = pos.reshape(1, 1, 1).expand(B, 1, 1)
    q = apply_rope(q, posb, inv_freq)
    k = apply_rope(k, posb, inv_freq)
    if kind == "local":
        slot = torch.remainder(pos, size)
        if slot_pos is None:
            slot_pos = ring_slot_positions(pos, size)[first:first + n]
        win, layout = window, "ring"
    else:
        slot = pos
        if slot_pos is None:
            slot_pos = full_slot_positions(size, x.device)[first:first + n]
        win, layout = None, "full"
    _write_token(cache, k, v, slot, first)
    out = _attend(q, cache, slot_pos, pos, window=win, logit_cap=logit_cap,
                  layout=layout, gather=gather)
    y = _out_project(out, p["o"])
    return (tp.reduce_from_model(y) if split else y), cache
