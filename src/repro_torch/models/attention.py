"""GQA attention for prefill and decode, over full and ring KV caches.

The port of ``repro/models/attention.py``.  Two implementations, chosen by
:func:`set_attention_impl` (the reference's ``"pallas"`` / ``"xla"``
switch):

* ``"kernel"`` (the default) — the hand-written CUDA kernels through their
  checked, counted wrappers, :func:`repro_torch.kernels.flash_attention`
  for prefill and :func:`repro_torch.kernels.gqa_decode_attention` for
  decode.  On a CPU tensor the wrappers take the kernels' plain versions.
* ``"torch"`` — plain PyTorch: :func:`chunked_attention`, the reference's
  online softmax over KV chunks, and :func:`decode_attention`.

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

from .layers import apply_rope

__all__ = [
    "attention_projections",
    "chunked_attention",
    "decode_attention",
    "attn_block_prefill",
    "attn_block_decode",
    "init_kv_cache",
    "ring_slot_positions",
    "full_slot_positions",
    "set_attention_impl",
]

_NEG = -1e30

# "kernel" (repro_torch.kernels) | "torch" (plain PyTorch).
_IMPL = "kernel"


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
    return chunked_attention(q, k, v, causal=causal, window=window,
                             logit_cap=logit_cap, q_offset=q_offset)


def _dispatch_decode(q, k_cache, v_cache, slot_pos, pos, *, window, logit_cap,
                     layout):
    if _IMPL == "kernel":
        return _decode_kernel(q.contiguous(), k_cache, v_cache, slot_pos, pos,
                              window=window, logit_cap=logit_cap, layout=layout)
    return decode_attention(q, k_cache, v_cache, slot_pos, pos, window=window,
                            logit_cap=logit_cap)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) @ (d, n, hd) -> (B, n, S, hd)."""
    B, S, _ = x.shape
    n, hd = w.shape[1], w.shape[2]
    return (x @ w.reshape(w.shape[0], n * hd)).view(B, S, n, hd).transpose(1, 2)


def _out_project(out: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, H, S, hd) @ (H, hd, d) -> (B, S, d)."""
    B, H, S, hd = out.shape
    return out.transpose(1, 2).reshape(B, S, H * hd) @ w.reshape(H * hd, w.shape[2])


def attention_projections(p, x: torch.Tensor):
    """x: (B, S, d) -> q (B, H, S, hd), k/v (B, KV, S, hd)."""
    return _project(x, p["q"]), _project(x, p["k"]), _project(x, p["v"])


def _mask_bias(q_pos, k_pos, *, causal: bool, window: int | None, k_len=None):
    """(Sq, C) additive mask bias in fp32."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    if k_len is not None:
        ok &= k_pos[None, :] < k_len
    return torch.where(ok, 0.0, _NEG)


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
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    dtype = q.dtype
    scale = hd ** -0.5
    chunk = min(chunk, Sk)
    qg = q.float().reshape(B, KV, G, Sq, hd)
    k, v = k.float(), v.float()
    q_pos = q_offset + torch.arange(Sq, device=q.device)

    m = torch.full((B, KV, G, Sq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32, device=q.device)
    for start in range(0, Sk, chunk):
        kc, vc = k[:, :, start:start + chunk], v[:, :, start:start + chunk]
        k_pos = start + torch.arange(chunk, device=q.device)
        if kc.shape[2] < chunk:              # the reference pads the last chunk
            pad = chunk - kc.shape[2]
            kc = torch.nn.functional.pad(kc, (0, 0, 0, pad))
            vc = torch.nn.functional.pad(vc, (0, 0, 0, pad))
        s = torch.einsum("bngqh,bnch->bngqc", qg, kc) * scale
        if logit_cap is not None:
            s = logit_cap * torch.tanh(s / logit_cap)
        s = s + _mask_bias(q_pos, k_pos, causal=causal, window=window, k_len=Sk)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bngqc,bnch->bngqh", p, vc)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, Sq, hd).to(dtype)


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
    kind: str,                  # "attn" | "local"
    window: int,
    logit_cap: float | None,
    cache_size: int | None = None,   # build a cache of this size if not None
    q_offset: int = 0,
):
    """Prefill attention; returns (y, cache or None)."""
    if kind not in ("attn", "local"):
        raise ValueError(f"attention kind {kind!r} is not ported")
    B, S, _ = x.shape
    q, k, v = attention_projections(p, x)
    positions = q_offset + torch.arange(S, device=x.device)
    q = apply_rope(q, positions[None, None, :], inv_freq)
    k = apply_rope(k, positions[None, None, :], inv_freq)
    win = window if kind == "local" else None
    out = _dispatch_prefill(q, k, v, causal=True, window=win,
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
    kind: str,                  # "attn" | "local"
    window: int,
    logit_cap: float | None,
    slot_pos: torch.Tensor | None = None,
):
    """One decode step: write this token's k, v into ``cache`` in place and
    attend over it.  ``slot_pos`` may be passed in when several layers share
    the cache size (it is computed from ``pos`` otherwise); it must be the
    layout of ``kind``: :func:`ring_slot_positions` at ``pos`` for a local
    layer, :func:`full_slot_positions` otherwise, which the decode kernel is
    told, so that it reads only the live span.  Returns (y, cache)."""
    if kind not in ("attn", "local"):
        raise ValueError(f"attention kind {kind!r} is not ported")
    B = x.shape[0]
    q, k, v = attention_projections(p, x)
    posb = pos.reshape(1, 1, 1).expand(B, 1, 1)
    q = apply_rope(q, posb, inv_freq)
    k = apply_rope(k, posb, inv_freq)
    size = cache["k"].shape[2]
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
