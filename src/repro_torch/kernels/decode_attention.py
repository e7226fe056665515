"""``decode_attention`` on Hopper: the CUDA kernel's launcher, its launch
geometry (how the cache is split across CTAs), and its plain version.

The kernel (``csrc/decode_attention.cu``) replaces the reference package's
Pallas kernel ``repro/kernels/decode_attention.py::decode_attention_kernel``:
one query token for the G heads of each kv group over a full or ring KV
cache, with the slot mask ``0 <= slot_pos <= pos`` (and ``slot_pos > pos -
window`` with a window), softcap and an online softmax in fp32.  On the card
the cache is split across CTAs (pass 1) and the partials merged (pass 2);
the source says why.  ``pos`` and ``slot_pos`` stay on the device.

:func:`decode_attention_torch` is the plain PyTorch version, in the
kernel's layout q (B, KV, G, hd), as the reference's oracle
``repro/kernels/ref.py::decode_attention_ref`` takes it.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import LaunchSpec, check, load

__all__ = ["coverage", "decode_attention_cuda", "decode_attention_torch",
           "launch_spec"]

WARPS = 4
ROWS = 4            # heads of one kv group per CTA
TARGET_CTAS = 528   # 4 per SM of an H100's 132
MIN_SPLIT = 32      # slots per CTA at least
_NEG = -1e30

_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
         + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p])
_SIGNATURES = {"decode_attention_f32": _ARGS, "decode_attention_bf16": _ARGS}


def launch_spec(B: int, KV: int, G: int, S: int, hd: int) -> tuple[LaunchSpec, int]:
    """Pass 1's launch and its split length: the S cache slots are cut into
    runs of ``split_len`` (a multiple of 8, at least 32) so that about 528
    CTAs, 4 per SM, share the cache; a CTA takes up to 4 heads of one kv
    group.  Shared memory holds the 4 warps' (m, l, acc) for the merge."""
    groups = -(-G // ROWS)
    want = max(1, -(-TARGET_CTAS // max(1, B * KV * groups)))
    per_cta = -(-S // want)
    split_len = max(MIN_SPLIT, -(-per_cta // 8) * 8)
    n_splits = max(1, -(-S // split_len))
    spec = LaunchSpec(grid=(n_splits, KV * groups, B), block=(WARPS * 32, 1, 1),
                      smem_bytes=WARPS * ROWS * (hd + 2) * 4)
    return spec, split_len


def coverage(B: int, KV: int, G: int, S: int, split_len: int
             ) -> tuple[tuple[int, int, int], tuple[int, int, int]]:
    """What pass 1's grid must cover, per grid axis (x, y, z): the S cache
    slots, the (kv head, group of up to 4 of its G heads) pairs and the B
    batch rows; and what one CTA covers of them: ``split_len`` slots of one
    pair of one batch row.  The kernel masks the slots past S and the heads
    past G."""
    return (S, KV * -(-G // ROWS), B), (split_len, 1, 1)


def decode_attention_cuda(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    slot_pos: torch.Tensor, pos: torch.Tensor, *, window: int | None,
    logit_cap: float | None, spec: LaunchSpec, split_len: int,
) -> torch.Tensor:
    """Launch both passes on the current stream; no checks, no synchronise.

    ``q`` is (B, KV, G, hd).  Callers go through
    :func:`repro_torch.kernels.gqa_decode_attention`, which checks shapes,
    types, devices and the launch's shared memory, and allocates nothing
    but the output and the partials here.
    """
    B, KV, G, hd = q.shape
    S = k_cache.shape[2]
    n_splits = spec.grid[0]
    out = torch.empty_like(q)
    part_m = torch.empty((B * KV * G * n_splits,), dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B * KV * G * n_splits, hd), dtype=torch.float32,
                           device=q.device)
    lib = load("decode_attention", _SIGNATURES)
    fn = (lib.decode_attention_f32 if q.dtype == torch.float32
          else lib.decode_attention_bf16)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 slot_pos.data_ptr(), pos.data_ptr(), part_m.data_ptr(),
                 part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
                 B, KV, G, S, hd, split_len, n_splits, hd ** -0.5,
                 window or 0, logit_cap or 0.0, spec.smem_bytes, stream)
    check(err, "decode_attention")
    return out


def decode_attention_torch(
    q: torch.Tensor,            # (B, KV, G, hd)
    k_cache: torch.Tensor,      # (B, KV, S, hd)
    v_cache: torch.Tensor,      # (B, KV, S, hd)
    slot_pos: torch.Tensor,     # (S,) int32
    pos: torch.Tensor,          # 0-dim int32
    *,
    window: int | None = None,
    logit_cap: float | None = None,
) -> torch.Tensor:
    """Plain version: scores over every slot, masked, softmax, P.V, all in
    fp32 and rounded once at the end, as the kernel computes them.  Masked
    slots get probability 0, as in the kernel."""
    hd = q.shape[-1]
    s = torch.einsum("bngh,bnch->bngc", q.float(), k_cache.float()) * hd ** -0.5
    if logit_cap is not None:
        s = logit_cap * torch.tanh(s / logit_cap)
    ok = (slot_pos >= 0) & (slot_pos <= pos)
    if window is not None:
        ok &= slot_pos > pos - window
    s = s.masked_fill(~ok, _NEG)
    p = torch.where(ok, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    w = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bngc,bnch->bngh", w, v_cache.float()).to(q.dtype)
