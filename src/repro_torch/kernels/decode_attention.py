"""``decode_attention`` on Hopper: the CUDA kernel's launcher, its launch
geometry and split plan, and its plain version.

The kernel (``csrc/decode_attention.cu``) replaces the reference package's
Pallas kernel ``repro/kernels/decode_attention.py::decode_attention_kernel``:
one query token for the G heads of each kv group over a full or ring KV
cache, with the slot mask ``0 <= slot_pos <= pos`` (and ``slot_pos > pos -
window`` with a window), softcap and an online softmax in fp32.  It is one
launch a call: CTAs share the cache's live span, and the last CTA of each
(batch row, kv head) merges their partials; the source says why.  ``pos``
and ``slot_pos`` stay on the device.

:func:`live_span` and :func:`split_plan` are the Python copy of the split the
kernel decides on the device from ``pos``: which slots each CTA reads, so
the CPU tests can hold it to the mask.  :func:`decode_attention_torch` is the
plain PyTorch version, in the kernel's layout q (B, KV, G, hd), as the
reference's oracle ``repro/kernels/ref.py::decode_attention_ref`` takes it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import LaunchSpec, check, load

__all__ = ["LAYOUTS", "coverage", "decode_attention_cuda",
           "decode_attention_torch", "launch_spec", "live_span", "split_plan"]

WARPS = 4
TILE = 32           # cache rows per shared-memory stage
STAGES = 2
MAX_G = 16          # heads per kv group: the rows of the bf16 path's mma tile
MAX_SPLITS = 32     # CTAs a (batch row, kv head) at most
SMS = 132           # an H100 SXM's SMs
SM_SMEM = 233_472   # shared memory an SM has for its blocks
BLOCK_RESERVED = 1024   # shared memory the card keeps per block
MAX_BLOCKS_PER_SM = 4   # what 128-thread blocks of up to 128 registers allow
#: the tile's scratch: scores (16 x 32 fp32), probabilities in two bf16
#: parts (2 x 16 x 40) and rescale factors (16 fp32) of the bf16 path
SCRATCH_BYTES = 16 * TILE * 4 + 2 * 16 * 40 * 2 + 16 * 4
_NEG = -1e30

#: the cache layout a call declares -> the kernel's code for it
LAYOUTS = {None: 0, "full": 1, "ring": 2}

_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
         + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p])
_SIGNATURES = {"decode_attention_f32": _ARGS, "decode_attention_bf16": _ARGS}


def live_span(pos: int, S: int, *, window: int | None = None,
              layout: str | None = None) -> tuple[int, int]:
    """(first slot, number of slots) of the span the kernel splits at
    position ``pos``; slot ``first + j`` (mod S) holds the span's j-th row.

    ``layout=None`` (an arbitrary ``slot_pos``): all S slots.  ``"full"``
    (slot i holds position i): positions ``[max(0, pos - window + 1),
    min(pos, S - 1)]``.  ``"ring"`` (slot i holds the latest position
    ``== i (mod S)``): positions ``[max(0, pos - window + 1, pos - S + 1),
    pos]``, from slot ``lo mod S`` on, wrapping."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {list(LAYOUTS)}, not {layout!r}")
    if layout is None:
        return 0, S
    lo = pos - window + 1 if window else 0
    hi = pos
    if layout == "full":
        hi = min(hi, S - 1)
    else:
        lo = max(lo, pos - S + 1)
    lo = max(lo, 0)
    n = max(hi - lo + 1, 0)
    return (lo % S if layout == "ring" else lo), n


def split_plan(pos: int, S: int, n_splits: int, *, window: int | None = None,
               layout: str | None = None) -> list[list[int]]:
    """The slots each of the ``n_splits`` CTAs of one (batch row, kv head)
    reads at position ``pos``, in the order it reads them: the span of
    :func:`live_span` cut into tiles of 32 rows, CTA c taking tiles
    ``[c T // n, (c + 1) T // n)`` of the T tiles."""
    first, n = live_span(pos, S, window=window, layout=layout)
    n_tiles = -(-n // TILE)
    plan = []
    for c in range(n_splits):
        t0, t1 = c * n_tiles // n_splits, (c + 1) * n_tiles // n_splits
        plan.append([(first + j) % S for j in range(t0 * TILE, min(n, t1 * TILE))])
    return plan


def _smem_bytes(hd: int, G: int, dtype: torch.dtype) -> int:
    """The K and V stages (each row padded by one 16-byte chunk), their slot
    positions, the tile's scratch and, in bf16, Q's G rows and a zero row
    (``smem_need`` in the source)."""
    q_rows = G + 1 if dtype == torch.bfloat16 else 0
    return ((2 * STAGES * TILE + q_rows) * (hd + 16 // dtype.itemsize)
            * dtype.itemsize + STAGES * TILE * 4 + SCRATCH_BYTES)


@functools.lru_cache(maxsize=256)
def launch_spec(B: int, KV: int, G: int, S: int, hd: int,
                dtype: torch.dtype = torch.bfloat16) -> LaunchSpec:
    """The launch: grid (splits, KV, B) of 128-thread CTAs.  The splits are
    sized for the worst case, all S slots live: as many CTAs as stay
    resident at once on the card's 132 SMs (shared memory allows 3 a SM at
    hd 256 in bf16), at most one per 32-slot tile and at most 32 (more
    cost the merge, which reads 16 splits a round trip, more than they
    gain)."""
    smem = _smem_bytes(hd, G, dtype)
    per_sm = SM_SMEM // (smem + BLOCK_RESERVED)
    resident = SMS * max(1, min(MAX_BLOCKS_PER_SM, per_sm))
    n_tiles = -(-S // TILE)
    n_splits = max(1, min(MAX_SPLITS, n_tiles, resident // max(1, B * KV)))
    return LaunchSpec(grid=(n_splits, KV, B), block=(WARPS * 32, 1, 1),
                      smem_bytes=smem)


@functools.lru_cache(maxsize=256)
def coverage(B: int, KV: int, G: int, S: int, n_splits: int
             ) -> tuple[tuple[int, int, int], tuple[int, int, int]]:
    """What the grid must cover, per grid axis (x, y, z): the S slots of the
    largest span, the KV kv heads and the B batch rows; and what one CTA
    covers of them at most: its share of the span's 32-slot tiles of one
    (batch row, kv head).  All G heads of the kv group are in one CTA."""
    n_tiles = -(-S // TILE)
    return (S, KV, B), (-(-n_tiles // n_splits) * TILE, 1, 1)


# (device index, B, KV, G, hd, n_splits) -> (part_m, part_l, part_acc, counters)
_SCRATCH: dict[tuple, tuple[torch.Tensor, ...]] = {}


def _scratch(device: torch.device, B: int, KV: int, G: int, hd: int,
             n_splits: int) -> tuple[torch.Tensor, ...]:
    """The partials and merge counters of one shape on one device.  They
    are allocated once (the counters zeroed; the kernel leaves them at 0)
    and never freed or moved, so a CUDA graph that captured a call keeps
    valid pointers.  One stream at a time: two calls of one shape in flight
    on two streams would share them."""
    key = (device.index, B, KV, G, hd, n_splits)
    bufs = _SCRATCH.get(key)
    if bufs is None:
        rows = B * KV * G * n_splits
        f32 = dict(dtype=torch.float32, device=device)
        bufs = _SCRATCH.setdefault(key, (
            torch.empty(rows, **f32), torch.empty(rows, **f32),
            torch.empty((rows, hd), **f32),
            torch.zeros(B * KV, dtype=torch.int32, device=device)))
    return bufs


def decode_attention_cuda(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    slot_pos: torch.Tensor, pos: torch.Tensor, *, window: int | None,
    logit_cap: float | None, layout: str | None, spec: LaunchSpec,
) -> torch.Tensor:
    """Launch the kernel on the current stream; no checks, no synchronise.

    ``q`` is (B, KV, G, hd).  Callers go through
    :func:`repro_torch.kernels.gqa_decode_attention`, which checks shapes,
    types, devices, alignment and the launch's shared memory.  Allocates
    the output only; the scratch is kept per device and shape.
    """
    B, KV, G, hd = q.shape
    S = k_cache.shape[2]
    n_splits = spec.grid[0]
    out = torch.empty_like(q)
    part_m, part_l, part_acc, counters = _scratch(q.device, B, KV, G, hd, n_splits)
    lib = load("decode_attention", _SIGNATURES)
    fn = (lib.decode_attention_f32 if q.dtype == torch.float32
          else lib.decode_attention_bf16)
    args = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            slot_pos.data_ptr(), pos.data_ptr(), part_m.data_ptr(),
            part_l.data_ptr(), part_acc.data_ptr(), counters.data_ptr(),
            out.data_ptr(), B, KV, G, S, hd, n_splits, LAYOUTS[layout],
            hd ** -0.5, window or 0, logit_cap or 0.0, spec.smem_bytes)
    if q.device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(q.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
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
