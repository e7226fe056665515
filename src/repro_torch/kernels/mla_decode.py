"""``mla_decode``: absorbed multi-head latent attention for one decode token,
on Hopper: the CUDA kernel's launcher, its launch geometry and its plain
version.

The kernel (``csrc/mla_decode.cu``) replaces no TPU kernel: the reference
package has no latent attention.  It was added because absorbed MLA decode
is attention of a shape the GQA decode kernel does not take: H <= 16 query
heads over one latent "kv head" whose rows are D = R + dr wide (576 for
DeepSeek-V2-Lite), scores taken over all D columns and values the first
``v_dim`` = R columns of the same rows.  q (B, H, D) and the latent cache
(B, S, D) in bf16; slots 0 .. ``pos`` are seen (a full cache; ``pos`` a
0-dim int32 on the device); fp32 softmax; the output (B, H, v_dim) is rounded
once.  It is one launch a call: one persistent CTA a SM walks an equal run
of the flattened (batch row, 32-slot tile) work, a producer warp keeping a
ring of TMA copies in flight, and the last CTA of a batch row merges its
segments' partials (the source says why).

:func:`launch_spec` sizes the grid and the ring; :func:`split_plan` and
:func:`merge_plan` are the Python copy of the tiles each CTA reads and of
the partials each batch row merges, so the CPU tests can hold them to the
mask.  :func:`mla_decode_torch` is the plain PyTorch version: what the CPU
path runs and what the kernel is held to on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import MAX_SMEM_BYTES, LaunchSpec, check, launch, load, scratch

__all__ = ["launch_spec", "merge_plan", "mla_decode_cuda", "mla_decode_torch",
           "split_plan"]

CONSUMER_WARPS = 4  # one warpgroup reduces; one more warp issues the copies
TILE = 32           # latent rows a ring stage
BOX = 64            # columns a TMA box (128 bytes, the swizzle's span)
MIN_STAGES = 3
MAX_STAGES = 8
MAX_H = 16          # query heads: the rows of the mma tile
MAX_D = 576         # the latent row's width the kernel takes at most
MAX_V = 512         # the value columns at most
MAX_SPLITS = 32     # CTAs a batch row at most (so at most 33 segments a row)
SMS = 132
#: past the ring: partial scores (4 warps x 16 x 32 fp32), probabilities in
#: two bf16 parts (2 x 16 x 40), rescale factors (16 fp32), 2 x 8 + 1
#: mbarriers and a flag
FIXED_BYTES = (CONSUMER_WARPS * MAX_H * 32 * 4 + 2 * MAX_H * 40 * 2 + MAX_H * 4
               + (2 * MAX_STAGES + 1) * 8 + 8)
_NEG = -1e30

_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float]
         + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_SIGNATURES = {"mla_decode_bf16": _ARGS}


def _stage_bytes(D: int) -> int:
    """One ring stage: the TMA boxes of 64 columns x 32 rows (4 KB each)
    that cover a latent row's D columns."""
    return -(-D // BOX) * TILE * BOX * 2


def stages(D: int) -> int:
    """Ring stages at width D: as many as fit a block's shared memory beside
    the fixed part, at most 8 (6 at D 576).  The kernel counts them again
    from where its shared memory starts: one fewer if that is not on a
    1,024-byte boundary."""
    return min(MAX_STAGES, (MAX_SMEM_BYTES - FIXED_BYTES) // _stage_bytes(D))


@functools.lru_cache(maxsize=256)
def launch_spec(B: int, S: int, D: int) -> LaunchSpec:
    """One 160-thread CTA a SM (its ring fills the SM's shared memory), as
    many as the card has SMs, at most 32 a batch row and one a 32-slot tile
    of the worst case (all S slots live).  The split itself is decided on
    the device from ``pos`` (:func:`split_plan`)."""
    n_tiles = -(-S // TILE)
    ctas = max(1, min(SMS, B * min(MAX_SPLITS, n_tiles)))
    smem = stages(D) * _stage_bytes(D) + FIXED_BYTES
    return LaunchSpec(grid=(ctas, 1, 1), block=((CONSUMER_WARPS + 1) * 32, 1, 1),
                      smem_bytes=smem)


def _work(pos: int, B: int, S: int, n_ctas: int) -> tuple[int, int, int, int]:
    """(live slots n, tiles a batch row T, tiles in all W, working CTAs G)."""
    n = max(min(pos, S - 1) + 1, 0)
    T = -(-n // TILE)
    W = B * T
    return n, T, W, min(n_ctas, W)


def split_plan(pos: int, B: int, S: int, n_ctas: int) -> list[list[tuple[int, int, int]]]:
    """Each CTA's segments at ``pos``: (batch row, first slot, end slot).
    Slots 0 .. min(pos, S - 1) of every batch row in tiles of 32, the B x T
    tiles flattened row by row; of G = min(n_ctas, B T) working CTAs, CTA c
    takes flattened tiles [c W // G, (c + 1) W // G), cut where a batch row
    ends; CTAs from G on take none."""
    n, T, W, G = _work(pos, B, S, n_ctas)
    plan: list[list[tuple[int, int, int]]] = []
    for c in range(n_ctas):
        segs = []
        f, end = (c * W // G, (c + 1) * W // G) if c < G else (0, 0)
        while f < end:
            b = f // T
            stop = min(end, (b + 1) * T)
            segs.append((b, (f - b * T) * TILE, min(n, (stop - b * T) * TILE)))
            f = stop
        plan.append(segs)
    return plan


def merge_plan(pos: int, B: int, S: int, n_ctas: int) -> list[range]:
    """The partial slots each batch row merges, in segment order: CTA c's
    segment of row b writes slot b + c, and row b's CTAs run from the one
    holding its first tile to the one holding its last (``cta_of`` in the
    source).  Empty where no slot is live."""
    n, T, W, G = _work(pos, B, S, n_ctas)
    if W == 0:
        return [range(0) for _ in range(B)]

    def cta_of(f: int) -> int:
        return ((f + 1) * G - 1) // W

    return [range(b + cta_of(b * T), b + cta_of((b + 1) * T - 1) + 1) for b in range(B)]


def mla_decode_cuda(q: torch.Tensor, latent: torch.Tensor, pos: torch.Tensor, *,
                    scale: float, v_dim: int, spec: LaunchSpec) -> torch.Tensor:
    """Launch the kernel on the current stream; no checks, no synchronise.
    Callers go through :func:`repro_torch.kernels.mla_decode_attention`."""
    B, H, D = q.shape
    S = latent.shape[1]
    n_ctas = spec.grid[0]
    out = torch.empty((B, H, v_dim), dtype=q.dtype, device=q.device)
    # B + n_ctas partial slots (:func:`merge_plan`) of H heads, a counter a
    # batch row
    part_m, part_l, part_acc, counters = scratch(
        q.device, ("mla_decode", B, H, v_dim, n_ctas), (B + n_ctas) * H, v_dim, B)
    fn = load("mla_decode", _SIGNATURES).mla_decode_bf16
    args = (q.data_ptr(), latent.data_ptr(), pos.data_ptr(), part_m.data_ptr(),
            part_l.data_ptr(), part_acc.data_ptr(), counters.data_ptr(), out.data_ptr(),
            B, H, S, D, v_dim, scale, n_ctas, spec.smem_bytes)
    check(launch(fn, args, q.device), "mla_decode")
    return out


def mla_decode_torch(q: torch.Tensor, latent: torch.Tensor, pos: torch.Tensor, *,
                     scale: float, v_dim: int) -> torch.Tensor:
    """Plain version: q (B, H, D) against every slot of latent (B, S, D),
    slots past ``pos`` masked (probability 0), softmax and the mixture of
    the first ``v_dim`` columns, in fp32, rounded once at the end."""
    s = torch.einsum("bhd,bsd->bhs", q.float(), latent.float()) * scale
    ok = torch.arange(latent.shape[1], device=q.device) <= pos
    s = s.masked_fill(~ok, _NEG)
    p = torch.where(ok, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    w = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhs,bsv->bhv", w, latent[..., :v_dim].float()).to(q.dtype)
