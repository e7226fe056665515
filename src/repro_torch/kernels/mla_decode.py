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
once.  It is one launch a call: CTAs share the live span, and the last CTA
of a batch row merges their partials (the source says why).

:func:`launch_spec` sizes the split; :func:`split_plan` is the Python copy
of the slots each CTA reads, so the CPU tests can hold it to the mask.
:func:`mla_decode_torch` is the plain PyTorch version: what the CPU path
runs and what the kernel is held to on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import LaunchSpec, check, launch, load

__all__ = ["launch_spec", "mla_decode_cuda", "mla_decode_torch", "split_plan"]

WARPS = 4
TILE = 32           # latent rows per shared-memory stage
STAGES = 2
MAX_H = 16          # query heads: the rows of the mma tile
MAX_D = 576         # the latent row's width the kernel takes at most
MAX_V = 512         # the value columns at most
MAX_SPLITS = 32
SMS = 132
SM_SMEM = 233_472
BLOCK_RESERVED = 1024
#: scores (16 x 32 fp32), probabilities in two bf16 parts (2 x 16 x 40) and
#: rescale factors (16 fp32)
SCRATCH_BYTES = 16 * TILE * 4 + 2 * 16 * 40 * 2 + 16 * 4
_NEG = -1e30

_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float]
         + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_SIGNATURES = {"mla_decode_bf16": _ARGS}


def _smem_bytes(D: int) -> int:
    """The stages of 32 latent rows and 16 rows of q (zeros past H), each
    padded by one 16-byte chunk, and the tile's scratch (``smem_need`` in
    the source)."""
    return (STAGES * TILE + MAX_H) * (D + 8) * 2 + SCRATCH_BYTES


@functools.lru_cache(maxsize=256)
def launch_spec(B: int, S: int, D: int) -> LaunchSpec:
    """Grid (splits, B) of 128-thread CTAs, sized for the worst case (all S
    slots live): as many CTAs as stay resident on the card's 132 SMs at once
    (two a SM at D 576), at most one per 32-slot tile and at most 32."""
    smem = _smem_bytes(D)
    resident = SMS * max(1, SM_SMEM // (smem + BLOCK_RESERVED))
    n_tiles = -(-S // TILE)
    n_splits = max(1, min(MAX_SPLITS, n_tiles, resident // max(1, B)))
    return LaunchSpec(grid=(n_splits, B, 1), block=(WARPS * 32, 1, 1), smem_bytes=smem)


def split_plan(pos: int, S: int, n_splits: int) -> list[list[int]]:
    """The slots each CTA of one batch row reads at ``pos``: slots 0 ..
    min(pos, S - 1) in tiles of 32, CTA c taking tiles [c T // n, (c + 1) T
    // n) of the T tiles."""
    n = max(min(pos, S - 1) + 1, 0)
    n_tiles = -(-n // TILE)
    return [list(range(c * n_tiles // n_splits * TILE,
                       min(n, (c + 1) * n_tiles // n_splits * TILE)))
            for c in range(n_splits)]


# (device index, B, H, v_dim, n_splits) -> (part_m, part_l, part_acc, counters)
_SCRATCH: dict[tuple, tuple[torch.Tensor, ...]] = {}


def _scratch(device: torch.device, B: int, H: int, v_dim: int, n_splits: int):
    """The partials and merge counters of one shape on one device, made once
    and never freed or moved (a captured call keeps its pointers); the
    counters start at 0 and the kernel leaves them at 0."""
    key = (device.index, B, H, v_dim, n_splits)
    bufs = _SCRATCH.get(key)
    if bufs is None:
        rows = B * H * n_splits
        f32 = dict(dtype=torch.float32, device=device)
        bufs = _SCRATCH.setdefault(key, (
            torch.empty(rows, **f32), torch.empty(rows, **f32),
            torch.empty((rows, v_dim), **f32),
            torch.zeros(B, dtype=torch.int32, device=device)))
    return bufs


def mla_decode_cuda(q: torch.Tensor, latent: torch.Tensor, pos: torch.Tensor, *,
                    scale: float, v_dim: int, spec: LaunchSpec) -> torch.Tensor:
    """Launch the kernel on the current stream; no checks, no synchronise.
    Callers go through :func:`repro_torch.kernels.mla_decode_attention`."""
    B, H, D = q.shape
    S = latent.shape[1]
    n_splits = spec.grid[0]
    out = torch.empty((B, H, v_dim), dtype=q.dtype, device=q.device)
    part_m, part_l, part_acc, counters = _scratch(q.device, B, H, v_dim, n_splits)
    fn = load("mla_decode", _SIGNATURES).mla_decode_bf16
    args = (q.data_ptr(), latent.data_ptr(), pos.data_ptr(), part_m.data_ptr(),
            part_l.data_ptr(), part_acc.data_ptr(), counters.data_ptr(), out.data_ptr(),
            B, H, S, D, v_dim, scale, n_splits, spec.smem_bytes)
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
