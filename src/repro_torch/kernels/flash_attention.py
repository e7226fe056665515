"""``flash_attention`` on Hopper: the CUDA kernels' launchers, their launch
geometry and tile plan, and their plain version.

Two kernels replace the reference package's Pallas kernel
``repro/kernels/flash_attention.py::flash_attention_kernel`` (blocked
online-softmax GQA attention with causal, sliding-window, softcap,
``q_offset`` and ``k_len`` masks, m, l and acc in fp32), one per input type:

* ``bf16_wgmma`` (``csrc/flash_attention_wgmma.cu``) serves bf16: both
  products on the tensor cores with ``wgmma``, K/V tiles of 64 keys fed by
  TMA into a ring of shared-memory stages by a producer warp, two consumer
  warpgroups of 64 rows each;
* ``f32_3xtf32`` (``csrc/flash_attention.cu``) serves fp32: both products
  on the tensor cores as split TF32 (each operand a TF32 big part plus a
  TF32 small part, three ``mma.sync`` products each, fp32 accuracy), K/V
  tiles of 64 keys (32 above hd 128) loaded by ``cp.async`` into two
  stages, 8 warps a CTA, each owning 16 rows (above hd 128 a pair of warps
  shares them).

Each source says what bounds it and what its design does about that.  Both
take the head dim as it is (a multiple of 8 up to 256) and any sequence
length: no lane padding of hd to 128 and no padding of the sequence to a
block multiple, which were the TPU's needs.  The fp32 kernel zero-fills
the ragged edge through ``cp.async``, the bf16 kernel pads hd to 64, 128 or
256 in shared memory through TMA's zero fill; both store only what exists.

:func:`tile_plan` mirrors in Python what the bf16 kernel does for each
M-tile (a warpgroup's 64 rows): its kv range, the kv tiles it computes and
which of them need the per-element mask, so the CPU tests can hold that
logic to the masks.  It is a copy; the kernel's own decisions are checked
on the card only, through its output.

:func:`flash_attention_torch` is the plain PyTorch version of the same
function.  It materialises the scores, as the reference's oracle
``repro/kernels/ref.py::flash_attention_ref`` does.  The CPU path of
:func:`repro_torch.kernels.flash_attention` and the tests use it; on the
card it is the yardstick both kernels are held to.

:func:`chunked_forward` and :func:`chunked_backward` are the same function
over chunks of keys, with the softmax statistics m and l: the ``"torch"``
attention impl's forward, and the one backward both differentiable forms
use (the kernel's under :func:`repro_torch.kernels.flash_attention`, and
:func:`repro_torch.models.attention.flash_attention_chunked`).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ._build import MAX_SMEM_BYTES, LaunchSpec, check, load

__all__ = ["VARIANTS", "CtaPlan", "MTilePlan", "chunked_backward",
           "chunked_forward", "coverage", "f32_row_strides", "f32_tile",
           "flash_attention_cuda",
           "flash_attention_torch", "heads_per_tile", "launch_spec",
           "padded_head_dim", "tile_plan", "wgmma_stages"]

#: the kernel that serves each input dtype
VARIANTS = {torch.float32: "f32_3xtf32", torch.bfloat16: "bf16_wgmma"}

# the fp32 kernel (csrc/flash_attention.cu)
WARP_ROWS = 16     # (query row, head) pairs per group of warps: one mma M tile
F32_WARPS = 8
F32_STAGES = 2     # K/V stages of its cp.async double buffer

# the bf16 kernel (csrc/flash_attention_wgmma.cu)
WG_ROWS = 64       # rows per consumer warpgroup: one wgmma M tile
CONSUMERS = 2      # consumer warpgroups per CTA
WG_THREADS = (CONSUMERS + 1) * 128
BLOCK_N = 64       # keys per K/V tile
BOX_BYTES = 64 * 128   # one TMA box: 64 rows (or keys) x 64 head dims of bf16
MAX_STAGES = 4
_ALIGN_SLACK, _BARRIER_BYTES = 1024, 128

_NEG = -1e30

_F32_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float]
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_WGMMA_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
               + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float]
               + [ctypes.c_int] * 8 + [ctypes.c_void_p])
_SOURCES = {"f32_3xtf32": ("flash_attention", "flash_attention_f32", _F32_ARGS),
            "bf16_wgmma": ("flash_attention_wgmma", "flash_attention_bf16_wgmma",
                           _WGMMA_ARGS)}


def f32_tile(hd: int) -> tuple[int, int, int, int]:
    """The fp32 kernel's CTA at head dim ``hd``: (warps, warps that share
    16 rows, rows, keys per K/V tile).  8 warps of 16 rows each and tiles of
    64 keys up to hd 128; above, where 128 rows of q would not fit beside
    two K/V stages, pairs of warps share 16 rows (64 a CTA), each taking
    half a tile's 32 keys in S and half the head dims in P V."""
    split, keys = (1, 64) if hd <= 128 else (2, 32)
    return F32_WARPS, split, F32_WARPS * WARP_ROWS // split, keys


def f32_row_strides(hd: int) -> tuple[int, int]:
    """The fp32 kernel's shared-memory row strides in floats, (q and K,
    V): padded so that no fragment load meets a bank conflict.  V rows hold
    the head dims of the kernel instance that serves ``hd`` (32, 64, 128 or
    256), zero past hd."""
    inst = 32 if hd <= 32 else 64 if hd <= 64 else 128 if hd <= 128 else 256
    return (hd + 8 if hd % 16 == 0 else hd), inst + 4


def heads_per_tile(H: int, KV: int) -> int:
    """Heads of one kv group that share a warpgroup's 64 rows in the bf16
    kernel: all G = H / KV where G divides 64, else one."""
    G = H // KV
    return G if WG_ROWS % G == 0 else 1


def padded_head_dim(hd: int) -> int:
    """The bf16 kernel's head dim in shared memory: 64, 128 or 256."""
    return 64 if hd <= 64 else 128 if hd <= 128 else 256


def wgmma_stages(hd: int) -> int:
    """K/V stages of the bf16 kernel's ring: as many as fit beside the q
    tile in a block's shared memory, at most 4 (2 at hd 256)."""
    boxes = padded_head_dim(hd) // 64
    q_bytes = CONSUMERS * boxes * BOX_BYTES
    free = MAX_SMEM_BYTES - _ALIGN_SLACK - _BARRIER_BYTES - q_bytes
    return max(1, min(MAX_STAGES, free // (2 * boxes * BOX_BYTES)))


def launch_spec(B: int, H: int, KV: int, Sq: int, hd: int,
                dtype: torch.dtype) -> LaunchSpec:
    """The launch of the kernel that serves ``dtype``.

    fp32: one CTA of :func:`f32_tile`'s 8 warps per run of (query row,
    head) pairs of one (batch, kv head); its q rows and two stages of a K
    and a V tile in fp32 shared memory, rows padded as
    :func:`f32_row_strides` says, and where two warps share rows, each
    group's P (16 rows x (keys + 8)) and a row statistic per warp.

    bf16: grid (H / gh, B, M tiles) of 384-thread CTAs, where gh is
    :func:`heads_per_tile` and a CTA takes 2 x 64 / gh queries of gh heads;
    shared memory holds 1 KB of alignment slack, the q tile (128 rows of the
    padded hd), the stages of K and V tiles (64 keys each) and 128 bytes of
    barriers.
    """
    if dtype == torch.float32:
        G = H // KV
        warps, split, rows, keys = f32_tile(hd)
        ldq, ldv = f32_row_strides(hd)
        exchange = 0 if split == 1 else rows * (keys + 8 + split)
        return LaunchSpec(
            grid=(-(-Sq * G // rows), KV, B), block=(32 * warps, 1, 1),
            smem_bytes=(rows * ldq + F32_STAGES * keys * (ldq + ldv) + exchange) * 4)
    if dtype != torch.bfloat16:
        raise TypeError(f"flash_attention has no kernel for {dtype}")
    gh = heads_per_tile(H, KV)
    per_cta = CONSUMERS * WG_ROWS // gh
    boxes = padded_head_dim(hd) // 64
    smem = (_ALIGN_SLACK + CONSUMERS * boxes * BOX_BYTES
            + wgmma_stages(hd) * 2 * boxes * BOX_BYTES + _BARRIER_BYTES)
    return LaunchSpec(grid=(H // gh, B, -(-Sq // per_cta)),
                      block=(WG_THREADS, 1, 1), smem_bytes=smem)


def coverage(B: int, H: int, KV: int, Sq: int, dtype: torch.dtype, hd: int
             ) -> tuple[tuple[int, int, int], tuple[int, int, int]]:
    """What the grid must cover, per grid axis (x, y, z), and what one CTA
    covers of it.  fp32: the Sq * G (query row, head) pairs of a kv group,
    the KV kv heads and the B batch rows; :func:`f32_tile`'s rows of pairs
    of one (batch, kv head).
    bf16: the H heads, the B batch rows and the Sq queries; gh heads of one
    batch row and 2 x 64 / gh queries.  Both kernels mask what lies past."""
    if dtype == torch.float32:
        return (Sq * (H // KV), KV, B), (f32_tile(hd)[2], 1, 1)
    gh = heads_per_tile(H, KV)
    return (H, B, Sq), (gh, 1, CONSUMERS * WG_ROWS // gh)


@dataclass(frozen=True)
class MTilePlan:
    """One consumer warpgroup's rows: queries ``[q_lo, q_hi)`` of gh heads,
    and the kv tiles it computes as ``(first key, masked)``; the others of
    its CTA it waits for and releases unread."""

    q_lo: int
    q_hi: int
    tiles: tuple[tuple[int, bool], ...]


@dataclass(frozen=True)
class CtaPlan:
    """One CTA along the grid's z axis: its kv range ``[kbeg, kend)``, the
    ``n_tiles`` tiles of ``BLOCK_N`` keys from ``kbeg`` that its producer
    loads, and its warpgroups' M-tiles (those with rows)."""

    kbeg: int
    kend: int
    n_tiles: int
    mtiles: tuple[MTilePlan, ...]


def tile_plan(H: int, KV: int, Sq: int, *, causal: bool, window: int | None,
              q_offset: int, k_len: int) -> list[CtaPlan]:
    """What the bf16 kernel computes, CTA by CTA along the grid's z axis
    (the kernel launches them in reverse, longest kv range first).

    Query q sees keys ``[lo(q), hi(q))``; both bounds are non-decreasing in
    q, so the keys a run of queries sees are ``[lo(first), hi(last))`` and
    the keys all of them see ``[lo(last), hi(first))``.  A warpgroup
    computes a tile that overlaps the first range and masks it per element
    unless it lies inside the second.  It mirrors the decisions that
    ``flash_attention_wgmma.cu`` makes on the card, as a second copy: the
    CPU tests check this copy against the masks, and the kernel's own copy
    is checked only by holding its output to the plain version on the card
    (``chip_smoke.py``, phase 7).
    """
    w = window or 0

    def lo(q):
        return max(0, q_offset + q - w + 1) if w > 0 else 0

    def hi(q):
        return min(k_len, q_offset + q + 1) if causal else k_len

    qm = WG_ROWS // heads_per_tile(H, KV)
    plans = []
    for q0 in range(0, Sq, CONSUMERS * qm):
        kbeg, kend = lo(q0), hi(min(q0 + CONSUMERS * qm, Sq) - 1)
        n_tiles = -(-(kend - kbeg) // BLOCK_N) if kend > kbeg else 0
        mtiles = []
        for qw0 in range(q0, min(q0 + CONSUMERS * qm, Sq), qm):
            last = min(qw0 + qm, Sq) - 1
            tiles = []
            for t in range(n_tiles):
                key0 = kbeg + t * BLOCK_N
                if key0 < hi(last) and key0 + BLOCK_N > lo(qw0):
                    inside = key0 >= lo(last) and key0 + BLOCK_N <= hi(qw0)
                    tiles.append((key0, not inside))
            mtiles.append(MTilePlan(qw0, last + 1, tuple(tiles)))
        plans.append(CtaPlan(kbeg, kend, n_tiles, tuple(mtiles)))
    return plans


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
    window: int | None, logit_cap: float | None, q_offset: int, k_len: int,
    spec: LaunchSpec,
) -> torch.Tensor:
    """Launch the kernel for q's dtype on the current stream; no checks, no
    synchronise.

    Callers go through :func:`repro_torch.kernels.flash_attention`, which
    checks shapes, types, alignment, devices and the launch's shared memory.
    """
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    source, fn_name, argtypes = _SOURCES[VARIANTS[q.dtype]]
    fn = getattr(load(source, {fn_name: argtypes}), fn_name)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, KV, Sq, Sk, hd, hd ** -0.5, int(causal), window or 0,
            logit_cap or 0.0, q_offset, k_len]
    if q.dtype == torch.bfloat16:
        args += [*spec.grid, heads_per_tile(H, KV), wgmma_stages(hd)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, spec.smem_bytes, stream)
    check(err, f"flash_attention ({VARIANTS[q.dtype]})")
    return out


def flash_attention_torch(
    q: torch.Tensor,            # (B, H, Sq, hd)
    k: torch.Tensor,            # (B, KV, Sk, hd)
    v: torch.Tensor,            # (B, KV, Sk, hd)
    *,
    causal: bool = True,
    window: int | None = None,
    logit_cap: float | None = None,
    q_offset: int = 0,
    k_len: int | None = None,
) -> torch.Tensor:
    """Plain version: scores (B, KV, G, Sq, Sk), masked, softmax, P.V, all
    in fp32 from inputs cast to fp32 and rounded once at the end, as the
    kernel (and the reference's Pallas kernel) computes them.

    Masked keys get probability 0, as in the kernel, so a row with no
    visible key is 0; a row with one is the reference's softmax.
    """
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, KV, H // KV, Sq, hd)
    s = torch.einsum("bngqh,bnch->bngqc", qg, k.float()) * hd ** -0.5
    if logit_cap is not None:
        s = logit_cap * torch.tanh(s / logit_cap)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    if k_len is not None:
        ok &= k_pos[None, :] < k_len
    s = s.masked_fill(~ok, _NEG)
    p = torch.where(ok, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    w = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bngqc,bnch->bngqh", w, v.float())
    return out.reshape(B, H, Sq, hd).to(q.dtype)


def _visible(q_pos, k_pos, *, causal: bool, window: int | None, k_len: int):
    """(Sq, C) bool: the keys each query sees."""
    ok = k_pos[None, :] < k_len
    if causal:
        ok = ok & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        ok = ok & (k_pos[None, :] > q_pos[:, None] - window)
    return ok


def _kv_chunks(k, v, chunk: int):
    """(first key, k chunk, v chunk) over Sk, the last chunk zero-padded to
    ``chunk`` keys (the reference pads; the ``k_len`` mask hides the
    padding)."""
    Sk = k.shape[2]
    for start in range(0, Sk, chunk):
        kc, vc = k[:, :, start:start + chunk], v[:, :, start:start + chunk]
        if kc.shape[2] < chunk:
            pad = chunk - kc.shape[2]
            kc = torch.nn.functional.pad(kc, (0, 0, 0, pad))
            vc = torch.nn.functional.pad(vc, (0, 0, 0, pad))
        yield start, kc, vc


def chunked_forward(q, k, v, *, causal: bool = True, window: int | None = None,
                    logit_cap: float | None = None, q_offset: int = 0,
                    k_len: int | None = None, chunk: int = 1024):
    """Online-softmax attention over KV chunks of ``chunk`` keys, in fp32
    from inputs cast to fp32: (out (B, H, Sq, hd) in fp32, m, l (B, KV, G,
    Sq) in fp32), the reference's ``chunked_attention`` and its
    ``_flash_fwd_stats``.  O(Sq * chunk) temporaries.  A row with no
    visible key averages v, as the reference's chunked form does."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    k_len = Sk if k_len is None else k_len
    scale = hd ** -0.5
    chunk = min(chunk, Sk)
    qg = q.float().reshape(B, KV, G, Sq, hd)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full((B, KV, G, Sq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32, device=q.device)
    for start, kc, vc in _kv_chunks(k.float(), v.float(), chunk):
        k_pos = start + torch.arange(chunk, device=q.device)
        s = torch.einsum("bngqh,bnch->bngqc", qg, kc) * scale
        if logit_cap is not None:
            s = logit_cap * torch.tanh(s / logit_cap)
        ok = _visible(q_pos, k_pos, causal=causal, window=window, k_len=k_len)
        s = s + torch.where(ok, 0.0, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bngqc,bnch->bngqh", p, vc)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, Sq, hd), m, l


def chunked_backward(q, k, v, out, m, l, dout, *, causal: bool = True,
                     window: int | None = None, logit_cap: float | None = None,
                     q_offset: int = 0, k_len: int | None = None,
                     chunk: int = 1024):
    """(dq, dk, dv) of attention at (q, k, v), in the inputs' dtypes, from
    its output and softmax statistics (:func:`chunked_forward`'s): each
    chunk's probabilities are recomputed from m and l instead of saved, the
    standard flash-attention backward (the reference's ``_flashx_bwd``),
    all in fp32.  A key a query does not see gets probability 0, so a row
    with no visible key passes no gradient, as the kernel's output there
    is 0."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    k_len = Sk if k_len is None else k_len
    scale = hd ** -0.5
    chunk = min(chunk, Sk)
    qg = q.float().reshape(B, KV, G, Sq, hd)
    dog = dout.float().reshape(B, KV, G, Sq, hd)
    delta = (dog * out.float().reshape(B, KV, G, Sq, hd)).sum(dim=-1)
    l_safe = l.clamp_min(1e-30)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    dq = torch.zeros_like(qg)
    dk, dv = [], []
    for start, kc, vc in _kv_chunks(k.float(), v.float(), chunk):
        k_pos = start + torch.arange(chunk, device=q.device)
        s = torch.einsum("bngqh,bnch->bngqc", qg, kc) * scale
        if logit_cap is not None:
            t = torch.tanh(s / logit_cap)
            s = logit_cap * t
        ok = _visible(q_pos, k_pos, causal=causal, window=window, k_len=k_len)
        p = torch.where(ok, torch.exp(s - m[..., None]) / l_safe[..., None], 0.0)
        dv.append(torch.einsum("bngqc,bngqh->bnch", p, dog))
        ds = p * (torch.einsum("bngqh,bnch->bngqc", dog, vc) - delta[..., None])
        if logit_cap is not None:
            ds = ds * (1.0 - t * t)                         # through tanh
        ds = ds * scale
        dq = dq + torch.einsum("bngqc,bnch->bngqh", ds, kc)
        dk.append(torch.einsum("bngqc,bngqh->bnch", ds, qg))
    dk = torch.cat(dk, dim=2)[:, :, :Sk]
    dv = torch.cat(dv, dim=2)[:, :, :Sk]
    return dq.reshape(B, H, Sq, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
