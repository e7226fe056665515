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

:func:`chunked_forward` is the same function over chunks of keys with an
online softmax: the ``"torch"`` attention impl's forward.
:func:`chunked_backward` is its gradient in blocks of query rows, each over
only the keys its rows see, with no forward recomputed: the one backward
both differentiable forms use (the kernel's under
:func:`repro_torch.kernels.flash_attention`, and
:func:`repro_torch.models.attention.flash_attention_chunked`).
"""

from __future__ import annotations

import bisect
import ctypes
from dataclasses import dataclass

import torch

from repro_torch.obs import current as _obs_current

from ._build import MAX_SMEM_BYTES, LaunchSpec, check, load

__all__ = ["BWD_MAX_ROWS", "BWD_TILE_BYTES", "VARIANTS", "CtaPlan", "MTilePlan",
           "bwd_block_rows", "chunked_backward",
           "chunked_forward", "coverage", "f32_row_strides", "f32_tile",
           "flash_attention_cuda",
           "flash_attention_torch", "heads_per_tile", "key_bounds", "launch_spec",
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


def key_bounds(*, causal: bool, window: int | None, q_offset: int, k_len: int):
    """(lo, hi): query row i sees keys ``[lo(i), hi(i))``, both bounds
    non-decreasing in i, so the keys a run of rows sees are ``[lo(first),
    hi(last))`` and the keys all of them see ``[lo(last), hi(first))``."""
    w = window or 0

    def lo(i):
        return max(0, q_offset + i - w + 1) if w > 0 else 0

    def hi(i):
        return min(k_len, q_offset + i + 1) if causal else k_len

    return lo, hi


def tile_plan(H: int, KV: int, Sq: int, *, causal: bool, window: int | None,
              q_offset: int, k_len: int) -> list[CtaPlan]:
    """What the bf16 kernel computes, CTA by CTA along the grid's z axis
    (the kernel launches them in reverse, longest kv range first).

    Query q sees keys ``[lo(q), hi(q))`` (:func:`key_bounds`).  A warpgroup
    computes a tile that overlaps the first range and masks it per element
    unless it lies inside the second.  It mirrors the decisions that
    ``flash_attention_wgmma.cu`` makes on the card, as a second copy: the
    CPU tests check this copy against the masks, and the kernel's own copy
    is checked only by holding its output to the plain version on the card
    (``chip_smoke.py``, phase 7).
    """
    lo, hi = key_bounds(causal=causal, window=window, q_offset=q_offset,
                        k_len=k_len)
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
    from inputs cast to fp32: out (B, H, Sq, hd) in fp32, the reference's
    ``chunked_attention``.  O(Sq * chunk) temporaries.  A row with no
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
    return out.reshape(B, H, Sq, hd)


#: the byte budget of one query block's fp32 score tile in
#: :func:`chunked_backward`, which holds two such tiles at a time (three
#: with a softcap)
BWD_TILE_BYTES = 1 << 29
#: the most query rows a block takes: a causal block computes a band of
#: masked keys as wide as itself, so smaller blocks skip more of the masked
#: triangle, for more launches (~17 a block).  At B 4, H 32, causal S 2,048,
#: hd 64, bf16 inputs, on an H100 at 700 W, one call takes 10.73 ms in
#: blocks of 256, 10.87-10.97 in blocks of 192, 11.30 in 128, 11.16 in 384,
#: 11.46 in 512 and 13.78 in 1,024.
BWD_MAX_ROWS = 256


def bwd_block_rows(B: int, H: int, n_keys: int) -> int:
    """Query rows of one block of :func:`chunked_backward`: as many as keep
    its fp32 scores (B, H, rows, n_keys) within :data:`BWD_TILE_BYTES`,
    between 16 and :data:`BWD_MAX_ROWS`."""
    return max(16, min(BWD_MAX_ROWS, BWD_TILE_BYTES // (4 * B * H * max(1, n_keys))))


def _scaled_bmm(a, b, alpha: float):
    """``alpha * a @ b`` in one batched product (beta 0: the uninitialised
    input is not read)."""
    out = a.new_empty((a.shape[0], a.shape[1], b.shape[2]))
    return out.baddbmm_(a, b, beta=0.0, alpha=alpha)


def chunked_backward(q, k, v, dout, *, causal: bool = True,
                     window: int | None = None, logit_cap: float | None = None,
                     q_offset: int = 0, k_len: int | None = None,
                     block: int | None = None):
    """(dq, dk, dv) of attention at (q, k, v) for the output's gradient
    ``dout``: the gradients of :func:`flash_attention_torch`, in fp32 from
    inputs cast to fp32, each rounded once to its input's dtype.

    Queries go in blocks of ``block`` rows (default :func:`bwd_block_rows`
    at ``k_len`` keys).  A block makes one pass over the keys some row of
    it sees, ``[lo(first), hi(last))`` (:func:`key_bounds`): its scores in
    one product, scaled in it; their softmax over that range, which holds
    every key the rows see, so no m and l are carried and no forward is
    recomputed; then ``dV += p^T dO``, ``dP = dO V^T``, ``delta`` = the row
    sums of p * dP (the row sums of dO * O, as the block holds whole rows),
    ``dS = p * (dP - delta)`` (times ``1 - t^2`` through a softcap's tanh),
    ``dQ = scale dS K`` and ``dK += scale dS^T Q``.  Only the columns that
    some row of the block does not see are masked per element (under
    causal, the diagonal band); keys no row of the block sees are not
    computed.  A row with no visible key passes no gradient, as the
    kernel's output there is 0.  The G heads of a kv group share the
    block's K and V.  Under ``observe()`` the registry counts the score
    elements computed and skipped (of B * H * Sq * Sk):
    ``flash_attention.bwd_scores_computed`` and ``..._skipped``.
    """
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    k_len = Sk if k_len is None else k_len
    scale = hd ** -0.5
    lo, hi = key_bounds(causal=causal, window=window, q_offset=q_offset,
                        k_len=k_len)
    # lo(i) <= q_offset + i, so row i sees no key only where lo(i) >= k_len:
    # those rows are a suffix, and the rows before it each see a key
    seen = bisect.bisect_left(range(Sq), True, key=lambda i: lo(i) >= hi(i))
    rows = block or bwd_block_rows(B, H, k_len)
    qg = q.float().reshape(B, KV, G, Sq, hd)
    dog = dout.float().reshape(B, KV, G, Sq, hd)
    k3 = k.float().reshape(B * KV, Sk, hd)
    v3 = v.float().reshape(B * KV, Sk, hd)
    dq = torch.zeros_like(qg)
    dk = torch.zeros_like(k3)
    dv = torch.zeros_like(v3)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    computed = 0
    for r0 in range(0, seen, rows):
        r1 = min(r0 + rows, seen)
        m = r1 - r0
        kbeg, kend = lo(r0), hi(r1 - 1)
        qb = qg[:, :, :, r0:r1].reshape(B * KV, G * m, hd)
        dob = dog[:, :, :, r0:r1].reshape(B * KV, G * m, hd)
        kb, vb = k3[:, kbeg:kend], v3[:, kbeg:kend]
        s = _scaled_bmm(qb, kb.mT, scale)                    # (B KV, G m, n)
        if logit_cap is not None:
            t = s.div_(logit_cap).tanh_()
            s = t * logit_cap
        # every row sees [lo(r1 - 1), hi(r0)); mask the columns outside it
        a = min(max(lo(r1 - 1), kbeg), kend)
        b = min(max(hi(r0), a), kend)
        s4 = s.view(B * KV, G, m, kend - kbeg)
        for c0, c1 in ((kbeg, a), (b, kend)):
            if c1 > c0:
                ok = _visible(q_pos[r0:r1], torch.arange(c0, c1, device=q.device),
                              causal=causal, window=window, k_len=k_len)
                s4[..., c0 - kbeg:c1 - kbeg].masked_fill_(~ok, _NEG)
        p = torch.softmax(s, dim=-1)
        del s, s4
        dv[:, kbeg:kend].baddbmm_(p.mT, dob)
        ds = torch.bmm(dob, vb.mT).mul_(p)                   # p * dP
        ds.addcmul_(p, ds.sum(dim=-1, keepdim=True), value=-1.0)
        del p
        if logit_cap is not None:
            ds.mul_(t.square_().neg_().add_(1.0))            # through tanh
            del t
        dq[:, :, :, r0:r1] = _scaled_bmm(ds, kb, scale).view(B, KV, G, m, hd)
        dk[:, kbeg:kend].baddbmm_(ds.mT, qb, alpha=scale)
        del ds
        computed += B * H * m * (kend - kbeg)
    ob = _obs_current()
    if ob.enabled:
        ob.registry.counter("flash_attention.bwd_scores_computed").inc(computed)
        ob.registry.counter("flash_attention.bwd_scores_skipped").inc(
            B * H * Sq * Sk - computed)
    return (dq.reshape(B, H, Sq, hd).to(q.dtype), dk.reshape(B, KV, Sk, hd).to(k.dtype),
            dv.reshape(B, KV, Sk, hd).to(v.dtype))
