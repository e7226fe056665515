"""Public entry points of the port's kernels.

Each wrapper checks what its kernel takes and raises on anything else,
launches the hand-written CUDA kernel for a CUDA tensor, and takes the
kernel's plain PyTorch version only for a tensor on the CPU.  There is no
fallback: a CUDA tensor launches the kernel or raises.  Each wrapper counts
its kernel launches in ``<wrapper>.launches``, a plain integer, so a run can
show that its main path went through the kernel; each wrapper makes one C
call a call, which launches its kernel (``seg_combine``'s also zeroes its
output with ``cudaMemsetAsync`` first, on the same stream).  A CUDA graph
that captured wrapper calls adds them again on every replay
(``runtime.decode_graph``).  A wrapper whose kernel has several variants
also counts its launches per variant in ``launches_by_variant``:
``flash_attention`` one kernel per input type (bf16: ``bf16_wgmma``, fp32:
``f32_3xtf32``), ``seg_combine`` its routes (``bins``, ``global``,
``columns``), ``fixture_copy`` its paths (``vector``, ``scalar``, as the
launcher took them).  Beside the
count, each wrapper keeps the distinct launch geometries it launched in
``<wrapper>.geometries``, a set of ``(LaunchSpec, shape, tile)``: the grid
and block, the index space the grid must cover and what one CTA covers of
it (the kernel module's ``coverage``), for the static analyzer's
``launch-geometry`` checker.

``flash_attention`` is differentiable, as the reference's wrapper is (its
``custom_vjp``): the forward is the kernel, counted as any launch, and the
backward is plain PyTorch from the saved q, k and v, as the reference's
``_flash_bwd`` differentiates its jnp oracle: blocks of query rows, each
with one softmax over only the keys its rows see, with no forward
recomputed (:func:`~repro_torch.kernels.flash_attention.chunked_backward`,
in fp32, under a ``flash_attention.backward`` profiler range).  There is no
backward kernel, because the reference has none.

The attention wrappers take the reference's layouts at the public boundary
(``repro/kernels/ops.py``): q (B, H, Sq, hd) and k, v (B, KV, Sk, hd) for
``flash_attention``; q (B, H, 1, hd) over caches (B, KV, S, hd) for
``gqa_decode_attention``.  The kernels take any head dim that is a multiple
of 8 up to 256 and any sequence length, unpadded.
"""

from __future__ import annotations

import torch

from . import decode_attention as _da
from . import fixture_copy as _fc
from . import flash_attention as _fa
from . import seg_combine as _sc

__all__ = ["fixture_copy", "flash_attention", "gqa_decode_attention",
           "seg_combine"]

_VALUE_DTYPES = (torch.float32, torch.bfloat16)


def _check_device(what: str, *tensors: torch.Tensor) -> str:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: inputs on several devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, not {dev}")
    return dev.type


def _check_attention(what: str, q, k, v, *, window, logit_cap) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{what}: {name} must be 4-d, got shape {tuple(t.shape)}")
        if t.dtype not in _VALUE_DTYPES:
            raise TypeError(f"{what}: {name} must be float32 or bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"{what}: q, k, v differ in dtype: {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != v.shape:
        raise ValueError(f"{what}: k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    B, H, _, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"{what}: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "differ in batch or head dim")
    KV = k.shape[1]
    if KV == 0 or H % KV:
        raise ValueError(f"{what}: {H} query heads do not split into {KV} kv groups")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window must be >= 1, got {window}")
    if logit_cap is not None and not logit_cap > 0:
        raise ValueError(f"{what}: logit_cap must be > 0, got {logit_cap}")


def _check_head_dim(what: str, hd: int) -> None:
    if hd % 8 or hd > 256:
        raise ValueError(f"{what}: the kernel takes a head dim that is a "
                         f"multiple of 8 up to 256, not {hd}")


def flash_attention(
    q: torch.Tensor,            # (B, H, Sq, hd) f32 or bf16, contiguous
    k: torch.Tensor,            # (B, KV, Sk, hd), same dtype and device
    v: torch.Tensor,            # (B, KV, Sk, hd)
    *,
    causal: bool = True,
    window: int | None = None,
    logit_cap: float | None = None,
    q_offset: int = 0,
    k_len: int | None = None,
) -> torch.Tensor:
    """GQA attention (B, H, Sq, hd): query head h reads kv head h // G.

    Query row i sits at position ``q_offset + i``; keys at or past ``k_len``
    (default Sk) are masked, as are keys after the query (``causal``) and
    keys at or before ``q_pos - window``.  Scores are scaled by hd**-0.5 and
    soft-capped to ``logit_cap * tanh(s / logit_cap)``.  On the card bf16
    inputs launch the ``wgmma`` kernel and fp32 inputs the split-TF32
    ``mma.sync`` kernel; both load through 16-byte copies (TMA,
    ``cp.async``), so every input must start at a 16-byte-aligned address.
    When q, k or v requires a gradient, the call records
    :class:`_FlashAttention` (its backward is plain PyTorch).
    """
    kw = dict(causal=causal, window=window, logit_cap=logit_cap,
              q_offset=q_offset, k_len=k_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, kw)
    return _flash_forward(q, k, v, **kw)


class _FlashAttention(torch.autograd.Function):
    """The kernel forward, saving only q, k and v; the backward is
    :func:`~repro_torch.kernels.flash_attention.chunked_backward`, the plain
    version's gradients in fp32, with no kernel launch."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        ctx.kw = kw
        ctx.save_for_backward(q, k, v)
        return _flash_forward(q, k, v, **kw)

    @staticmethod
    def backward(ctx, dout):
        with torch.profiler.record_function("flash_attention.backward"):
            grads = _fa.chunked_backward(*ctx.saved_tensors, dout, **ctx.kw)
        return (*grads, None)


def _flash_forward(q, k, v, *, causal, window, logit_cap, q_offset, k_len):
    """The checked, counted launch (the plain version on a CPU tensor)."""
    _check_attention("flash_attention", q, k, v, window=window, logit_cap=logit_cap)
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    k_len = Sk if k_len is None else int(k_len)
    if not 0 <= k_len <= Sk:
        raise ValueError(f"flash_attention: k_len must be in [0, {Sk}], got {k_len}")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset must be >= 0, got {q_offset}")
    spec = _fa.launch_spec(B, H, KV, Sq, hd, q.dtype).check("flash_attention")
    _check_head_dim("flash_attention", hd)
    on_cpu = _check_device("flash_attention", q, k, v) == "cpu"
    if q.numel() == 0 or Sk == 0:
        return torch.zeros_like(q)
    if on_cpu:
        return _fa.flash_attention_torch(
            q, k, v, causal=causal, window=window, logit_cap=logit_cap,
            q_offset=q_offset, k_len=k_len)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(
                f"flash_attention: {name} must start at a 16-byte-aligned "
                "address, which the kernels' 16-byte copies (TMA in bf16, "
                "cp.async in fp32) need")
    out = _fa.flash_attention_cuda(
        q, k, v, causal=causal, window=window, logit_cap=logit_cap,
        q_offset=int(q_offset), k_len=k_len, spec=spec)
    flash_attention.launches += 1
    flash_attention.launches_by_variant[_fa.VARIANTS[q.dtype]] += 1
    flash_attention.geometries.add((spec, *_fa.coverage(B, H, KV, Sq, q.dtype, hd)))
    return out


flash_attention.launches = 0
flash_attention.launches_by_variant = dict.fromkeys(_fa.VARIANTS.values(), 0)
flash_attention.geometries = set()


def gqa_decode_attention(
    q: torch.Tensor,            # (B, H, 1, hd) f32 or bf16, contiguous
    k_cache: torch.Tensor,      # (B, KV, S, hd), same dtype and device
    v_cache: torch.Tensor,      # (B, KV, S, hd)
    slot_pos: torch.Tensor,     # (S,) int32: the position each slot holds
    pos: torch.Tensor,          # 0-dim int32: the position of this token
    *,
    window: int | None = None,
    logit_cap: float | None = None,
    layout: str | None = None,
    return_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """One token's attention over a full or ring cache, (B, H, 1, hd).

    Slot s is seen when ``0 <= slot_pos[s] <= pos`` and, with a window,
    ``slot_pos[s] > pos - window``; a slot never written holds a negative
    position.  ``pos`` and ``slot_pos`` stay on the device.  ``layout``
    says which of the model's two cache layouts ``slot_pos`` is:
    ``"full"`` (``models.attention.full_slot_positions``) or ``"ring"``
    (``ring_slot_positions`` at ``pos``); the kernel then reads only the
    live span at ``pos`` (``decode_attention.live_span``).  ``None``, for
    any other ``slot_pos``, reads all S slots.  The mask holds either way.
    On the card every input must start at a 16-byte-aligned address.
    ``return_lse`` returns beside the output each row's fp32 (B, H, 1)
    log-sum-exp of its seen scores, -inf (and an output of 0) where it sees
    no slot: what a cache split over ranks merges the ranks' partial
    attentions by (``tensor_parallel.merge_partials``).
    """
    what = "gqa_decode_attention"
    _check_attention(what, q, k_cache, v_cache, window=window, logit_cap=logit_cap)
    B, H, one, hd = q.shape
    if one != 1:
        raise ValueError(f"{what}: q must be (B, H, 1, hd), got {tuple(q.shape)}")
    KV, S = k_cache.shape[1], k_cache.shape[2]
    if slot_pos.shape != (S,) or slot_pos.dtype != torch.int32:
        raise ValueError(f"{what}: slot_pos must be ({S},) int32, got "
                         f"{tuple(slot_pos.shape)} {slot_pos.dtype}")
    if pos.dim() != 0 or pos.dtype != torch.int32:
        raise ValueError(f"{what}: pos must be a 0-dim int32 tensor, got "
                         f"{tuple(pos.shape)} {pos.dtype}")
    if not slot_pos.is_contiguous():
        raise ValueError(f"{what}: slot_pos must be contiguous")
    if layout not in _da.LAYOUTS:
        raise ValueError(f"{what}: layout must be one of {list(_da.LAYOUTS)}, "
                         f"not {layout!r}")
    G = H // KV
    if G > _da.MAX_G:
        raise ValueError(f"{what}: the kernel takes up to {_da.MAX_G} heads "
                         f"per kv group, not {G}")
    spec = _da.launch_spec(B, KV, G, S, hd, q.dtype).check(what)
    _check_head_dim(what, hd)
    qg = q.view(B, KV, G, hd)
    on_cpu = _check_device(what, q, k_cache, v_cache, slot_pos, pos) == "cpu"
    if q.numel() == 0 or S == 0:
        out = torch.zeros_like(q)
        if not return_lse:
            return out
        return out, torch.full((B, H, 1), -torch.inf, device=q.device)
    if on_cpu:
        out = _da.decode_attention_torch(qg, k_cache, v_cache, slot_pos, pos,
                                         window=window, logit_cap=logit_cap,
                                         return_lse=return_lse)
    else:
        for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
            if t.data_ptr() % 16:
                raise ValueError(f"{what}: {name} must start at a 16-byte-aligned "
                                 "address, which the kernel's 16-byte loads need")
        out = _da.decode_attention_cuda(
            qg, k_cache, v_cache, slot_pos, pos, window=window,
            logit_cap=logit_cap, layout=layout, spec=spec, return_lse=return_lse)
        gqa_decode_attention.launches += 1
        gqa_decode_attention.geometries.add(
            (spec, *_da.coverage(B, KV, G, S, spec.grid[0])))
    if return_lse:
        return out[0].view(B, H, 1, hd), out[1].view(B, H, 1)
    return out.view(B, H, 1, hd)


gqa_decode_attention.launches = 0
gqa_decode_attention.geometries = set()


def seg_combine(
    values: torch.Tensor,       # (N, D) f32 or bf16, contiguous
    part_ids: torch.Tensor,     # (N,) int32, contiguous; outside [0, P) dropped
    num_parts: int,
) -> torch.Tensor:
    """Per-partition sums, shape (P, D) fp32 (the map-side combine).

    Ids outside ``[0, P)`` are dropped, as the reference's Pallas kernel
    drops them.  (The reference's jnp oracle clips ids >= P into row P-1;
    the kernel, and this port, do not.)  Ids may come in any order.  On the
    card the kernel's route is :func:`repro_torch.kernels.seg_combine.route`
    of (N, D, P).
    """
    if values.dim() != 2:
        raise ValueError(f"values must be (N, D), got shape {tuple(values.shape)}")
    if values.dtype not in _VALUE_DTYPES:
        raise TypeError(f"values must be float32 or bfloat16, got {values.dtype}")
    if part_ids.dim() != 1 or part_ids.shape[0] != values.shape[0]:
        raise ValueError(
            f"part_ids must be (N,) with N = {values.shape[0]}, "
            f"got shape {tuple(part_ids.shape)}")
    if part_ids.dtype != torch.int32:
        raise TypeError(f"part_ids must be int32, got {part_ids.dtype}")
    if not (values.is_contiguous() and part_ids.is_contiguous()):
        raise ValueError("values and part_ids must be contiguous")
    if values.device != part_ids.device:
        raise ValueError(
            f"values on {values.device} but part_ids on {part_ids.device}")
    num_parts = int(num_parts)
    if num_parts < 0:
        raise ValueError(f"num_parts must be >= 0, got {num_parts}")
    if values.device.type == "cpu":
        return _sc.seg_combine_torch(values, part_ids, num_parts)
    if values.device.type != "cuda":
        raise ValueError(f"seg_combine runs on cuda or cpu, not {values.device}")
    if values.numel() == 0 or num_parts == 0:
        return torch.zeros((num_parts, values.shape[1]), dtype=torch.float32,
                           device=values.device)
    geo = _sc.geometry(*values.shape, num_parts)
    out = _sc.seg_combine_cuda(values, part_ids, num_parts, geo)
    seg_combine.launches += 1
    seg_combine.launches_by_variant[geo.route] += 1
    seg_combine.geometries.add(geo[1:])
    return out


seg_combine.launches = 0
seg_combine.launches_by_variant = dict.fromkeys(_sc.ROUTES, 0)
seg_combine.geometries = set()


def _pair(what: str, name: str, v) -> tuple[int, int]:
    try:
        a, b = (int(t) for t in v)
    except (TypeError, ValueError):
        raise ValueError(f"{what}: {name} must be two ints, got {v!r}") from None
    if a < 1 or b < 1:
        raise ValueError(f"{what}: {name} must be >= 1, got {(a, b)}")
    return a, b


def fixture_copy(
    x: torch.Tensor,            # (R, C) float32, contiguous
    tile: tuple[int, int],      # what one CTA copies
    *,
    grid: tuple[int, int] | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """A copy of ``x``, one CTA per ``tile`` (the kernel of the analyzer's
    known-bad launch fixture).

    ``grid=None`` launches the ceiling-division grid of
    :func:`repro_torch.kernels.fixture_copy.launch_spec`, which covers
    ``x``.  A given ``(grid_x, grid_y)`` launches that geometry as it is,
    faulty or not, into ``out`` (a NaN-filled tensor by default), so the
    elements it leaves unwritten stay NaN.
    """
    what = "fixture_copy"
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous 2-d float32 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    tile = _pair(what, "tile", tile)
    if tile[0] * tile[1] >= 2 ** 31:
        raise ValueError(f"{what}: tile {tile} has 2^31 elements or more")
    if grid is not None:
        grid = _pair(what, "grid", grid)
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or not out.is_contiguous()):
        raise ValueError(f"{what}: out must be a contiguous tensor of x's "
                         f"shape and dtype, got {tuple(out.shape)} {out.dtype}")
    on_cpu = _check_device(what, *([x] if out is None else [x, out])) == "cpu"
    if on_cpu:
        return _fc.fixture_copy_torch(x, tile, grid, out)
    if out is None:
        out = (torch.empty_like(x) if grid is None
               else torch.full_like(x, float("nan")))
    if x.numel() == 0:
        return out
    geo = _fc.geometry(*x.shape, tile, grid)
    path = _fc.fixture_copy_cuda(x, out, geo[0], tile)
    fixture_copy.launches += 1
    fixture_copy.launches_by_variant[path] += 1
    fixture_copy.geometries.add(geo)
    return out


fixture_copy.launches = 0
fixture_copy.launches_by_variant = dict.fromkeys(_fc.PATHS, 0)
fixture_copy.geometries = set()
