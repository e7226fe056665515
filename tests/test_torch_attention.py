"""The port's attention kernels against the JAX package's, on the CPU.

On the CPU the port's wrappers take the kernels' plain PyTorch versions; the
JAX side runs its Pallas kernels in interpret mode and its jnp oracles, as
``tests/test_kernels.py`` does, over that file's own sweep.  The port's plain
``chunked_attention`` (the ``"torch"`` attention impl) is held to the same
oracle.  Tolerances are the reference's: 1e-5 in fp32 (the sums run in
another order) and 2e-2 in bf16 (bf16 scores and probabilities round at other
places in the two frameworks).  The wrappers' checks, their launch geometry
and its shared memory are pinned here too; the kernels themselves run only on
the card, in ``chip_smoke.py``.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as j_flash_attention
from repro.kernels import gqa_decode_attention as j_gqa_decode_attention
from repro.kernels.ref import decode_attention_ref, flash_attention_ref
from repro.models.attention import _ring_slot_positions
from repro_torch.kernels import flash_attention, gqa_decode_attention
from repro_torch.kernels.decode_attention import decode_attention_torch
from repro_torch.kernels.decode_attention import TILE, live_span, split_plan
from repro_torch.kernels.decode_attention import coverage as decode_coverage
from repro_torch.kernels.decode_attention import launch_spec as decode_spec
from repro_torch.kernels.flash_attention import (BLOCK_N, VARIANTS,
                                                 flash_attention_torch,
                                                 heads_per_tile, tile_plan)
from repro_torch.kernels.flash_attention import coverage as flash_coverage
from repro_torch.kernels.flash_attention import launch_spec as flash_spec
from repro_torch.kernels._build import MAX_SMEM_BYTES
from repro_torch.models.attention import chunked_attention, ring_slot_positions

TOL = dict(rtol=2e-2, atol=2e-2)      # bf16
TOL32 = dict(rtol=1e-5, atol=1e-5)
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrays, dtype):
    t_dt, j_dt = DTYPES[dtype]
    return ([torch.from_numpy(a).to(t_dt) for a in arrays],
            [jnp.asarray(a, j_dt) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# ----------------------------------------------------------- flash attention

FLASH_CASES = {
    # name: (B, H, KV, Sq, Sk, hd, causal, window, logit_cap, q_offset)
    "gqa": (1, 4, 2, 256, 256, 64, True, None, None, 0),
    "sq_ne_sk": (2, 2, 2, 128, 384, 128, True, None, None, 0),
    "mqa_hd80": (1, 8, 1, 256, 256, 80, True, None, None, 0),
}
FLASH_F32_CASES = {
    "window64": (1, 4, 4, 256, 256, 64, True, 64, None, 0),
    "window128": (1, 4, 4, 256, 256, 64, True, 128, None, 0),
    "window1024": (1, 4, 4, 256, 256, 64, True, 1024, None, 0),
    "softcap_offset": (1, 4, 2, 128, 384, 128, True, None, 50.0, 256),
    "bidirectional": (2, 4, 4, 128, 128, 64, False, None, None, 0),
    "unaligned": (1, 2, 2, 200, 333, 64, False, None, None, 0),
}
_SWEEP = ([(n, "f32") for n in FLASH_CASES] + [(n, "bf16") for n in FLASH_CASES]
          + [(n, "f32") for n in FLASH_F32_CASES])


@pytest.mark.parametrize("name,dtype", _SWEEP)
def test_flash_matches_pallas_and_oracle(name, dtype):
    B, H, KV, Sq, Sk, hd, causal, window, cap, q_offset = {
        **FLASH_CASES, **FLASH_F32_CASES}[name]
    arrays = _arrays(zlib.crc32(name.encode()), (B, H, Sq, hd), (B, KV, Sk, hd),
                     (B, KV, Sk, hd))
    (q, k, v), (jq, jk, jv) = _both(arrays, dtype)
    pallas = j_flash_attention(jq, jk, jv, causal, window, cap, q_offset)
    oracle = flash_attention_ref(jq, jk, jv, causal=causal, window=window,
                                 logit_cap=cap, q_offset=q_offset)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window, logit_cap=cap,
                          q_offset=q_offset)
    assert flash_attention.launches == before      # the CPU never launches
    assert got.dtype == q.dtype and got.shape == (B, H, Sq, hd)
    tol = TOL if dtype == "bf16" else TOL32
    np.testing.assert_allclose(_np(got), _np(pallas), **tol)
    np.testing.assert_allclose(_np(got), _np(oracle), **tol)
    chunked = chunked_attention(q, k, v, causal=causal, window=window,
                                logit_cap=cap, q_offset=q_offset, chunk=128)
    np.testing.assert_allclose(_np(chunked), _np(oracle), **tol)


def test_flash_k_len_masks_the_tail():
    q, k, v = (torch.from_numpy(a) for a in _arrays(
        9, (1, 2, 64, 16), (1, 1, 96, 16), (1, 1, 96, 16)))
    got = flash_attention(q, k, v, causal=False, k_len=70)
    want = flash_attention_ref(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                               jnp.asarray(v.numpy()), causal=False, k_len=70)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)
    cut = flash_attention(q, k[:, :, :70].contiguous(), v[:, :, :70].contiguous(),
                          causal=False)
    np.testing.assert_allclose(got.numpy(), cut.numpy(), **TOL32)


# ------------------------------------------- the bf16 kernel's tile plan

# (B, H, KV, Sq, Sk, hd, causal, window, logit_cap, q_offset), k_len
PLAN_CASES = {
    **{n: (c, None) for n, c in {**FLASH_CASES, **FLASH_F32_CASES}.items()},
    # chip_smoke.py's main shapes: gemma2-9b prefill, global and local
    # layers, and the 4608-token prompt
    "main": ((4, 16, 8, 512, 512, 256, True, None, 50.0, 0), None),
    "main_local": ((4, 16, 8, 512, 512, 256, True, 4096, 50.0, 0), None),
    "long": ((1, 16, 8, 4608, 4608, 256, True, 4096, 50.0, 0), None),
    # G = 3 (one head per tile), k_len below Sk, an offset and a window
    # narrower than one kv tile
    "g3_klen": ((1, 6, 2, 200, 333, 72, True, 40, None, 100), 250),
    "g3_bidirectional_klen": ((1, 6, 2, 130, 200, 96, False, None, None, 0), 150),
}


def _visible(q_lo, q_hi, Sk, causal, window, q_offset, k_len):
    """(queries, keys) visibility from the masks' definitions, as
    flash_attention_torch applies them."""
    qpos = q_offset + np.arange(q_lo, q_hi)[:, None]
    key = np.arange(Sk)[None, :]
    ok = key < k_len
    if causal:
        ok = ok & (key <= qpos)
    if window is not None:
        ok = ok & (key > qpos - window)
    return ok


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_tile_plan_covers_every_visible_pair_and_masks_every_crossing(name):
    (B, H, KV, Sq, Sk, hd, causal, window, cap, q_offset), k_len = PLAN_CASES[name]
    k_len = Sk if k_len is None else k_len
    plan = tile_plan(H, KV, Sq, causal=causal, window=window,
                     q_offset=q_offset, k_len=k_len)
    spec = flash_spec(B, H, KV, Sq, hd, torch.bfloat16)
    assert len(plan) == spec.grid[2]
    qm = 64 // heads_per_tile(H, KV)
    rows = []
    for cta in plan:
        for mt in cta.mtiles:
            rows.extend(range(mt.q_lo, mt.q_hi))
            assert mt.q_hi - mt.q_lo <= qm
            vis = _visible(mt.q_lo, mt.q_hi, Sk, causal, window, q_offset, k_len)
            covered = np.zeros(Sk, bool)
            for key0, masked in mt.tiles:
                # a tile the producer loads, from the CTA's range
                assert (key0 - cta.kbeg) % BLOCK_N == 0
                assert cta.kbeg <= key0 < cta.kbeg + cta.n_tiles * BLOCK_N
                assert key0 < cta.kend
                tile = vis[:, key0:key0 + BLOCK_N]
                assert tile.any(), (name, mt, key0)       # nothing launched empty
                if not masked:                            # every pair visible
                    assert key0 + BLOCK_N <= Sk and tile.all(), (name, mt, key0)
                covered[key0:key0 + BLOCK_N] = True
            assert not vis[:, ~covered].any(), (name, mt)  # every visible pair
    assert rows == list(range(Sq))                         # every query once


def test_tile_plan_masks_only_the_diagonal_at_the_main_shape():
    # causal, 32 queries of 2 heads a warpgroup: one masked tile per M-tile
    plan = tile_plan(16, 8, 512, causal=True, window=None, q_offset=0, k_len=512)
    for z, cta in enumerate(plan):
        assert (cta.kbeg, cta.n_tiles) == (0, z + 1)
        for mt in cta.mtiles:
            assert [m for _, m in mt.tiles] == [False] * z + [True]


def _emulate_wgmma(q, k, v, *, causal, window, logit_cap, q_offset, k_len):
    """The bf16 kernel's arithmetic, tile by tile along :func:`tile_plan`:
    bf16 Q K^T summed in fp32, the scale (and softcap) folded with log2(e)
    and exp2, the per-element mask only on tiles the plan marks, P rounded
    to bf16 before P V, m, l and O in fp32."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float()
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, BLOCK_N)).repeat_interleave(G, 1)
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, BLOCK_N)).repeat_interleave(G, 1)
    log2e = 1.4426950408889634
    out = torch.zeros(B, H, Sq, hd)
    for cta in tile_plan(H, KV, Sq, causal=causal, window=window,
                         q_offset=q_offset, k_len=k_len):
        for mt in cta.mtiles:
            qt = qf[:, :, mt.q_lo:mt.q_hi]
            vis = torch.from_numpy(_visible(mt.q_lo, mt.q_hi, Sk + BLOCK_N, causal,
                                            window, q_offset, k_len))
            m = torch.full(qt.shape[:3], -1e30)
            l = torch.zeros(qt.shape[:3])
            o = torch.zeros(qt.shape)
            for key0, masked in mt.tiles:
                keys = slice(key0, key0 + BLOCK_N)
                s = qt @ kf[:, :, keys].transpose(2, 3)
                if logit_cap is not None:
                    s = logit_cap * log2e * torch.tanh(s * (hd ** -0.5 / logit_cap))
                else:
                    s = s * (hd ** -0.5 * log2e)
                if masked:
                    s = s.masked_fill(~vis[:, keys], float("-inf"))
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[..., None])
                l = l * corr + p.sum(-1)
                o = o * corr[..., None] + p.bfloat16().float() @ vf[:, :, keys]
                m = m_new
            out[:, :, mt.q_lo:mt.q_hi] = o / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


EMULATION_CASES = {
    **FLASH_CASES,
    # gemma2-9b's attention at a 2-layer cut's size: H 16, KV 8, hd 256,
    # softcap 50, a ragged Sq and Sk
    "gemma2_hd256_softcap": (1, 16, 8, 200, 200, 256, True, None, 50.0, 0),
}


@pytest.mark.parametrize("name", list(EMULATION_CASES))
def test_bf16_kernel_arithmetic_matches_pallas_and_oracle(name):
    B, H, KV, Sq, Sk, hd, causal, window, cap, q_offset = EMULATION_CASES[name]
    arrays = _arrays(zlib.crc32(name.encode()) + 1, (B, H, Sq, hd),
                     (B, KV, Sk, hd), (B, KV, Sk, hd))
    (q, k, v), (jq, jk, jv) = _both(arrays, "bf16")
    got = _emulate_wgmma(q, k, v, causal=causal, window=window, logit_cap=cap,
                         q_offset=q_offset, k_len=Sk)
    pallas = j_flash_attention(jq, jk, jv, causal, window, cap, q_offset)
    oracle = flash_attention_ref(jq, jk, jv, causal=causal, window=window,
                                 logit_cap=cap, q_offset=q_offset)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, Sq, hd)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL)
    np.testing.assert_allclose(_np(got), _np(oracle), **TOL)


def test_each_dtype_has_its_kernel_and_the_cpu_counts_no_variant():
    assert VARIANTS == {torch.float32: "f32_3xtf32",
                        torch.bfloat16: "bf16_wgmma"}
    before = dict(flash_attention.launches_by_variant)
    assert set(before) == set(VARIANTS.values())
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _arrays(
        5, (1, 6, 40, 24), (1, 2, 40, 24), (1, 2, 40, 24)))
    flash_attention(q, k, v, window=16, logit_cap=30.0, q_offset=3)
    assert flash_attention.launches_by_variant == before


# ----------------------------------------------------------- decode attention

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,KV,S,hd", [(2, 8, 2, 512, 64), (1, 4, 4, 300, 128)])
def test_decode_full_cache(B, H, KV, S, hd, dtype):
    arrays = _arrays(S + hd, (B, H, 1, hd), (B, KV, S, hd), (B, KV, S, hd))
    (q, kc, vc), (jq, jkc, jvc) = _both(arrays, dtype)
    slot_pos = np.arange(S, dtype=np.int32)
    pos = np.int32(S // 2)                     # only half the cache is valid
    pallas = j_gqa_decode_attention(jq, jkc, jvc, jnp.asarray(slot_pos),
                                    jnp.asarray(pos))
    oracle = decode_attention_ref(jq.reshape(B, KV, H // KV, hd), jkc, jvc,
                                  jnp.asarray(slot_pos), jnp.asarray(pos))
    before = gqa_decode_attention.launches
    got = gqa_decode_attention(q, kc, vc, torch.from_numpy(slot_pos),
                               torch.tensor(pos))
    assert gqa_decode_attention.launches == before
    assert got.dtype == q.dtype and got.shape == (B, H, 1, hd)
    tol = TOL if dtype == "bf16" else TOL32
    np.testing.assert_allclose(_np(got), _np(pallas), **tol)
    np.testing.assert_allclose(_np(got), _np(oracle).reshape(B, H, 1, hd), **tol)


def test_decode_ring_cache_with_window_and_softcap():
    B, H, KV, S, hd, window = 1, 4, 1, 256, 64, 200
    arrays = _arrays(8, (B, H, 1, hd), (B, KV, S, hd), (B, KV, S, hd))
    (q, kc, vc), (jq, jkc, jvc) = _both(arrays, "f32")
    pos = torch.tensor(1000, dtype=torch.int32)
    slot_pos = ring_slot_positions(pos, S)
    j_slot_pos = _ring_slot_positions(jnp.asarray(1000, jnp.int32), S)
    np.testing.assert_array_equal(slot_pos.numpy(), np.asarray(j_slot_pos))
    pallas = j_gqa_decode_attention(jq, jkc, jvc, j_slot_pos.astype(jnp.int32),
                                    jnp.asarray(1000, jnp.int32), window=window,
                                    logit_cap=30.0)
    oracle = decode_attention_ref(jq.reshape(B, KV, H // KV, hd), jkc, jvc,
                                  j_slot_pos, jnp.asarray(1000), window=window,
                                  logit_cap=30.0)
    got = gqa_decode_attention(q, kc, vc, slot_pos, pos, window=window,
                               logit_cap=30.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL32)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle).reshape(B, H, 1, hd),
                               **TOL32)


@pytest.mark.parametrize("pos", [0, 5, 15, 16, 17, 40])
def test_ring_slot_positions_use_a_floored_mod(pos):
    # before the ring fills, unwritten slots hold negative positions: the
    # floored mod of torch.remainder, not fmod's truncated one
    got = ring_slot_positions(torch.tensor(pos, dtype=torch.int32), 16)
    want = _ring_slot_positions(jnp.asarray(pos, jnp.int32), 16)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------- launch geometry

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hd", [16, 64, 80, 128, 256])
def test_launch_shared_memory_fits_an_h100_block(hd, dtype):
    spec = flash_spec(4, 16, 8, 512, hd, DTYPES[dtype][0])
    if dtype == "f32":      # split TF32: q rows + 2 stages of K and V tiles, fp32
        # above hd 128 pairs of warps share 16 rows: 64 rows, P and row sums
        rows, keys = (128, 64) if hd <= 128 else (64, 32)
        ldq = hd + 8 if hd % 16 == 0 else hd
        ldv = (32 if hd <= 32 else 64 if hd <= 64 else 128 if hd <= 128 else 256) + 4
        exchange = 0 if hd <= 128 else 4 * 16 * (32 + 8 + 2)
        assert spec.smem_bytes == (rows * ldq + 2 * keys * (ldq + ldv) + exchange) * 4
        assert spec.grid == (512 * 2 // rows, 8, 4) and spec.block == (256, 1, 1)
        assert flash_coverage(4, 16, 8, 512, torch.float32, hd) == (
            (512 * 2, 8, 4), (rows, 1, 1))
    else:                   # wgmma: slack, q (128 rows), K/V stages of 64 keys
        hdp = 64 if hd <= 64 else 128 if hd <= 128 else 256
        stages = 2 if hdp == 256 else 4
        assert spec.smem_bytes == (1024 + 128 * hdp * 2
                                   + stages * 2 * 64 * hdp * 2 + 128)
        # G = 2 heads share a warpgroup's 64 rows: 32 queries, 64 per CTA
        assert spec.grid == (16 // 2, 4, 512 // 64) and spec.block == (384, 1, 1)
    assert spec.smem_bytes <= MAX_SMEM_BYTES == 232_448
    # decode: two stages of 32 K and 32 V rows, each padded by 16 bytes,
    # (in bf16 Q's 2 rows and a zero row, padded too), the stages' slot
    # positions and 4,672 bytes of scratch; at hd 256 bf16 three CTAs fit an
    # SM, so 3 x 132 // 32 = 12 splits
    dspec = decode_spec(4, 8, 2, 1024, hd, DTYPES[dtype][0])
    esize = DTYPES[dtype][0].itemsize
    n_splits = dspec.grid[0]
    assert dspec.grid[1:] == (8, 4) and dspec.block == (128, 1, 1)
    assert n_splits == (12 if (hd, dtype) == (256, "bf16") else n_splits) <= 32
    q_rows = 3 if dtype == "bf16" else 0
    assert dspec.smem_bytes == ((2 * 2 * 32 + q_rows) * (hd + 16 // esize) * esize
                                + 2 * 32 * 4 + 4672) <= MAX_SMEM_BYTES
    assert spec.check("flash") is spec and dspec.check("decode") is dspec


@pytest.mark.parametrize("hd", [8, 24, 40, 64, 72, 128, 136, 200, 256])
def test_f32_launch_figures_at_every_head_dim_instance(hd):
    """The fp32 kernel's CTA, strides and shared memory as the source lays
    them out: q and K rows read as float2 pairs by 16 lanes need a stride of
    8 or 24 words mod 32, V rows read at keys 2t and 2t + 1 a stride of 4 or
    12 mod 16, and every row 16-byte aligned for cp.async."""
    from repro_torch.kernels.flash_attention import f32_row_strides, f32_tile

    warps, split, rows, keys = f32_tile(hd)
    ldq, ldv = f32_row_strides(hd)
    inst = 32 if hd <= 32 else 64 if hd <= 64 else 128 if hd <= 128 else 256
    assert (warps, split, rows, keys) == ((8, 1, 128, 64) if inst <= 128 else (8, 2, 64, 32))
    assert ldq >= hd and ldq % 32 in (8, 24) and ldq % 4 == 0
    assert ldv == inst + 4 and ldv % 16 in (4, 12)
    for B, H, KV, Sq in ((1, 16, 1, 2100), (2, 9, 1, 65), (4, 16, 8, 512), (1, 2, 2, 1)):
        spec = flash_spec(B, H, KV, Sq, hd, torch.float32)
        shape, tile = flash_coverage(B, H, KV, Sq, torch.float32, hd)
        assert shape == (Sq * (H // KV), KV, B) and tile == (rows, 1, 1)
        assert spec.grid[0] * rows >= shape[0] > (spec.grid[0] - 1) * rows
        assert spec.grid[1:] == (KV, B) and spec.block == (32 * warps, 1, 1)
        exchange = 0 if split == 1 else rows * (keys + 8 + split)
        assert spec.smem_bytes == (rows * ldq + 2 * keys * (ldq + ldv) + exchange) * 4
        assert spec.check("flash") is spec


@pytest.mark.parametrize("B,KV,G,S", [(4, 8, 2, 1024), (1, 8, 2, 4096),
                                      (1, 8, 2, 5120), (2, 2, 4, 512),
                                      (1, 4, 1, 300), (1, 1, 9, 7)])
def test_decode_split_covers_the_cache(B, KV, G, S):
    # the grid is sized for the worst case, all S slots live: as many CTAs
    # as stay resident (3 a SM at hd 256 bf16), at most one a 32-slot tile,
    # at most 32 a (batch row, kv head); the split of the tiles among them
    # is decided on the device (split_plan)
    spec = decode_spec(B, KV, G, S, 256)
    n_splits = spec.grid[0]
    tiles = -(-S // TILE)
    assert n_splits == max(1, min(32, tiles, 3 * 132 // (B * KV)))
    assert (B, KV, S) != (4, 8, 1024) or n_splits == 12
    assert spec.grid[1:] == (KV, B) and spec.block == (128, 1, 1)
    shape, tile = decode_coverage(B, KV, G, S, n_splits)
    assert shape == (S, KV, B) and tile[1:] == (1, 1)
    assert tile[0] == -(-tiles // n_splits) * TILE and n_splits * tile[0] >= S
    plan = split_plan(S - 1, S, n_splits)            # all S slots live
    assert max(len(p) for p in plan) <= tile[0]
    assert sorted(s for p in plan for s in p) == list(range(S))


def _slot_positions(pos, S, layout):
    if layout == "ring":
        return ring_slot_positions(torch.tensor(pos, dtype=torch.int32), S).numpy()
    return np.arange(S, dtype=np.int32)


def _seen(slot_pos, pos, window):
    ok = (slot_pos >= 0) & (slot_pos <= pos)
    if window is not None:
        ok &= slot_pos > pos - window
    return ok


SPLIT_CASES = {
    # name: (B, KV, S, pos, window, layout); gemma2-9b's full cache of 1024
    # is cut into 32 tiles among 12 splits (at G 2)
    "pos0": (4, 8, 1024, 0, None, "full"),
    "inside_first_split": (4, 8, 1024, 17, None, "full"),
    "tile_boundary_minus1": (4, 8, 1024, 30, None, "full"),
    "tile_boundary": (4, 8, 1024, 31, None, "full"),
    "tile_boundary_plus1": (4, 8, 1024, 32, None, "full"),
    "split_boundary_minus1": (4, 8, 1024, 382, None, "full"),
    "split_boundary": (4, 8, 1024, 383, None, "full"),
    "split_boundary_plus1": (4, 8, 1024, 384, None, "full"),
    "serving_step": (4, 8, 1024, 527, None, "full"),
    "last_slot": (4, 8, 1024, 1023, None, "full"),
    "full_with_window": (1, 2, 512, 400, 100, "full"),
    "ring_not_yet_full": (1, 8, 4096, 700, 4096, "ring"),
    "ring_wrapped": (1, 8, 4096, 4610, 4096, "ring"),
    "ring_window_below_S": (1, 1, 256, 1000, 200, "ring"),
    "ring_s_off_tile": (1, 2, 100, 250, 64, "ring"),
    "s_off_tile": (1, 4, 300, 299, None, "full"),
    "undeclared": (2, 2, 300, 150, None, None),
    "undeclared_ring": (1, 1, 256, 1000, 200, None),
}


@pytest.mark.parametrize("G", [1, 2, 3, 8])
@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_plan_reads_every_seen_slot_once(name, G):
    B, KV, S, pos, window, layout = SPLIT_CASES[name]
    n_splits = decode_spec(B, KV, G, S, 256).grid[0]
    plan = split_plan(pos, S, n_splits, window=window, layout=layout)
    assert len(plan) == n_splits
    read = [s for p in plan for s in p]
    assert len(read) == len(set(read))                 # no slot twice
    assert all(len(p) <= decode_coverage(B, KV, G, S, n_splits)[1][0]
               for p in plan)
    seen = np.flatnonzero(_seen(_slot_positions(pos, S, layout), pos, window))
    assert set(seen) <= set(read)                      # every seen slot
    first, n = live_span(pos, S, window=window, layout=layout)
    assert len(read) == n and read[:1] == ([first] if n else [])
    if layout is not None:                             # only the live span
        assert len(read) == len(seen)
    # the tiles are shared as evenly as the splits allow
    sizes = [-(-len(p) // TILE) for p in plan]
    assert max(sizes) - min(sizes) <= 1


def _emulate_decode(q, kc, vc, slot_pos, pos, *, window, logit_cap, layout):
    """The decode kernel's arithmetic on the CPU: each split of
    :func:`split_plan` runs an fp32 online softmax over its tiles of 32
    slots (a tile with no slot seen is skipped); in bf16 P goes to P V as
    two bf16 parts, hi + lo (the tensor cores' input), and l sums the fp32
    P; the splits' partials (m, l, acc) merge in split order; rounded
    once."""
    B, KV, G, hd = q.shape
    S = kc.shape[2]
    n_splits = decode_spec(B, KV, G, S, hd, q.dtype).grid[0]
    plan = split_plan(int(pos), S, n_splits, window=window, layout=layout)
    ok_all = torch.from_numpy(_seen(slot_pos.numpy(), int(pos), window))
    qf, kf, vf = q.float(), kc.float(), vc.float()
    bf16 = q.dtype == torch.bfloat16
    out = torch.zeros(B, KV, G, hd)
    for b in range(B):
        for h in range(KV):
            parts = []
            for slots in plan:
                m, l, acc = torch.full((G,), -1e30), torch.zeros(G), torch.zeros(G, hd)
                for t0 in range(0, len(slots), TILE):
                    idx = torch.tensor(slots[t0:t0 + TILE])
                    ok = ok_all[idx]
                    if not ok.any():
                        continue
                    s = qf[b, h] @ kf[b, h, idx].T * hd ** -0.5
                    if logit_cap is not None:
                        s = logit_cap * torch.tanh(s / logit_cap)
                    m_new = torch.maximum(m, torch.where(ok, s, -1e30).amax(-1))
                    corr = torch.exp(m - m_new)
                    p = torch.where(ok, torch.exp(s - m_new[:, None]), 0.0)
                    l = l * corr + p.sum(-1)
                    if bf16:
                        hi = p.bfloat16().float()
                        pv = (hi, (p - hi).bfloat16().float())
                    else:
                        pv = (p,)
                    acc = acc * corr[:, None] + sum(part @ vf[b, h, idx] for part in pv)
                    m = m_new
                parts.append((m, l, acc))
            M = torch.stack([m for m, _, _ in parts]).amax(0)
            L, o = torch.zeros(G), torch.zeros(G, hd)
            for m, l, acc in parts:
                c = torch.exp(m - M)
                L, o = L + l * c, o + acc * c[:, None]
            out[b, h] = o / L.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


MERGE_CASES = {
    # name: (B, H, KV, S, hd, pos, window, logit_cap, layout)
    "full_half": (2, 8, 2, 512, 64, 256, None, None, "full"),
    "full_undeclared": (2, 8, 2, 512, 64, 256, None, None, None),
    "ring_window_softcap": (1, 4, 1, 256, 64, 1000, 200, 30.0, "ring"),
    "gemma_hd256_softcap": (1, 16, 8, 160, 256, 100, None, 50.0, "full"),
    "mqa_g1_ring": (1, 4, 4, 96, 64, 130, None, 30.0, "ring"),
    "g8_ring_s_off_tile": (1, 16, 2, 100, 128, 250, 64, None, "ring"),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(MERGE_CASES))
def test_decode_kernel_merge_matches_pallas_and_oracle(name, dtype):
    B, H, KV, S, hd, pos, window, cap, layout = MERGE_CASES[name]
    arrays = _arrays(zlib.crc32(name.encode()), (B, H, 1, hd), (B, KV, S, hd),
                     (B, KV, S, hd))
    (q, kc, vc), (jq, jkc, jvc) = _both(arrays, dtype)
    slot_pos = _slot_positions(pos, S, layout if layout else "full")
    jpos, jsp = jnp.asarray(pos, jnp.int32), jnp.asarray(slot_pos)
    got = _emulate_decode(q.view(B, KV, H // KV, hd), kc, vc,
                          torch.from_numpy(slot_pos), torch.tensor(pos),
                          window=window, logit_cap=cap, layout=layout)
    pallas = j_gqa_decode_attention(jq, jkc, jvc, jsp, jpos, window=window,
                                    logit_cap=cap)
    oracle = decode_attention_ref(jq.reshape(B, KV, H // KV, hd), jkc, jvc,
                                  jsp, jpos, window=window, logit_cap=cap)
    tol = TOL if dtype == "bf16" else TOL32
    got = _np(got).reshape(B, H, 1, hd)
    np.testing.assert_allclose(got, _np(pallas), **tol)
    np.testing.assert_allclose(got, _np(oracle).reshape(B, H, 1, hd), **tol)


def test_decode_wrapper_takes_a_declared_layout_on_the_cpu():
    (q, k, v) = (torch.from_numpy(a) for a in _arrays(
        6, (1, 4, 1, 32), (1, 2, 64, 32), (1, 2, 64, 32)))
    pos = torch.tensor(100, dtype=torch.int32)
    sp = ring_slot_positions(pos, 64)
    want = gqa_decode_attention(q, k, v, sp, pos, window=50)
    assert torch.equal(gqa_decode_attention(q, k, v, sp, pos, window=50,
                                            layout="ring"), want)
    with pytest.raises(ValueError, match="layout"):
        gqa_decode_attention(q, k, v, sp, pos, layout="paged")


# ----------------------------------------------------------- wrapper checks

def _flash_args(case):
    q = torch.ones((1, 4, 8, 16))
    k = torch.ones((1, 2, 8, 16))
    v = torch.ones((1, 2, 8, 16))
    kw = {}
    if case == "float64":
        q, k, v = q.double(), k.double(), v.double()
    elif case == "int":
        q, k, v = (t.to(torch.int32) for t in (q, k, v))
    elif case == "mixed_dtype":
        q = q.to(torch.bfloat16)
    elif case == "noncontig":
        q = torch.ones((1, 4, 16, 8)).transpose(2, 3)
    elif case == "heads":
        k, v = torch.ones((1, 3, 8, 16)), torch.ones((1, 3, 8, 16))
    elif case == "rank3":
        q = q[0]
    elif case == "kv_shape":
        v = torch.ones((1, 2, 9, 16))
    elif case == "head_dim_mismatch":
        k, v = torch.ones((1, 2, 8, 24)), torch.ones((1, 2, 8, 24))
    elif case == "head_dim_not_8":
        q, k, v = (torch.ones(s[:3] + (20,)) for s in (q.shape, k.shape, v.shape))
    elif case == "head_dim_over_256":
        q, k, v = (torch.ones(s[:3] + (264,)) for s in (q.shape, k.shape, v.shape))
    elif case == "smem":
        q, k, v = (torch.ones(s[:3] + (1024,)) for s in (q.shape, k.shape, v.shape))
    elif case == "window":
        kw = {"window": 0}
    elif case == "cap":
        kw = {"logit_cap": 0.0}
    elif case == "k_len":
        kw = {"k_len": 9}
    elif case == "q_offset":
        kw = {"q_offset": -1}
    return (q, k, v), kw


@pytest.mark.parametrize("case", [
    "float64", "int", "mixed_dtype", "noncontig", "heads", "rank3", "kv_shape",
    "head_dim_mismatch", "head_dim_not_8", "head_dim_over_256", "smem",
    "window", "cap", "k_len", "q_offset",
])
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(case):
    args, kw = _flash_args(case)
    with pytest.raises((TypeError, ValueError)) as err:
        flash_attention(*args, **kw)
    if case == "smem":
        assert "shared memory" in str(err.value)


def test_flash_misaligned_bf16_on_the_cpu_takes_the_plain_version():
    # only the card's TMA loads need 16-byte alignment
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to(torch.bfloat16)
               for s in ((1, 4, 16, 16), (1, 2, 16, 16), (1, 2, 16, 16)))
    q = torch.empty(q.numel() + 1, dtype=q.dtype)[1:].view(q.shape).copy_(q)
    assert q.data_ptr() % 16
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, logit_cap=50.0)
    want = flash_attention_torch(q.clone(), k, v, causal=True, logit_cap=50.0)
    assert flash_attention.launches == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _decode_args(case):
    q = torch.ones((2, 4, 1, 16))
    kc = torch.ones((2, 2, 32, 16))
    vc = torch.ones((2, 2, 32, 16))
    slot_pos = torch.arange(32, dtype=torch.int32)
    pos = torch.tensor(5, dtype=torch.int32)
    if case == "bf16_q_only":
        q = q.to(torch.bfloat16)
    elif case == "noncontig_cache":
        kc = torch.ones((2, 2, 16, 32)).transpose(2, 3)
    elif case == "heads":
        q = torch.ones((2, 3, 1, 16))
    elif case == "two_tokens":
        q = torch.ones((2, 4, 2, 16))
    elif case == "slot_pos_int64":
        slot_pos = slot_pos.long()
    elif case == "slot_pos_len":
        slot_pos = slot_pos[:31]
    elif case == "pos_int64":
        pos = pos.long()
    elif case == "pos_vector":
        pos = pos.reshape(1)
    elif case == "smem":
        q, kc, vc = (torch.ones(t.shape[:3] + (4096,)) for t in (q, kc, vc))
    elif case == "over_16_heads_a_group":
        q = torch.ones((2, 34, 1, 16))
    return q, kc, vc, slot_pos, pos


@pytest.mark.parametrize("case", [
    "bf16_q_only", "noncontig_cache", "heads", "two_tokens", "slot_pos_int64",
    "slot_pos_len", "pos_int64", "pos_vector", "smem", "over_16_heads_a_group",
])
def test_decode_wrapper_rejects_what_the_kernel_does_not_take(case):
    with pytest.raises((TypeError, ValueError)) as err:
        gqa_decode_attention(*_decode_args(case))
    if case == "smem":
        assert "shared memory" in str(err.value)


def test_plain_versions_are_the_cpu_path():
    (q, k, v) = (torch.from_numpy(a) for a in _arrays(
        3, (1, 4, 40, 32), (1, 2, 40, 32), (1, 2, 40, 32)))
    f0, d0 = flash_attention.launches, gqa_decode_attention.launches
    assert torch.equal(
        flash_attention(q, k, v, window=8, logit_cap=20.0),
        flash_attention_torch(q, k, v, window=8, logit_cap=20.0))
    qd = q[:, :, :1].contiguous()
    sp = torch.arange(40, dtype=torch.int32)
    pos = torch.tensor(30, dtype=torch.int32)
    assert torch.equal(
        gqa_decode_attention(qd, k, v, sp, pos),
        decode_attention_torch(qd.view(1, 2, 2, 32), k, v, sp, pos)
        .view(1, 4, 1, 32))
    assert (flash_attention.launches, gqa_decode_attention.launches) == (f0, d0)


def test_fully_masked_rows_are_zero():
    # no visible key: l = 0, out = acc / max(l, 1e-30) = 0, in both plain
    # versions as in the kernels
    q, k, v = (torch.from_numpy(a) for a in _arrays(
        4, (1, 2, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16)))
    out = flash_attention(q, k, v, causal=False, k_len=0)
    assert torch.equal(out, torch.zeros_like(out))
    out = gqa_decode_attention(q[:, :, :1].contiguous(), k, v,
                               torch.full((8,), -1, dtype=torch.int32),
                               torch.tensor(3, dtype=torch.int32))
    assert torch.equal(out, torch.zeros_like(out))


# ---------------------------------------------- the merge of split caches

# A cache cut into spans of uneven lengths, as ranks holding spans of its
# slots see it: (S, span starts, pos, window, softcap, ring).  Each case
# has a span whose slots are all unseen (past pos, before the window, or
# never written), whose partial must weigh nothing.
MERGE_SPANS = {
    "full_two_spans_one_empty": (40, [0, 23], 20, None, None, False),
    "full_three_uneven": (48, [0, 5, 31], 25, None, 50.0, False),
    "full_window_empty_head": (64, [0, 7, 30, 41], 60, 16, None, False),
    "ring_wrapped_window_cap": (32, [0, 3, 14, 26], 45, 20, 30.0, True),
    "ring_never_written_tail": (32, [0, 9, 20], 12, 24, None, True),
}


def _merge(parts):
    """The attention over every span from each span's (out, lse): with M
    the max lse and w = exp(lse - M), sum w out / sum w (the ranks' merge,
    ``tensor_parallel.merge_partials``)."""
    lse = torch.stack([p[1] for p in parts])
    w = torch.exp(lse - lse.amax(dim=0))
    num = sum(wi[..., None] * p[0].float() for wi, p in zip(w, parts))
    return num / w.sum(dim=0)[..., None]


@pytest.mark.parametrize("name", list(MERGE_SPANS))
def test_decode_partials_over_spans_merge_to_the_whole_call(name):
    S, starts, pos, window, cap, ring = MERGE_SPANS[name]
    B, KV, G, hd = 2, 2, 3, 32
    q, k, v = (torch.from_numpy(a) for a in _arrays(
        zlib.crc32(name.encode()), (B, KV, G, hd), (B, KV, S, hd), (B, KV, S, hd)))
    p = torch.tensor(pos, dtype=torch.int32)
    sp = ring_slot_positions(p, S) if ring else torch.arange(S, dtype=torch.int32)
    kw = dict(window=window, logit_cap=cap)
    whole, whole_lse = decode_attention_torch(q, k, v, sp, p, **kw, return_lse=True)
    assert torch.equal(whole, decode_attention_torch(q, k, v, sp, p, **kw))
    # the log-sum-exp is logsumexp over the seen, scaled, softcapped scores
    s = torch.einsum("bngh,bnch->bngc", q, k) * hd ** -0.5
    if cap:
        s = cap * torch.tanh(s / cap)
    seen = (sp >= 0) & (sp <= pos) & ((sp > pos - window) if window else True)
    torch.testing.assert_close(whole_lse, torch.logsumexp(s[..., seen], dim=-1),
                               rtol=1e-6, atol=1e-6)
    parts, empty = [], 0
    for a, b in zip(starts, starts[1:] + [S]):
        out, lse = decode_attention_torch(q, k[:, :, a:b], v[:, :, a:b], sp[a:b], p, **kw,
                                          return_lse=True)
        if not seen[a:b].any():
            empty += 1
            assert torch.equal(lse, torch.full_like(lse, -torch.inf))
            assert torch.equal(out, torch.zeros_like(out))
        parts.append((out, lse))
    assert empty >= 1
    torch.testing.assert_close(_merge(parts), whole, rtol=1e-6, atol=1e-6)
    # the wrapper's CPU path, in the model's layout, gives the same pair
    got, got_lse = gqa_decode_attention(q.reshape(B, KV * G, 1, hd), k, v, sp, p, **kw,
                                        return_lse=True)
    assert torch.equal(got, whole.reshape(B, KV * G, 1, hd))
    assert torch.equal(got_lse, whole_lse.reshape(B, KV * G, 1))


def test_decode_lse_of_a_row_that_sees_nothing_is_minus_inf():
    q, k, v = (torch.from_numpy(a) for a in _arrays(
        5, (1, 2, 4, 16), (1, 2, 8, 16), (1, 2, 8, 16)))
    out, lse = gqa_decode_attention(q.reshape(1, 8, 1, 16), k, v,
                                    torch.full((8,), -1, dtype=torch.int32),
                                    torch.tensor(3, dtype=torch.int32), return_lse=True)
    assert torch.equal(out, torch.zeros_like(out)) and lse.shape == (1, 8, 1)
    assert torch.equal(lse, torch.full_like(lse, -torch.inf))
