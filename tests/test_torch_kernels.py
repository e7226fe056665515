"""The port's ``seg_combine`` against the JAX package's, on the CPU, and the
CPU side of ``fixture_copy`` (the kernel of the analyzer's known-bad launch
fixture; ``tests/test_torch_analysis.py`` holds it to the Pallas kernel).
The last tests hold the kernels' build and launch path: the shared header
``csrc/hopper.cuh``, the build's hash of it, and the launchers' one route
to the card through ``_build.launch``.

On the CPU the port's wrapper takes the kernel's plain PyTorch version; the
JAX side runs its Pallas kernel in interpret mode, as ``tests/test_kernels.py``
does.  ``reduce_plan`` repeats the CUDA kernel's reduction (its routes, its
association and its global atomics) on the CPU and is held to both.
Tolerance rtol 1e-4 / atol 1e-3, the reference's: the sums are taken in
different orders (the CUDA kernel's fp32 atomics land in an order that
changes from run to run).  Sums of ones (pair counts) are exact.
"""

import importlib
import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import seg_combine as j_seg_combine
from repro.kernels.ref import seg_combine_ref as j_seg_combine_ref
from repro_torch.analysis.checkers.launch_geometry import validate_launch
from repro_torch.kernels import _build, fixture_copy, seg_combine
from repro_torch.kernels.fixture_copy import coverage as fixture_coverage
from repro_torch.kernels.fixture_copy import launch_spec as fixture_launch_spec
from repro_torch.kernels.fixture_copy import route as fixture_route
from repro_torch.kernels.seg_combine import (
    PASS,
    coverage,
    launch_spec,
    reduce_plan,
    route,
    rows_per_cta,
    seg_combine_torch,
)
from repro_torch.mapreduce import JOBS, make_input
from repro_torch.mapreduce.engine import _hash_partition

# the modules (the package exports functions of the same names)
_da = importlib.import_module("repro_torch.kernels.decode_attention")
_fa = importlib.import_module("repro_torch.kernels.flash_attention")
_mla = importlib.import_module("repro_torch.kernels.mla_decode")

SHAPES = [(1024, 256, 16), (777, 130, 7), (64, 8, 3)]
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(n, d, p, seed, lo=0):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((n, d)).astype(np.float32)
    ids = rng.integers(lo, p, n).astype(np.int32)
    return vals, ids


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,d,p", SHAPES)
def test_plain_matches_pallas_interpret(n, d, p, dtype):
    t_dt, j_dt = DTYPES[dtype]
    vals, ids = _inputs(n, d, p, seed=n + d)
    got = seg_combine(torch.from_numpy(vals).to(t_dt), torch.from_numpy(ids), p)
    want = np.asarray(j_seg_combine(jnp.asarray(vals, j_dt), jnp.asarray(ids), p))
    assert got.dtype == torch.float32 and got.shape == (p, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n,d,p", SHAPES)
def test_plain_drops_negative_ids_like_pallas(n, d, p):
    vals, ids = _inputs(n, d, p, seed=3, lo=-1)
    assert (ids < 0).any()
    got = seg_combine(torch.from_numpy(vals), torch.from_numpy(ids), p)
    want = np.asarray(j_seg_combine(jnp.asarray(vals), jnp.asarray(ids), p))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


def test_ids_at_or_above_p_are_dropped():
    # the Pallas kernel's one-hot never matches an id >= P, so it drops it;
    # the reference's jnp oracle clips it into row P-1 instead.  The port
    # follows the kernel.
    vals = np.ones((96, 2), np.float32)
    ids = (np.arange(96) % 6).astype(np.int32)        # P = 4: ids 4, 5 too big
    got = seg_combine(torch.from_numpy(vals), torch.from_numpy(ids), 4)
    pallas = np.asarray(j_seg_combine(jnp.asarray(vals), jnp.asarray(ids), 4))
    np.testing.assert_array_equal(got.numpy(), np.full((4, 2), 16.0))
    np.testing.assert_array_equal(got.numpy(), pallas)
    oracle = np.asarray(j_seg_combine_ref(jnp.asarray(vals), jnp.asarray(ids), 4))
    assert oracle[3, 0] == 16.0 + 32.0


def test_negative_ids_dropped_exactly():
    vals = torch.ones((128, 8))
    ids = torch.where(torch.arange(128) % 2 == 0, 0, -1).to(torch.int32)
    out = seg_combine(vals, ids, 4)
    assert out[0, 0] == 64.0 and out[1:].sum() == 0.0


def test_pair_counts_exact():
    n, p = 640_000, 10
    ids = torch.from_numpy((np.arange(n) % p).astype(np.int32))
    counts = seg_combine(torch.ones((n, 1)), ids, p)
    assert torch.equal(counts[:, 0], torch.full((p,), float(n // p)))


def test_engine_shape_with_sorted_ids():
    # the engine's call: D = 1, ids = np.unique's inverse (sorted keys)
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 700, 20_000)
    uniq, inverse = np.unique(keys, return_inverse=True)
    vals = rng.random(20_000, dtype=np.float32)
    got = seg_combine(torch.from_numpy(vals[:, None]),
                      torch.from_numpy(inverse.astype(np.int32)), len(uniq))
    want = np.zeros(len(uniq), np.float64)
    np.add.at(want, inverse, vals)
    np.testing.assert_allclose(got[:, 0].numpy(), want, rtol=1e-5)


def test_plain_version_is_the_cpu_path():
    vals, ids = _inputs(300, 5, 9, seed=11, lo=-1)
    v, i = torch.from_numpy(vals), torch.from_numpy(ids)
    before = seg_combine.launches
    assert torch.equal(seg_combine(v, i, 9), seg_combine_torch(v, i, 9))
    assert seg_combine.launches == before      # no kernel launch on the CPU


@pytest.mark.parametrize("case", [
    "float64", "int_values", "rank1", "rank3", "ids_int64", "ids_rank2",
    "ids_len", "noncontig", "neg_p",
])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    v = torch.ones((8, 4))
    i = torch.zeros(8, dtype=torch.int32)
    p = 3
    if case == "float64":
        v = v.double()
    elif case == "int_values":
        v = v.to(torch.int32)
    elif case == "rank1":
        v = v[:, 0].contiguous()
    elif case == "rank3":
        v = v[None]
    elif case == "ids_int64":
        i = i.long()
    elif case == "ids_rank2":
        i = i[:, None]
    elif case == "ids_len":
        i = i[:5]
    elif case == "noncontig":
        v = torch.ones((4, 8)).t()
    elif case == "neg_p":
        p = -1
    with pytest.raises((TypeError, ValueError)):
        seg_combine(v, i, p)


def test_empty_inputs():
    out = seg_combine(torch.zeros((0, 3)), torch.zeros(0, dtype=torch.int32), 4)
    assert out.shape == (4, 3) and out.abs().sum() == 0.0
    out = seg_combine(torch.ones((5, 3)), torch.zeros(5, dtype=torch.int32), 0)
    assert out.shape == (0, 3)



# ------------------------------------------------------------ launch geometry

@pytest.mark.parametrize("n,d,p,kind", [
    (262_144, 1, 4_128, "bins"),               # the engine's spill
    (1024, 256, 16, "columns"),
    (777, 130, 7, "columns"),
    (1, 1, 1, "bins"),
    (1_342_176, 1, 8_192, "bins"),             # the distributed caller
    (262_144, 1, 100_000, "global"),           # P past the shared-memory bins
])
def test_launch_spec_covers_the_rows_per_cta(n, d, p, kind):
    assert route(n, d, p) == kind
    spec = launch_spec(n, d, p)
    shape, tile = coverage(n, d, p)
    rows = rows_per_cta(n, d, p)
    assert shape == (n, d, 1) and tile[0] == rows and tile[2] == 1
    assert (spec.grid[0] - 1) * rows < n <= spec.grid[0] * rows
    if kind == "columns":
        assert spec.block == (128, 1, 1) and spec.smem_bytes == 0 and rows == 64
        assert tile[1] == 128 and (spec.grid[1] - 1) * 128 < d <= spec.grid[1] * 128
    else:
        assert spec.block == (256, 1, 1) and spec.grid[1:] == (1, 1)
        assert rows % PASS == 0 and tile[1] == d == 1
        assert spec.smem_bytes == (4 * p if kind == "bins" else 0)
    assert validate_launch("seg_combine", spec, shape, tile) == []


# ------------------------------------------------ reduce_plan (the CPU mirror)

def _plan_ids(rng, n, p, order):
    """Ids for ``order``: sorted, unsorted, skewed (half of the rows in 64
    hot keys, unsorted, as the wordcount map emits them), or dropped and
    dropped_unsorted (ids < 0 and >= P among them, sorted or not)."""
    if order == "dropped":
        return np.sort(rng.integers(-3, p + 3, n)).astype(np.int32)
    if order == "dropped_unsorted":
        return rng.integers(-3, p + 3, n).astype(np.int32)
    ids = rng.integers(0, p, n)
    if order == "skewed":
        ids = np.where(rng.random(n) < 0.5, rng.integers(0, 64, n), ids)
    return (np.sort(ids) if order == "sorted" else ids).astype(np.int32)


@pytest.mark.parametrize("order", ["sorted", "unsorted", "skewed", "dropped",
                                   "dropped_unsorted"])
@pytest.mark.parametrize("n,d,p,kind", [
    (5_003, 1, 300, "bins"),                   # N off the 8-row vector width
    (5_003, 1, 300, "global"),
    (1_001, 3, 70, "columns"),
])
def test_reduce_plan_matches_pallas_and_plain(n, d, p, kind, order):
    rng = np.random.default_rng(n + p + len(order))
    vals = rng.standard_normal((n, d)).astype(np.float32)
    ids = _plan_ids(rng, n, p, order)
    v, i = torch.from_numpy(vals), torch.from_numpy(ids)
    plan = reduce_plan(v, i, p, kind)
    assert plan.route == kind and plan.out.shape == (p, d)
    pallas = np.asarray(j_seg_combine(jnp.asarray(vals), jnp.asarray(ids), p))
    np.testing.assert_allclose(plan.out.numpy(), pallas, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(plan.out.numpy(), seg_combine_torch(v, i, p).numpy(),
                               rtol=1e-4, atol=1e-3)
    ones = torch.ones((n, d))
    assert torch.equal(reduce_plan(ones, i, p, kind).out, seg_combine_torch(ones, i, p))


def _engine_spill(n_records=20_000, reducers=8):
    """A spill as the engine's ``_combine`` gets it: the wordcount map's
    pairs, hash-partitioned, lexsorted by (partition, key), and
    ``np.unique``'s inverse of the (partition, key) pairs."""
    job = JOBS["wordcount"]
    keys, values = make_input(job, n_records, seed=3)
    okeys, _ = job.map_fn(keys, values)
    part = _hash_partition(okeys, reducers)
    order = np.lexsort((okeys, part))
    uniq, inverse = np.unique(np.stack([part[order], okeys[order]], 1), axis=0,
                              return_inverse=True)
    return torch.from_numpy(inverse.reshape(-1).astype(np.int32)), len(uniq)


@pytest.mark.parametrize("kind", ["bins", "global"])
def test_a_sorted_spill_needs_at_most_p_plus_ctas_atomics(kind):
    ids, p = _engine_spill()
    n = ids.numel()
    plan = reduce_plan(torch.ones((n, 1)), ids, p, kind)
    assert plan.passes == plan.ctas * rows_per_cta(n, 1, p, kind) // PASS
    assert plan.atomics <= p + plan.passes
    # a sorted spill leaves a few chains a pass: every pass adds to out
    assert plan.bins_passes == 0
    assert torch.equal(plan.out[:, 0], torch.bincount(ids.long(), minlength=p).float())


def test_bins_flush_each_id_once_per_cta_on_unsorted_ids():
    # the distributed caller's ids: words mod 8,192, unsorted, half of them
    # in 64 hot keys; straight to global memory the scan's sums would add
    # about once a row
    job = JOBS["wordcount"]
    words, _ = job.map_fn(*make_input(job, 50_000, seed=4))
    ids = torch.from_numpy((words % 8_192).astype(np.int32))
    ones = torch.ones((ids.numel(), 1))
    binned = reduce_plan(ones, ids, 8_192)
    direct = reduce_plan(ones, ids, 8_192, "global")
    assert binned.route == "bins" and binned.bins_passes == binned.passes > 0
    assert binned.atomics <= 8_192 * binned.ctas
    assert binned.atomics < direct.atomics // 2
    for plan in (binned, direct):
        assert torch.equal(plan.out, seg_combine_torch(ones, ids, 8_192))


# ------------------------------------------- fixture_copy (_bad_pallas_probe)

@pytest.mark.parametrize("shape,tile", [((4, 1000), (1, 300)),
                                        ((33, 70), (8, 32)), ((1, 1), (4, 4))])
def test_fixture_copy_plain_is_a_clone_under_the_ceiling_grid(shape, tile):
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(shape)
                         .astype(np.float32))
    before = (fixture_copy.launches, len(fixture_copy.geometries))
    assert torch.equal(fixture_copy(x, tile), x.clone())
    out = torch.full_like(x, 7.0)
    assert fixture_copy(x, tile, out=out) is out and torch.equal(out, x)
    assert (fixture_copy.launches, len(fixture_copy.geometries)) == before
    spec = fixture_launch_spec(*shape, tile)
    assert spec.grid == (-(-shape[0] // tile[0]), -(-shape[1] // tile[1]), 1)
    assert fixture_coverage(*shape, tile) == ((*shape, 1), (*tile, 1))


def test_fixture_copy_under_a_given_grid_copies_only_its_tiles():
    x = torch.arange(4000, dtype=torch.float32).reshape(4, 1000)
    got = fixture_copy(x, (1, 300), grid=(4, 3))
    assert torch.isnan(got[:, 900:]).all()
    assert torch.equal(got[:, :900], x[:, :900])
    got = fixture_copy(x, (1, 300), grid=(2, 4))
    assert torch.isnan(got[2:]).all() and torch.equal(got[:2], x[:2])


@pytest.mark.parametrize("case", ["float64", "rank3", "noncontig", "tile0",
                                  "tile3", "grid0", "out_shape", "out_dtype"])
def test_fixture_copy_rejects_what_the_kernel_does_not_take(case):
    x, tile, kw = torch.ones((4, 8)), (1, 4), {}
    if case == "float64":
        x = x.double()
    elif case == "rank3":
        x = x[None]
    elif case == "noncontig":
        x = torch.ones((8, 4)).t()
    elif case == "tile0":
        tile = (0, 4)
    elif case == "tile3":
        tile = (1, 2, 3)
    elif case == "grid0":
        kw = {"grid": (4, 0)}
    elif case == "out_shape":
        kw = {"out": torch.ones((4, 9))}
    elif case == "out_dtype":
        kw = {"out": torch.ones((4, 8), dtype=torch.float64)}
    with pytest.raises(ValueError):
        fixture_copy(x, tile, **kw)


@pytest.mark.parametrize("shape,tile,ptrs,path", [
    ((16_384, 4096), (16, 512), (0, 1 << 20), "vector"),   # the timing shape
    ((4, 1000), (1, 300), (256, 512), "vector"),           # the fixture's
    ((333, 1001), (8, 100), (0, 0), "scalar"),             # C off 4
    ((64, 1024), (3, 30), (0, 0), "scalar"),               # tile_c off 4
    ((64, 1024), (16, 512), (4, 0), "scalar"),             # x off 16 bytes
    ((64, 1024), (16, 512), (0, 8), "scalar"),             # out off 16 bytes
])
def test_fixture_copy_route(shape, tile, ptrs, path):
    assert fixture_route(*shape, tile, *ptrs) == path


# ------------------------------------------------------------ build and launch

def test_a_header_edit_builds_every_kernel_anew(tmp_path, monkeypatch):
    """The library's name hashes every ``csrc/*.cuh`` beside the source: an
    edit to a header that a source includes must not load the old build."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "hopper.cuh"\n')
    (csrc / "hopper.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "_CSRC", csrc)
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "build")
    src, before = _build._target("k")
    assert src == csrc / "k.cu" and before.parent == tmp_path / "build"
    assert _build._target("k")[1] == before
    (csrc / "hopper.cuh").write_text("// two\n")
    after = _build._target("k")[1]
    assert after != before and after.name.startswith("k_")
    (csrc / "other.cuh").write_text("// three\n")
    assert _build._target("k")[1] not in (before, after)


_CSRC = _build._CSRC
_ATTENTION_SOURCES = ("decode_attention", "flash_attention", "flash_attention_wgmma",
                      "mla_decode")


def _defined(text: str) -> set[str]:
    """The names a CUDA source defines at namespace scope (its column-0
    lines): functions, constants, structs and type aliases."""
    names = set()
    for line in text.splitlines():
        if not line or line[0] in " #/}" or line.startswith(("namespace", "template")):
            continue
        m = (re.match(r"constexpr\b[^=(]*?\b(\w+)\s*=", line)
             or re.match(r"(?:struct|using)\s+(\w+)", line)
             or re.match(r"(?:[\w:<>*&]+\s+)*?(\w+)\s*\(", line))
        if m:
            names.add(m.group(1))
    return names


def test_no_source_redefines_what_hopper_cuh_defines():
    """The PTX wrappers and host helpers live once, in ``hopper.cuh``: no
    source defines one of them again, the four attention sources include
    it, and no source sets a shared-memory limit but through its
    ``set_smem_limit``."""
    shared = _defined((_CSRC / "hopper.cuh").read_text())
    assert {"smem_u32", "cp_async16", "cp_async_commit", "cp_async_wait", "mbar_init",
            "mbar_expect_tx", "mbar_arrive", "mbar_wait", "tma_load_3d",
            "tma_load_3d_cache_hint", "ldsm_x4", "mma_bf16", "pack_bf16",
            "pack_bf16_rn", "xor_reduce", "aligned16", "set_smem_limit",
            "encode_tiled", "kFull", "kMaxDevices"} <= shared
    sources = sorted(_CSRC.glob("*.cu"))
    assert {p.stem for p in sources} >= set(_ATTENTION_SOURCES)
    for path in sources:
        text = path.read_text()
        assert not _defined(text) & shared, (path.name, _defined(text) & shared)
        assert "cudaFuncSetAttribute" not in text, path.name
        if path.stem in _ATTENTION_SOURCES:
            assert '#include "hopper.cuh"' in text, path.name


def _fake_load(source, signatures):
    """A stand-in for a loaded library: each C function only carries its
    ``argtypes``."""
    return SimpleNamespace(**{fn: SimpleNamespace(argtypes=argtypes)
                              for fn, argtypes in signatures.items()})


def _launchers():
    g = torch.Generator().manual_seed(0)

    def flash(dtype):
        q = torch.randn((1, 4, 24, 64), generator=g).to(dtype)
        k = torch.randn((1, 2, 24, 64), generator=g).to(dtype)
        spec = _fa.launch_spec(1, 4, 2, 24, 64, dtype)
        return q.device, lambda: _fa.flash_attention_cuda(
            q, k, k, causal=True, window=None, logit_cap=None, q_offset=0, k_len=24,
            spec=spec)

    def decode(dtype):
        q = torch.randn((2, 2, 3, 64), generator=g).to(dtype)
        kc = torch.randn((2, 2, 40, 64), generator=g).to(dtype)
        slot_pos = torch.arange(40, dtype=torch.int32)
        pos = torch.tensor(17, dtype=torch.int32)
        spec = _da.launch_spec(2, 2, 3, 40, 64, dtype)
        return q.device, lambda: _da.decode_attention_cuda(
            q, kc, kc, slot_pos, pos, window=None, logit_cap=None, layout="full",
            spec=spec, return_lse=True)

    def mla():
        q = torch.randn((2, 16, 576), generator=g).bfloat16()
        lat = torch.randn((2, 70, 576), generator=g).bfloat16()
        pos = torch.tensor(69, dtype=torch.int32)
        spec = _mla.launch_spec(2, 70, 576)
        return q.device, lambda: _mla.mla_decode_cuda(q, lat, pos, scale=0.1, v_dim=512,
                                                      spec=spec)

    return {"flash-f32": (_fa, lambda: flash(torch.float32)),
            "flash-bf16": (_fa, lambda: flash(torch.bfloat16)),
            "decode-f32": (_da, lambda: decode(torch.float32)),
            "decode-bf16": (_da, lambda: decode(torch.bfloat16)),
            "mla": (_mla, mla)}


@pytest.mark.parametrize("name", list(_launchers()))
def test_every_attention_launcher_goes_through_build_launch(name, monkeypatch):
    """Each attention launcher makes its one C call through
    ``_build.launch`` (PyTorch's current stream, on the inputs' device),
    with as many arguments as the C function takes, the stream last."""
    module, make = _launchers()[name]
    calls = []

    def fake_launch(fn, args, device):
        calls.append((fn, args, device))
        return 0

    monkeypatch.setattr(module, "load", _fake_load)
    monkeypatch.setattr(module, "launch", fake_launch)
    monkeypatch.setattr(_build, "_SCRATCH", {})
    device, run = make()
    run()
    assert len(calls) == 1
    fn, args, dev = calls[0]
    assert dev == device and isinstance(args, tuple)
    assert len(args) + 1 == len(fn.argtypes)    # the stream comes last
