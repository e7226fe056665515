"""The port's ``seg_combine`` against the JAX package's, on the CPU, and the
CPU side of ``fixture_copy`` (the kernel of the analyzer's known-bad launch
fixture; ``tests/test_torch_analysis.py`` holds it to the Pallas kernel).

On the CPU the port's wrapper takes the kernel's plain PyTorch version; the
JAX side runs its Pallas kernel in interpret mode, as ``tests/test_kernels.py``
does.  Tolerance rtol 1e-4 / atol 1e-3, the reference's: the two sum in
different orders (the CUDA kernel with fp32 atomics, in an order that
changes from run to run).  Sums of ones (pair counts) are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import seg_combine as j_seg_combine
from repro.kernels.ref import seg_combine_ref as j_seg_combine_ref
from repro_torch.kernels import fixture_copy, seg_combine
from repro_torch.kernels.fixture_copy import coverage as fixture_coverage
from repro_torch.kernels.fixture_copy import launch_spec as fixture_launch_spec
from repro_torch.kernels.seg_combine import coverage, launch_spec, seg_combine_torch

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

@pytest.mark.parametrize("n,d", [(262_144, 1), (1024, 256), (777, 130), (1, 1)])
def test_launch_spec_takes_one_thread_per_element(n, d):
    spec = launch_spec(n, d)
    shape, tile = coverage(n, d)
    assert spec.block == (256, 1, 1) and spec.smem_bytes == 0
    assert shape == (n * d, 1, 1) and tile == (256, 1, 1)
    assert (spec.grid[0] - 1) * 256 < n * d <= spec.grid[0] * 256
    assert spec.grid[1:] == (1, 1)


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
