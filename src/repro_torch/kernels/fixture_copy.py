"""``fixture_copy`` on Hopper: the CUDA kernel's launcher, its launch
geometry, and its plain version.

The kernel (``csrc/fixture_copy.cu``) replaces the kernel of the reference
analyzer's known-bad launch fixture,
``repro/analysis/fixtures.py::_bad_pallas_probe`` (``o_ref[...] =
x_ref[...]``): a copy of a contiguous fp32 (R, C) tensor, one CTA per
(tile_r, tile_c) tile, guarded against the tensor's edge.  The analyzer's
``launch-geometry`` checker flags faulty grids for it without a card; the
port's fixtures launch one of them, so the card shows which elements a
faulty grid leaves unwritten.

:func:`fixture_copy_torch` is the plain version: ``x.clone()`` under a grid
that covers the tensor, and a copy of just the tiles a given grid covers
otherwise.  The CPU path of :func:`repro_torch.kernels.fixture_copy` and the
tests use it; on the card it is what the kernel is held to.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import LaunchSpec, check, launch, load

__all__ = ["PATHS", "coverage", "fixture_copy_cuda", "fixture_copy_torch",
           "geometry", "launch_spec", "route"]

THREADS = 256
#: the kernel's paths, by the code its launcher reports
PATHS = ("scalar", "vector")

_SIGNATURES = {"fixture_copy_f32": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]}
_FN: dict[str, object] = {}     # the loaded C entry point


def route(R: int, C: int, tile: tuple[int, int], *ptrs: int) -> str:
    """The path the launcher takes (``csrc/fixture_copy.cu``): ``"vector"``
    (16-byte float4s) where C and the tile's width are multiples of 4 and
    every address in ``ptrs`` (x's and out's) is 16-byte aligned,
    ``"scalar"`` otherwise."""
    if C % 4 == 0 and tile[1] % 4 == 0 and all(p % 16 == 0 for p in ptrs):
        return "vector"
    return "scalar"


def launch_spec(R: int, C: int, tile: tuple[int, int]) -> LaunchSpec:
    """One CTA of 256 threads per tile, the grid by ceiling division: x over
    the row tiles, y over the column tiles."""
    tr, tc = tile
    return LaunchSpec(grid=(-(-R // tr), -(-C // tc), 1), block=(THREADS, 1, 1),
                      smem_bytes=0)


def coverage(R: int, C: int, tile: tuple[int, int]
             ) -> tuple[tuple[int, int, int], tuple[int, int, int]]:
    """What the grid must cover, per grid axis (x, y, z): the R rows and C
    columns, and what one CTA covers of them: one tile.  The kernel masks
    the elements past the tensor's edge."""
    return (R, C, 1), (tile[0], tile[1], 1)


@functools.lru_cache(maxsize=256)
def geometry(R: int, C: int, tile: tuple[int, int],
             grid: tuple[int, int] | None = None):
    """(spec, shape, tile) of one launch, kept per shape: ``grid=None``
    launches :func:`launch_spec`'s ceiling grid, a given grid as it is;
    ``shape`` and ``tile`` are :func:`coverage`'s."""
    spec = (launch_spec(R, C, tile) if grid is None else
            LaunchSpec(grid=(*grid, 1), block=(THREADS, 1, 1), smem_bytes=0))
    return (spec, *coverage(R, C, tile))


def fixture_copy_cuda(x: torch.Tensor, out: torch.Tensor, spec: LaunchSpec,
                      tile: tuple[int, int]) -> str:
    """Launch the kernel with ``spec`` on the current stream; no checks, no
    synchronise.  Returns the path the launcher took (:data:`PATHS`).
    Callers go through :func:`repro_torch.kernels.fixture_copy`, which
    checks shapes, types and devices."""
    fn = _FN.get("f32")
    if fn is None:
        fn = _FN["f32"] = load("fixture_copy", _SIGNATURES).fixture_copy_f32
    path = ctypes.c_int(-1)
    err = launch(fn, (x.data_ptr(), out.data_ptr(), *x.shape, *tile, spec.grid[0],
                      spec.grid[1], spec.block[0], ctypes.byref(path)), x.device)
    check(err, "fixture_copy")
    return PATHS[path.value]


def fixture_copy_torch(
    x: torch.Tensor, tile: tuple[int, int],
    grid: tuple[int, int] | None = None, out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version: ``x.clone()`` when ``grid`` is None (the ceiling
    grid, which covers x); under a given grid, the rows and columns its
    tiles cover are copied into ``out`` (a NaN-filled tensor by default) and
    every other element keeps its value."""
    if grid is None:
        if out is None:
            return x.clone()
        return out.copy_(x)
    if out is None:
        out = torch.full_like(x, float("nan"))
    rows = min(x.shape[0], grid[0] * tile[0])
    cols = min(x.shape[1], grid[1] * tile[1])
    out[:rows, :cols] = x[:rows, :cols]
    return out
