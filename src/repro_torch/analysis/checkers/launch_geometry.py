"""launch-geometry: the port's CUDA launch geometry, checked without a card.

The counterpart of the reference's ``pallas-kernel`` checker
(``repro/analysis/checkers/pallas_kernel.py``).  A Pallas launch is a grid
of ``BlockSpec`` index maps, checked by intercepting ``pl.pallas_call``.  A
CUDA kernel of the port computes its own offsets from ``blockIdx`` and
masks the ragged edge itself, so what can go wrong is the launch: a grid
too small to cover the data, a grid that reaches past it in a kernel that
does not mask, or a block, grid or shared-memory size the card refuses.
Each kernel module of :mod:`repro_torch.kernels` computes its
:class:`~repro_torch.kernels._build.LaunchSpec` in Python (``launch_spec``)
and says what its grid must cover (``coverage``): the index space per grid
axis (x, y, z) and what one CTA covers of it.  :func:`validate_launch`
checks the two against each other and against the H100's limits:

==================  ======================================================
``coverage``        grid x tile leaves elements unwritten (named)
``overrun``         grid x tile reaches past the data in a kernel with no
                    tail guard
``block_threads``   more than 1,024 threads a block, or not a multiple of 32
``grid_limit``      grid x above 2^31 - 1, y or z above 65,535, or below 1
``smem_limit``      above 232,448 bytes of shared memory a block
==================  ======================================================

:data:`KERNEL_PROBES` holds each kernel's canonical launches (the
reference's probe shapes and the main paths' shapes); :func:`check_recorded`
checks the geometries the wrappers of :mod:`repro_torch.kernels.ops` really
launched (``<wrapper>.geometries``).  Nothing here needs a card.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..findings import Finding

__all__ = ["run", "validate_launch", "unwritten", "probe_kernels",
           "recorded", "check_recorded", "LaunchProbe", "KERNEL_PROBES",
           "HEAD_DIMS", "MAX_THREADS", "MAX_GRID_X", "MAX_GRID_YZ"]

MAX_THREADS = 1024
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_YZ = 65_535
_AXES = "xyz"

_HINT = (
    "compute the grid by ceiling division of the data by what one CTA "
    "covers (launch_spec), guard the ragged edge in the kernel, and keep "
    "blocks to multiples of 32 threads up to 1,024"
)


@dataclass(frozen=True)
class LaunchProbe:
    """One launch to check: a kernel's spec and what its grid must cover."""

    kernel: str
    spec: object                        # kernels._build.LaunchSpec
    shape: tuple[int, int, int]         # index space per grid axis (x, y, z)
    tile: tuple[int, int, int]          # what one CTA covers, per grid axis
    guarded: bool = True                # the kernel masks past ``shape``


def unwritten(spec, shape, tile) -> list[tuple[int, int, int]]:
    """``(axis, start, stop)`` for each grid axis whose CTAs cover fewer
    indices than ``shape`` has: indices ``start..stop-1`` of that axis are
    never written."""
    return [(a, g * t, s) for a, (g, t, s) in
            enumerate(zip(spec.grid, tile, shape)) if g * t < s]


def _slice_text(shape, axis: int, start: int, stop: int) -> str:
    dims = [":"] * len(shape)
    dims[axis] = f"{start}:{stop}"
    return f"[{', '.join(dims)}]"


def validate_launch(name: str, spec, shape, tile, *, guarded: bool = True,
                    location: str | None = None) -> list[Finding]:
    """All geometry findings for one launch of kernel ``name``.

    ``shape`` is the index space the grid must cover, one extent per grid
    axis (x, y, z); ``tile`` is what one CTA covers of it; ``guarded`` says
    whether the kernel masks indices past ``shape``.
    """
    from repro_torch.kernels._build import MAX_SMEM_BYTES

    where = location or f"{name} launch grid={spec.grid} block={spec.block}"
    findings: list[Finding] = []

    def add(kind, message):
        findings.append(Finding(
            checker="launch-geometry", target=name, kind=kind,
            message=message, location=where, hint=_HINT))

    for a, start, stop in unwritten(spec, shape, tile):
        add("coverage",
            f"grid.{_AXES[a]} {spec.grid[a]} x tile {tile[a]} = {start} < "
            f"{stop}: elements {_slice_text(shape, a, start, stop)} of the "
            f"{tuple(shape)} index space are never written")
    if not guarded:
        for a, (g, t, s) in enumerate(zip(spec.grid, tile, shape)):
            if g * t > s:
                add("overrun",
                    f"grid.{_AXES[a]} {g} x tile {t} = {g * t} > {s}: CTAs "
                    f"reach indices {s}..{g * t - 1} of axis {_AXES[a]}, past "
                    "the data, in a kernel with no tail guard")
    threads = spec.block[0] * spec.block[1] * spec.block[2]
    if threads > MAX_THREADS or threads % 32 or threads < 1:
        add("block_threads",
            f"block {spec.block} has {threads} threads: a block takes 32 to "
            f"{MAX_THREADS} in whole warps of 32")
    limits = (MAX_GRID_X, MAX_GRID_YZ, MAX_GRID_YZ)
    for a, (g, lim) in enumerate(zip(spec.grid, limits)):
        if not 1 <= g <= lim:
            add("grid_limit",
                f"grid.{_AXES[a]} = {g}, outside the card's 1..{lim}")
    if spec.smem_bytes > MAX_SMEM_BYTES:
        add("smem_limit",
            f"{spec.smem_bytes} bytes of shared memory, above the "
            f"{MAX_SMEM_BYTES} a block can have on an H100")
    return findings


# ---------------------------------------------------------------------------
# canonical launches of each kernel
# ---------------------------------------------------------------------------

#: head dims every attention probe runs at
HEAD_DIMS = (16, 64, 80, 128, 256)


def _flash_probes(hds=HEAD_DIMS) -> list[LaunchProbe]:
    import torch

    from repro_torch.kernels.flash_attention import coverage, launch_spec

    out = []
    # (B, H, KV, Sq): the reference's probe, gemma2-9b prefill B 4 x 512
    # and the 4608-token prompt of generate; each for both kernels (fp32 as
    # split TF32 on mma.sync, bf16 on wgmma), whose grids differ
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, KV, Sq in ((1, 2, 1, 256), (4, 16, 8, 512), (1, 16, 8, 4608)):
            for hd in hds:
                out.append(LaunchProbe("flash_attention",
                                       launch_spec(B, H, KV, Sq, hd, dtype),
                                       *coverage(B, H, KV, Sq, dtype, hd)))
    return out


def _decode_probes(hds=HEAD_DIMS) -> list[LaunchProbe]:
    from repro_torch.kernels.decode_attention import coverage, launch_spec

    out = []
    # (B, KV, G, S): the reference's probe, gemma2-9b decode over caches
    # of 1024 (B 4) and 4096 (B 1), in the serving dtype
    for B, KV, G, S in ((1, 2, 2, 512), (4, 8, 2, 1024), (1, 8, 2, 4096)):
        for hd in hds:
            spec = launch_spec(B, KV, G, S, hd)
            out.append(LaunchProbe("decode_attention", spec,
                                   *coverage(B, KV, G, S, spec.grid[0])))
    return out


def _seg_combine_probes() -> list[LaunchProbe]:
    from repro_torch.kernels.seg_combine import coverage, launch_spec

    # (N, D, P): the reference's probe, the engine's spill, and the
    # distributed caller's map output of one 128 MiB split of 400-byte
    # records (4 words a record) over 8,192 keys; one probe per route
    return [LaunchProbe("seg_combine", launch_spec(n, d, p), *coverage(n, d, p))
            for n, d, p in ((1024, 256, 16), (262_144, 1, 4_128),
                            (1_342_176, 1, 8_192), (262_144, 1, 100_000))]


def _fixture_copy_probes() -> list[LaunchProbe]:
    from repro_torch.kernels.fixture_copy import coverage, launch_spec

    # the fixture's (4, 1000) in (1, 300) tiles, and the timing shape
    return [LaunchProbe("fixture_copy", launch_spec(R, C, tile),
                        *coverage(R, C, tile))
            for R, C, tile in ((4, 1000, (1, 300)), (16_384, 4096, (16, 512)))]


#: kernel -> its canonical launches (the attention kernels' take ``hds``)
KERNEL_PROBES = {
    "flash_attention": _flash_probes,
    "decode_attention": _decode_probes,
    "seg_combine": _seg_combine_probes,
    "fixture_copy": _fixture_copy_probes,
}


def probe_kernels(probes) -> list[Finding]:
    """Geometry findings over ``probes`` (a list of :class:`LaunchProbe`)."""
    findings: list[Finding] = []
    for p in probes:
        findings.extend(validate_launch(p.kernel, p.spec, p.shape, p.tile,
                                        guarded=p.guarded))
    return findings


def recorded() -> list[LaunchProbe]:
    """The geometries the wrappers of :mod:`repro_torch.kernels.ops` have
    launched in this process."""
    from repro_torch.kernels import ops

    wrappers = {"flash_attention": ops.flash_attention,
                "decode_attention": ops.gqa_decode_attention,
                "seg_combine": ops.seg_combine,
                "fixture_copy": ops.fixture_copy}
    return [LaunchProbe(name, spec, shape, tile)
            for name, w in wrappers.items()
            for spec, shape, tile in sorted(w.geometries, key=repr)]


def check_recorded() -> list[Finding]:
    """Geometry findings over every launch the wrappers recorded, minus the
    ones a caller launched on purpose with a faulty grid (the fixtures')."""
    from ..fixtures import bad_launch_probes

    bad = {(p.spec, p.shape, p.tile) for p in bad_launch_probes()}
    return probe_kernels([p for p in recorded()
                          if (p.spec, p.shape, p.tile) not in bad])


def run(ctx) -> list[Finding]:
    del ctx  # launch geometry needs no traced targets
    findings = []
    for probes in KERNEL_PROBES.values():
        findings.extend(probe_kernels(probes()))
    findings.extend(check_recorded())
    return findings
