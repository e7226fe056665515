"""Model parameters for the Hadoop performance models (paper §1, Tables 1-3).

Three parameter groups, exactly as the paper defines them:

* :class:`HadoopParams`   — Table 1: Hadoop-defined configuration parameters.
* :class:`ProfileStats`   — Table 2: data / UDF profile statistics.
* :class:`CostFactors`    — Table 3: I/O, CPU and network cost factors.

Cost-factor units follow the paper: I/O costs and (de)compression CPU costs are
seconds **per byte**; the remaining CPU costs are seconds **per key-value
pair**; the network cost is seconds per byte transferred.  All model outputs
are therefore in seconds.

The paper's "Initializations" block (the ``If (pUseCombine == FALSE) ...``
rules after Eq. 1) is implemented by :func:`apply_initializations`, which
returns *normalized* copies of the stats / cost factors so that every
downstream formula can be written without conditionals, exactly as the paper
intends.

:class:`repro_torch.spec.JobSpec` bundles the three dataclasses into one frozen
value, and :func:`repro_torch.spec.hadoop_space` exposes each
field as a declarative :class:`~repro_torch.spec.Axis` (kind, bounds, unit,
source table) — use those for anything that routes flat float overrides
back onto these types.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

__all__ = [
    "MiB",
    "HadoopParams",
    "ProfileStats",
    "CostFactors",
    "apply_initializations",
]

MiB = 1 << 20  # 2**20 bytes; the paper's io.sort.mb unit


@dataclass(frozen=True)
class HadoopParams:
    """Table 1 — Hadoop parameter variables (defaults from the paper)."""

    # --- system ---
    pNumNodes: int = 1
    pTaskMem: float = 200.0 * MiB        # mapred.child.java.opts (-Xmx200m)
    pMaxMapsPerNode: int = 2             # mapred.tasktracker.map.tasks.max
    pMaxRedPerNode: int = 2              # mapred.tasktracker.reduce.tasks.max
    # --- job ---
    pNumMappers: int = 1                 # mapred.map.tasks
    pSortMB: float = 100.0               # io.sort.mb (MB)
    pSpillPerc: float = 0.8              # io.sort.spill.percent
    pSortRecPerc: float = 0.05           # io.sort.record.percent
    pSortFactor: int = 10                # io.sort.factor
    pNumSpillsForComb: int = 3           # min.num.spills.for.combine
    pNumReducers: int = 1                # mapred.reduce.tasks
    pInMemMergeThr: int = 1000           # mapred.inmem.merge.threshold
    pShuffleInBufPerc: float = 0.7       # mapred.job.shuffle.input.buffer.percent
    pShuffleMergePerc: float = 0.66      # mapred.job.shuffle.merge.percent
    pReducerInBufPerc: float = 0.0       # mapred.job.reduce.input.buffer.percent
    pUseCombine: bool = False            # mapred.combine.class set?
    pIsIntermCompressed: bool = False    # mapred.compress.map.output
    pIsOutCompressed: bool = False       # mapred.output.compress
    pReduceSlowstart: float = 0.05       # mapred.reduce.slowstart.completed.maps
    # --- input ---
    pIsInCompressed: bool = False        # input compressed?
    pSplitSize: float = 128.0 * MiB      # input split size (bytes)

    def replace(self, **kw) -> "HadoopParams":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ProfileStats:
    """Table 2 — profile statistics of the data and the user-defined functions."""

    sInputPairWidth: float = 100.0       # bytes per input K-V pair
    sMapSizeSel: float = 1.0             # map selectivity (size)
    sMapPairsSel: float = 1.0            # map selectivity (pairs)
    sReduceSizeSel: float = 1.0          # reduce selectivity (size)
    sReducePairsSel: float = 1.0         # reduce selectivity (pairs)
    sCombineSizeSel: float = 1.0         # combine selectivity (size)
    sCombinePairsSel: float = 1.0        # combine selectivity (pairs)
    sInputCompressRatio: float = 1.0     # compressed/uncompressed for input
    sIntermCompressRatio: float = 1.0    # compressed/uncompressed for map output
    sOutCompressRatio: float = 1.0       # compressed/uncompressed for job output

    def replace(self, **kw) -> "ProfileStats":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class CostFactors:
    """Table 3 — I/O / CPU / network cost factors.

    Defaults are representative of 2011-era commodity hardware (roughly the
    cluster the paper's Starfish experiments used): ~66 MB/s HDFS streams,
    ~80 MB/s local disk, ~1 Gbit/s network, and per-pair CPU costs of a few
    hundred nanoseconds.  They only set a realistic *scale*; every benchmark
    and the MapReduce engine's profiler re-fits them from measurements.
    """

    cHdfsReadCost: float = 1.5e-8        # s/byte  (~66 MB/s)
    cHdfsWriteCost: float = 1.5e-8       # s/byte
    cLocalIOCost: float = 1.2e-8         # s/byte  (~80 MB/s)
    cNetworkCost: float = 8.0e-9         # s/byte  (~1 Gb/s)
    cMapCPUCost: float = 5.0e-7          # s/pair
    cReduceCPUCost: float = 5.0e-7       # s/pair
    cCombineCPUCost: float = 4.0e-7      # s/pair
    cPartitionCPUCost: float = 1.0e-7    # s/pair
    cSerdeCPUCost: float = 1.5e-7        # s/pair
    cSortCPUCost: float = 1.0e-7         # s/pair (per comparison level)
    cMergeCPUCost: float = 1.0e-7        # s/pair
    cInUncomprCPUCost: float = 3.0e-9    # s/byte
    cIntermUncomprCPUCost: float = 3.0e-9  # s/byte
    cIntermComprCPUCost: float = 6.0e-9  # s/byte
    cOutComprCPUCost: float = 6.0e-9     # s/byte

    def replace(self, **kw) -> "CostFactors":
        return dataclasses.replace(self, **kw)


def apply_initializations(
    p: HadoopParams, s: ProfileStats, c: CostFactors
) -> tuple[ProfileStats, CostFactors]:
    """The paper's Initializations block (after Eq. 1).

    Returns normalized copies of ``(stats, costs)`` so the formulas need no
    conditionals:

    * no combiner       -> combine selectivities = 1, cCombineCPUCost = 0
    * input uncompressed -> sInputCompressRatio = 1, cInUncomprCPUCost = 0
    * interm uncompressed -> sIntermCompressRatio = 1,
      cIntermUncomprCPUCost = 0 (and, by the same logic, the compression
      cost cIntermComprCPUCost = 0 — the paper zeroes the decompression
      factor explicitly; compression of intermediates cannot occur either)
    * output uncompressed -> sOutCompressRatio = 1, cOutComprCPUCost = 0
    """
    s_kw: dict = {}
    c_kw: dict = {}
    if not p.pUseCombine:
        s_kw.update(sCombineSizeSel=1.0, sCombinePairsSel=1.0)
        c_kw.update(cCombineCPUCost=0.0)
    if not p.pIsInCompressed:
        s_kw.update(sInputCompressRatio=1.0)
        c_kw.update(cInUncomprCPUCost=0.0)
    if not p.pIsIntermCompressed:
        s_kw.update(sIntermCompressRatio=1.0)
        c_kw.update(cIntermUncomprCPUCost=0.0, cIntermComprCPUCost=0.0)
    if not p.pIsOutCompressed:
        s_kw.update(sOutCompressRatio=1.0)
        c_kw.update(cOutComprCPUCost=0.0)
    return s.replace(**s_kw), c.replace(**c_kw)
