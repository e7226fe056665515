"""Pure-Python reference implementation of the Hadoop performance models.

Direct, auditable transcription of the paper's equations (Eqs. 2-98) using
plain floats, ``math.floor/ceil`` and ``if`` statements, in paper order.  This
is the oracle that the batched torch model (:mod:`repro_torch.core.hadoop.model`)
is tested against, mirroring the kernels' ``ref.py`` pattern.

Documented deviations from the paper text (applied identically in both
implementations so they stay equivalent):

* Eq. 19 (sort CPU): ``log2(spillBufferPairs / pNumReducers)`` is clamped at
  ``>= 0`` — a buffer with fewer pairs than partitions would otherwise
  produce a *negative* sorting cost.
* Eq. 31/32 are charged only when ``numSpills > 1`` (§2.3: "The merge phase
  will occur only if more than one spill file is created").
* Eq. 80 (merge CPU of the reduce sort phase): the paper multiplies
  ``totalMergingSize`` (bytes) by ``cMergeCPUCost`` (a *per-pair* factor,
  Table 3); we use ``totalMergingPairs``, the pair counts the paper itself
  computes in Eqs. 71/76, which restores dimensional consistency.
* Eq. 82 references ``segmentComprPairs`` which is never defined; the only
  matching quantity is ``segmentPairs`` (Eq. 37) and is used here.
* Step-3 ratios (Eqs. 75-76) guard the 0/0 case (no files at all) to 0.
* Eq. 67 is implemented literally: when ``numFilesOnDisk < pSortFactor`` one
  file-from-memory is accounted even if zero segments were evicted (its size
  is then 0).  This matches the paper text; see tests for the edge case.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from .merge_math import merge_plan
from .params import MiB, CostFactors, HadoopParams, ProfileStats, apply_initializations

__all__ = [
    "MapTaskModel",
    "ReduceTaskModel",
    "JobModel",
    "map_task_model",
    "reduce_task_model",
    "network_model",
    "job_model",
]


# --------------------------------------------------------------------------
# Result containers: every paper intermediate is a field, for testability.
# --------------------------------------------------------------------------


@dataclass
class MapTaskModel:
    # Read/Map (Eqs. 2-7)
    inputMapSize: float = 0.0
    inputMapPairs: float = 0.0
    ioReadCost: float = 0.0
    cpuReadCost: float = 0.0
    ioMapWriteCost: float = 0.0
    cpuMapWriteCost: float = 0.0
    # Collect/Spill (Eqs. 8-19)
    outMapSize: float = 0.0
    outMapPairs: float = 0.0
    outPairWidth: float = 0.0
    maxSerPairs: float = 0.0
    maxAccPairs: float = 0.0
    spillBufferPairs: float = 0.0
    spillBufferSize: float = 0.0
    numSpills: int = 0
    spillFilePairs: float = 0.0
    spillFileSize: float = 0.0
    ioSpillCost: float = 0.0
    cpuSpillCost: float = 0.0
    # Merge (Eqs. 20-32)
    numSpillsFirstPass: int = 0
    numSpillsIntermMerge: float = 0.0
    numMergePasses: int = 0
    numSpillsFinalMerge: int = 0
    numRecSpilled: float = 0.0
    useCombInMerge: bool = False
    intermDataSize: float = 0.0
    intermDataPairs: float = 0.0
    ioMergeCost: float = 0.0
    cpuMergeCost: float = 0.0
    # Totals (Eqs. 33-34)
    ioCost: float = 0.0
    cpuCost: float = 0.0


@dataclass
class ReduceTaskModel:
    # Shuffle (Eqs. 35-61)
    segmentComprSize: float = 0.0
    segmentUncomprSize: float = 0.0
    segmentPairs: float = 0.0
    totalShuffleSize: float = 0.0
    totalShufflePairs: float = 0.0
    shuffleBufferSize: float = 0.0
    mergeSizeThr: float = 0.0
    inMemCase: bool = True  # Case 1 (segment fits in-memory pipeline)?
    numSegInShuffleFile: float = 0.0
    shuffleFileSize: float = 0.0
    shuffleFilePairs: float = 0.0
    numShuffleFiles: float = 0.0
    numSegmentsInMem: float = 0.0
    numShuffleMerges: float = 0.0
    numMergShufFiles: float = 0.0
    mergShufFileSize: float = 0.0
    mergShufFilePairs: float = 0.0
    numUnmergShufFiles: float = 0.0
    unmergShufFileSize: float = 0.0
    unmergShufFilePairs: float = 0.0
    ioShuffleCost: float = 0.0
    cpuShuffleCost: float = 0.0
    # Sort/Merge (Eqs. 62-80)
    maxSegmentBuffer: float = 0.0
    currSegmentBuffer: float = 0.0
    numSegmentsEvicted: float = 0.0
    numSegmentsRemainMem: float = 0.0
    numFilesOnDisk: float = 0.0
    numFilesFromMem: float = 0.0
    filesFromMemSize: float = 0.0
    filesFromMemPairs: float = 0.0
    step1MergingSize: float = 0.0
    step1MergingPairs: float = 0.0
    filesToMergeStep2: float = 0.0
    step2MergingSize: float = 0.0
    step2MergingPairs: float = 0.0
    filesRemainFromStep2: float = 0.0
    filesToMergeStep3: float = 0.0
    step3MergingSize: float = 0.0
    step3MergingPairs: float = 0.0
    filesRemainFromStep3: float = 0.0
    totalMergingSize: float = 0.0
    totalMergingPairs: float = 0.0
    ioSortCost: float = 0.0
    cpuSortCost: float = 0.0
    # Reduce/Write (Eqs. 81-87)
    inReduceSize: float = 0.0
    inReducePairs: float = 0.0
    outReduceSize: float = 0.0
    outReducePairs: float = 0.0
    inRedDiskSize: float = 0.0
    ioWriteCost: float = 0.0
    cpuWriteCost: float = 0.0
    # Totals (Eqs. 88-89)
    ioCost: float = 0.0
    cpuCost: float = 0.0


@dataclass
class JobModel:
    map: MapTaskModel = field(default_factory=MapTaskModel)
    reduce: ReduceTaskModel = field(default_factory=ReduceTaskModel)
    netTransferSize: float = 0.0
    netCost: float = 0.0           # Eq. 91
    ioAllMaps: float = 0.0         # Eq. 92
    cpuAllMaps: float = 0.0        # Eq. 93
    ioAllReducers: float = 0.0     # Eq. 94
    cpuAllReducers: float = 0.0    # Eq. 95
    ioJobCost: float = 0.0         # Eq. 96
    cpuJobCost: float = 0.0        # Eq. 97
    totalCost: float = 0.0         # Eq. 98


# --------------------------------------------------------------------------
# §2 — Map task phases
# --------------------------------------------------------------------------


def map_task_model(
    p: HadoopParams, s: ProfileStats, c: CostFactors, *, normalized: bool = False
) -> MapTaskModel:
    """Model of a single map task (paper §2)."""
    if not normalized:
        s, c = apply_initializations(p, s, c)
    m = MapTaskModel()

    # --- §2.1 Read + Map (Eqs. 2-4) ---
    m.inputMapSize = p.pSplitSize / s.sInputCompressRatio          # Eq. 2
    m.inputMapPairs = m.inputMapSize / s.sInputPairWidth           # Eq. 3
    m.ioReadCost = p.pSplitSize * c.cHdfsReadCost
    m.cpuReadCost = (
        p.pSplitSize * c.cInUncomprCPUCost
        + m.inputMapPairs * c.cMapCPUCost                          # Eq. 4
    )

    # --- map output (Eqs. 5, 8-10) ---
    m.outMapSize = m.inputMapSize * s.sMapSizeSel                  # Eq. 5/8
    m.outMapPairs = m.inputMapPairs * s.sMapPairsSel               # Eq. 9
    m.outPairWidth = m.outMapSize / m.outMapPairs                  # Eq. 10

    if p.pNumReducers == 0:
        # Map-only job: write map output straight to HDFS (Eqs. 6-7).
        m.ioMapWriteCost = m.outMapSize * s.sOutCompressRatio * c.cHdfsWriteCost
        m.cpuMapWriteCost = m.outMapSize * c.cOutComprCPUCost
        m.ioCost = m.ioReadCost + m.ioMapWriteCost                 # Eq. 33
        m.cpuCost = m.cpuReadCost + m.cpuMapWriteCost              # Eq. 34
        # Map-only intermediate data == final map output.
        m.intermDataSize = m.outMapSize
        m.intermDataPairs = m.outMapPairs
        return m

    # --- §2.2 Collect + Spill (Eqs. 11-19) ---
    m.maxSerPairs = math.floor(
        p.pSortMB * MiB * (1.0 - p.pSortRecPerc) * p.pSpillPerc / m.outPairWidth
    )                                                              # Eq. 11
    m.maxAccPairs = math.floor(
        p.pSortMB * MiB * p.pSortRecPerc * p.pSpillPerc / 16.0
    )                                                              # Eq. 12
    m.spillBufferPairs = max(
        1.0, min(m.maxSerPairs, m.maxAccPairs, m.outMapPairs)
    )                                                              # Eq. 13
    m.spillBufferSize = m.spillBufferPairs * m.outPairWidth        # Eq. 14
    m.numSpills = math.ceil(m.outMapPairs / m.spillBufferPairs)    # Eq. 15
    m.spillFilePairs = m.spillBufferPairs * s.sCombinePairsSel     # Eq. 16
    m.spillFileSize = (
        m.spillBufferSize * s.sCombineSizeSel * s.sIntermCompressRatio
    )                                                              # Eq. 17

    m.ioSpillCost = m.numSpills * m.spillFileSize * c.cLocalIOCost  # Eq. 18
    sort_depth = max(0.0, math.log2(m.spillBufferPairs / p.pNumReducers))
    m.cpuSpillCost = m.numSpills * (                               # Eq. 19
        m.spillBufferPairs * c.cPartitionCPUCost
        + m.spillBufferPairs * c.cSerdeCPUCost
        + m.spillBufferPairs * sort_depth * c.cSortCPUCost
        + m.spillBufferPairs * c.cCombineCPUCost
        + m.spillBufferSize * s.sCombineSizeSel * c.cIntermComprCPUCost
    )

    # --- §2.3 Merge (Eqs. 20-32) ---
    plan = merge_plan(m.numSpills, p.pSortFactor)
    m.numSpillsFirstPass = plan.first_pass                         # Eq. 23
    m.numSpillsIntermMerge = plan.interm_reads                     # Eq. 24
    m.numMergePasses = plan.passes                                 # Eq. 25
    m.numSpillsFinalMerge = plan.final_merge_width                 # Eq. 26

    m.numRecSpilled = m.spillFilePairs * (                         # Eq. 27
        m.numSpills + m.numSpillsIntermMerge + m.numSpills * s.sCombinePairsSel
    )

    m.useCombInMerge = (                                           # Eq. 28
        m.numSpills > 1
        and p.pUseCombine
        and m.numSpillsFinalMerge >= p.pNumSpillsForComb
    )
    comb_size = s.sCombineSizeSel if m.useCombInMerge else 1.0
    comb_pairs = s.sCombinePairsSel if m.useCombInMerge else 1.0
    m.intermDataSize = m.numSpills * m.spillFileSize * comb_size   # Eq. 29
    m.intermDataPairs = m.numSpills * m.spillFilePairs * comb_pairs  # Eq. 30

    if m.numSpills > 1:
        m.ioMergeCost = (                                          # Eq. 31
            2.0 * m.numSpillsIntermMerge * m.spillFileSize * c.cLocalIOCost
            + m.numSpills * m.spillFileSize * c.cLocalIOCost
            + m.intermDataSize * c.cLocalIOCost
        )
        m.cpuMergeCost = (                                         # Eq. 32
            m.numSpillsIntermMerge
            * (
                m.spillFileSize * c.cIntermUncomprCPUCost
                + m.spillFilePairs * c.cMergeCPUCost
                + (m.spillFileSize / s.sIntermCompressRatio)
                * c.cIntermComprCPUCost
            )
            + m.numSpills
            * (
                m.spillFileSize * c.cIntermUncomprCPUCost
                + m.spillFilePairs * c.cMergeCPUCost
                + m.spillFilePairs * c.cCombineCPUCost
            )
            + (m.intermDataSize / s.sIntermCompressRatio) * c.cIntermComprCPUCost
        )

    m.ioCost = m.ioReadCost + m.ioSpillCost + m.ioMergeCost        # Eq. 33
    m.cpuCost = m.cpuReadCost + m.cpuSpillCost + m.cpuMergeCost    # Eq. 34
    return m


# --------------------------------------------------------------------------
# §3 — Reduce task phases
# --------------------------------------------------------------------------


def reduce_task_model(
    p: HadoopParams,
    s: ProfileStats,
    c: CostFactors,
    m: MapTaskModel,
    *,
    normalized: bool = False,
) -> ReduceTaskModel:
    """Model of a single reduce task (paper §3), given the map-task model."""
    if not normalized:
        s, c = apply_initializations(p, s, c)
    r = ReduceTaskModel()
    F = p.pSortFactor

    # --- §3.1 Shuffle (Eqs. 35-41) ---
    r.segmentComprSize = m.intermDataSize / p.pNumReducers         # Eq. 35
    r.segmentUncomprSize = r.segmentComprSize / s.sIntermCompressRatio  # Eq. 36
    r.segmentPairs = m.intermDataPairs / p.pNumReducers            # Eq. 37
    r.totalShuffleSize = p.pNumMappers * r.segmentComprSize        # Eq. 38
    r.totalShufflePairs = p.pNumMappers * r.segmentPairs           # Eq. 39
    r.shuffleBufferSize = p.pShuffleInBufPerc * p.pTaskMem         # Eq. 40
    r.mergeSizeThr = p.pShuffleMergePerc * r.shuffleBufferSize     # Eq. 41

    r.inMemCase = r.segmentUncomprSize < 0.25 * r.shuffleBufferSize
    if r.inMemCase:
        # Case 1 (Eqs. 42-47)
        nseg = r.mergeSizeThr / max(r.segmentUncomprSize, 1e-30)   # Eq. 42
        if math.ceil(nseg) * r.segmentUncomprSize <= r.shuffleBufferSize:
            nseg = float(math.ceil(nseg))                          # Eq. 43
        else:
            nseg = float(math.floor(nseg))
        nseg = max(1.0, min(nseg, float(p.pInMemMergeThr)))
        r.numSegInShuffleFile = nseg
        r.shuffleFileSize = (
            nseg * r.segmentComprSize * s.sCombineSizeSel
        )                                                          # Eq. 44
        r.shuffleFilePairs = nseg * r.segmentPairs * s.sCombinePairsSel  # Eq. 45
        r.numShuffleFiles = float(p.pNumMappers // int(nseg))      # Eq. 46
        r.numSegmentsInMem = float(p.pNumMappers % int(nseg))      # Eq. 47
    else:
        # Case 2 (Eqs. 48-52)
        r.numSegInShuffleFile = 1.0
        r.shuffleFileSize = r.segmentComprSize
        r.shuffleFilePairs = r.segmentPairs
        r.numShuffleFiles = float(p.pNumMappers)
        r.numSegmentsInMem = 0.0

    # On-disk merges during shuffle (Eq. 53).
    if r.numShuffleFiles < 2 * F - 1:
        r.numShuffleMerges = 0.0
    else:
        r.numShuffleMerges = float(
            int((r.numShuffleFiles - 2 * F + 1) // F) + 1
        )
    r.numMergShufFiles = r.numShuffleMerges                        # Eq. 54
    r.mergShufFileSize = F * r.shuffleFileSize                     # Eq. 55
    r.mergShufFilePairs = F * r.shuffleFilePairs                   # Eq. 56
    r.numUnmergShufFiles = r.numShuffleFiles - F * r.numShuffleMerges  # Eq. 57
    r.unmergShufFileSize = r.shuffleFileSize                       # Eq. 58
    r.unmergShufFilePairs = r.shuffleFilePairs                     # Eq. 59

    r.ioShuffleCost = (                                            # Eq. 60
        r.numShuffleFiles * r.shuffleFileSize * c.cLocalIOCost
        + r.numMergShufFiles * r.mergShufFileSize * 2.0 * c.cLocalIOCost
    )
    in_mem_term = (                                                # Eq. 61
        r.totalShuffleSize * c.cIntermUncomprCPUCost
        + r.numShuffleFiles * r.shuffleFilePairs * c.cMergeCPUCost
        + r.numShuffleFiles * r.shuffleFilePairs * c.cCombineCPUCost
        + r.numShuffleFiles
        * (r.shuffleFileSize / s.sIntermCompressRatio)
        * c.cIntermComprCPUCost
    )
    r.cpuShuffleCost = (
        (in_mem_term if r.inMemCase else 0.0)
        + r.numMergShufFiles * r.mergShufFileSize * c.cIntermUncomprCPUCost
        + r.numMergShufFiles * r.mergShufFilePairs * c.cMergeCPUCost
        + r.numMergShufFiles
        * (r.mergShufFileSize / s.sIntermCompressRatio)
        * c.cIntermComprCPUCost
    )

    # --- §3.2 Sort/Merge: Step 1 (Eqs. 62-67) ---
    r.maxSegmentBuffer = p.pReducerInBufPerc * p.pTaskMem          # Eq. 62
    r.currSegmentBuffer = r.numSegmentsInMem * r.segmentUncomprSize  # Eq. 63
    if r.currSegmentBuffer > r.maxSegmentBuffer:
        r.numSegmentsEvicted = math.ceil(                          # Eq. 64
            (r.currSegmentBuffer - r.maxSegmentBuffer)
            / max(r.segmentUncomprSize, 1e-30)
        )
    else:
        r.numSegmentsEvicted = 0.0
    r.numSegmentsRemainMem = r.numSegmentsInMem - r.numSegmentsEvicted  # Eq. 65
    r.numFilesOnDisk = r.numMergShufFiles + r.numUnmergShufFiles   # Eq. 66

    if r.numFilesOnDisk < F:                                       # Eq. 67
        r.numFilesFromMem = 1.0
        r.filesFromMemSize = r.numSegmentsEvicted * r.segmentComprSize
        r.filesFromMemPairs = r.numSegmentsEvicted * r.segmentPairs
        r.step1MergingSize = r.filesFromMemSize
        r.step1MergingPairs = r.filesFromMemPairs
    else:
        r.numFilesFromMem = r.numSegmentsEvicted
        r.filesFromMemSize = r.segmentComprSize
        r.filesFromMemPairs = r.segmentPairs
        r.step1MergingSize = 0.0
        r.step1MergingPairs = 0.0

    r.filesToMergeStep2 = r.numFilesOnDisk + r.numFilesFromMem     # Eq. 68

    # --- Step 2 (Eqs. 69-72): only if files exist on disk ---
    if r.numFilesOnDisk > 0:
        plan2 = merge_plan(int(r.filesToMergeStep2), F)
        interm2 = plan2.interm_reads                               # Eq. 69
        ratio2 = interm2 / r.filesToMergeStep2
        pool_size = (
            r.numMergShufFiles * r.mergShufFileSize
            + r.numUnmergShufFiles * r.unmergShufFileSize
            + r.numFilesFromMem * r.filesFromMemSize
        )
        pool_pairs = (
            r.numMergShufFiles * r.mergShufFilePairs
            + r.numUnmergShufFiles * r.unmergShufFilePairs
            + r.numFilesFromMem * r.filesFromMemPairs
        )
        r.step2MergingSize = ratio2 * pool_size                    # Eq. 70
        r.step2MergingPairs = ratio2 * pool_pairs                  # Eq. 71
        r.filesRemainFromStep2 = float(plan2.final_merge_width)    # Eq. 72
    else:
        r.filesRemainFromStep2 = r.filesToMergeStep2

    # --- Step 3 (Eqs. 73-77) ---
    r.filesToMergeStep3 = r.filesRemainFromStep2 + r.numSegmentsRemainMem  # Eq. 73
    if r.filesToMergeStep3 > 0:
        plan3 = merge_plan(int(r.filesToMergeStep3), F)
        interm3 = plan3.interm_reads                               # Eq. 74
        ratio3 = interm3 / r.filesToMergeStep3
        r.step3MergingSize = ratio3 * r.totalShuffleSize           # Eq. 75
        r.step3MergingPairs = ratio3 * r.totalShufflePairs         # Eq. 76
        r.filesRemainFromStep3 = float(plan3.final_merge_width)    # Eq. 77

    r.totalMergingSize = (                                         # Eq. 78
        r.step1MergingSize + r.step2MergingSize + r.step3MergingSize
    )
    r.totalMergingPairs = (
        r.step1MergingPairs + r.step2MergingPairs + r.step3MergingPairs
    )

    r.ioSortCost = r.totalMergingSize * c.cLocalIOCost             # Eq. 79
    r.cpuSortCost = (                                              # Eq. 80
        r.totalMergingPairs * c.cMergeCPUCost
        + (r.totalMergingSize / s.sIntermCompressRatio) * c.cIntermComprCPUCost
        + (r.step2MergingSize + r.step3MergingSize) * c.cIntermUncomprCPUCost
    )

    # --- §3.3 Reduce + Write (Eqs. 81-87) ---
    r.inReduceSize = (                                             # Eq. 81
        r.numShuffleFiles * r.shuffleFileSize / s.sIntermCompressRatio
        + r.numSegmentsInMem * r.segmentComprSize / s.sIntermCompressRatio
    )
    r.inReducePairs = (                                            # Eq. 82
        r.numShuffleFiles * r.shuffleFilePairs
        + r.numSegmentsInMem * r.segmentPairs
    )
    r.outReduceSize = r.inReduceSize * s.sReduceSizeSel            # Eq. 83
    r.outReducePairs = r.inReducePairs * s.sReducePairsSel         # Eq. 84
    r.inRedDiskSize = (                                            # Eq. 85
        r.numMergShufFiles * r.mergShufFileSize
        + r.numUnmergShufFiles * r.unmergShufFileSize
        + r.numFilesFromMem * r.filesFromMemSize
    )
    r.ioWriteCost = (                                              # Eq. 86
        r.inRedDiskSize * c.cLocalIOCost
        + r.outReduceSize * s.sOutCompressRatio * c.cHdfsWriteCost
    )
    r.cpuWriteCost = (                                             # Eq. 87
        r.inReducePairs * c.cReduceCPUCost
        + r.inRedDiskSize * c.cIntermUncomprCPUCost
        + r.outReduceSize * c.cOutComprCPUCost
    )

    r.ioCost = r.ioShuffleCost + r.ioSortCost + r.ioWriteCost      # Eq. 88
    r.cpuCost = r.cpuShuffleCost + r.cpuSortCost + r.cpuWriteCost  # Eq. 89
    return r


# --------------------------------------------------------------------------
# §4 + §5 — Network and whole-job models
# --------------------------------------------------------------------------


def network_model(
    p: HadoopParams, c: CostFactors, finalOutMapSize: float
) -> tuple[float, float]:
    """Eqs. 90-91 — shuffle network transfer size and cost."""
    frac = (p.pNumNodes - 1) / p.pNumNodes if p.pNumNodes > 0 else 0.0
    size = finalOutMapSize * p.pNumMappers * frac                  # Eq. 90
    return size, size * c.cNetworkCost                             # Eq. 91


def job_model(p: HadoopParams, s: ProfileStats, c: CostFactors) -> JobModel:
    """Analytic whole-job model (paper §5, Eqs. 92-98)."""
    s, c = apply_initializations(p, s, c)
    j = JobModel()
    j.map = map_task_model(p, s, c, normalized=True)

    map_slots = p.pNumNodes * p.pMaxMapsPerNode
    j.ioAllMaps = p.pNumMappers * j.map.ioCost / map_slots         # Eq. 92
    j.cpuAllMaps = p.pNumMappers * j.map.cpuCost / map_slots       # Eq. 93

    if p.pNumReducers > 0:
        j.reduce = reduce_task_model(p, s, c, j.map, normalized=True)
        red_slots = p.pNumNodes * p.pMaxRedPerNode
        j.ioAllReducers = p.pNumReducers * j.reduce.ioCost / red_slots   # Eq. 94
        j.cpuAllReducers = p.pNumReducers * j.reduce.cpuCost / red_slots  # Eq. 95
        j.netTransferSize, j.netCost = network_model(p, c, j.map.intermDataSize)

    j.ioJobCost = j.ioAllMaps + j.ioAllReducers                    # Eq. 96
    j.cpuJobCost = j.cpuAllMaps + j.cpuAllReducers                 # Eq. 97
    j.totalCost = j.ioJobCost + j.cpuJobCost + j.netCost           # Eq. 98
    return j
