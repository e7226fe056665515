"""PyTorch implementation of the Hadoop performance models (batched).

Branch-free ``torch.where`` formulation of exactly the same equations as
:mod:`repro_torch.core.hadoop.ref` — the pure-Python oracle — and as the
reference package's ``job_model_jnp``.  Where the reference ``vmap``s the
model over configurations, this port evaluates it on batched tensors: every
leaf of the input dict is a 0-d tensor or a ``(B,)`` column, and the
elementwise equations broadcast, so a whole grid chunk is one pass over
the equations.

Inputs are a flat ``dict[str, torch.Tensor]`` produced by
:func:`pack_config`.  Outputs are a flat dict of model quantities, prefixed
``m_`` (map task), ``r_`` (reduce task) and ``j_`` (job level).

Validity: the closed-form merge math requires ``N <= pSortFactor**2``
(paper §2.3).  The output key ``valid`` is 1.0 where every merge-math
application was within the closed-form domain; the three underlying
constraints are also emitted separately (``m_mergeValid``,
``r_step2Valid``, ``r_step3Valid``).

Gradients: every spill/merge round count goes through the straight-through
helpers (:func:`repro_torch.core.hadoop.merge_math.ste_floor` /
``ste_ceil``) — forward values are bit-for-bit ``torch.floor``/``ceil``, but
the gradient passes through, so ``torch.autograd.grad`` of any output
w.r.t. the Table-1/2/3 inputs is non-degenerate.  ``torch.maximum`` /
``torch.minimum`` split the gradient evenly at ties, as ``jnp.maximum`` /
``jnp.minimum`` do, which keeps gradients equal to the reference's.

With ``pNumRacks`` in the config, Eq. 91 takes the rack-topology hook of
the cluster layer: the transfer runs at the incast-contended effective
bandwidth of :func:`repro_torch.cluster.network.effective_bandwidth`.
"""

from __future__ import annotations

import torch

from repro_torch.compat import resolve_device

from .merge_math import ste_ceil, ste_floor
from .params import MiB, CostFactors, HadoopParams, ProfileStats

__all__ = ["pack_config", "job_model_torch", "CONFIG_KEYS"]

_P_KEYS = [f.name for f in HadoopParams.__dataclass_fields__.values()]
_S_KEYS = [f.name for f in ProfileStats.__dataclass_fields__.values()]
_C_KEYS = [f.name for f in CostFactors.__dataclass_fields__.values()]
CONFIG_KEYS = _P_KEYS + _S_KEYS + _C_KEYS

_INF = float("inf")


def pack_config(
    p: HadoopParams,
    s: ProfileStats,
    c: CostFactors,
    *,
    dtype: torch.dtype = torch.float64,
    device=None,
) -> dict[str, torch.Tensor]:
    """Flatten the three parameter dataclasses into a dict of 0-d tensors.

    Booleans become 0.0/1.0 so every field is overridable with a batched
    column for grid evaluation.  ``dtype`` defaults to float64, the type the
    reference is tested in; ``device=None`` means CUDA (see
    :func:`repro_torch.compat.resolve_device`).
    """
    dev = resolve_device(device)
    cfg = {}
    for src in (p, s, c):
        for k in src.__dataclass_fields__:
            cfg[k] = torch.tensor(float(getattr(src, k)), dtype=dtype, device=dev)
    return cfg


def _max(a: torch.Tensor, b: float) -> torch.Tensor:
    return torch.maximum(a, a.new_tensor(b))


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------


def _initializations(cfg: dict) -> dict:
    """The paper's Initializations block, branch-free."""
    c = dict(cfg)
    use_comb = cfg["pUseCombine"] > 0
    in_comp = cfg["pIsInCompressed"] > 0
    im_comp = cfg["pIsIntermCompressed"] > 0
    out_comp = cfg["pIsOutCompressed"] > 0
    c["sCombineSizeSel"] = torch.where(use_comb, cfg["sCombineSizeSel"], 1.0)
    c["sCombinePairsSel"] = torch.where(use_comb, cfg["sCombinePairsSel"], 1.0)
    c["cCombineCPUCost"] = torch.where(use_comb, cfg["cCombineCPUCost"], 0.0)
    c["sInputCompressRatio"] = torch.where(in_comp, cfg["sInputCompressRatio"], 1.0)
    c["cInUncomprCPUCost"] = torch.where(in_comp, cfg["cInUncomprCPUCost"], 0.0)
    c["sIntermCompressRatio"] = torch.where(im_comp, cfg["sIntermCompressRatio"], 1.0)
    c["cIntermUncomprCPUCost"] = torch.where(im_comp, cfg["cIntermUncomprCPUCost"], 0.0)
    c["cIntermComprCPUCost"] = torch.where(im_comp, cfg["cIntermComprCPUCost"], 0.0)
    c["sOutCompressRatio"] = torch.where(out_comp, cfg["sOutCompressRatio"], 1.0)
    c["cOutComprCPUCost"] = torch.where(out_comp, cfg["cOutComprCPUCost"], 0.0)
    return c


def _first_pass(n, f):
    """Eq. 20, branch-free."""
    mod = torch.remainder(n - 1.0, f - 1.0)
    gt = torch.where(mod == 0.0, f, mod + 1.0)
    return torch.where(n <= f, n, gt)


def _interm_merge(n, f):
    """Eq. 21, branch-free (valid for n <= f**2)."""
    p = _first_pass(n, f)
    return torch.where(n <= f, 0.0, p + ste_floor((n - p) / f) * f)


def _final_merge(n, f):
    """Eq. 22, branch-free (valid for n <= f**2)."""
    p = _first_pass(n, f)
    s = _interm_merge(n, f)
    return torch.where(n <= f, n, 1.0 + ste_floor((n - p) / f) + (n - s))


def _num_passes(n, f):
    """Eq. 25, branch-free (valid for n <= f**2)."""
    p = _first_pass(n, f)
    many = 2.0 + ste_floor((n - p) / f)
    return torch.where(n <= 1.0, 0.0, torch.where(n <= f, 1.0, many))


def _masked_div(num, den, ok):
    """``num / den`` where ``ok``, ``+inf`` elsewhere — double-``where`` form.

    The inner ``where`` means the division never sees the degenerate
    denominator, so its local derivative is finite and the masked-out
    cotangent is exactly 0 rather than 0 * inf = nan.  The forward value is
    identical to the bare ``where(ok, num / den, inf)``.
    """
    return torch.where(ok, num / torch.where(ok, den, 1.0), _INF)


# --------------------------------------------------------------------------
# §2 — map task, branch-free
# --------------------------------------------------------------------------


def _map_model(cfg: dict) -> dict:
    o: dict = {}
    has_red = cfg["pNumReducers"] > 0
    red = _max(cfg["pNumReducers"], 1.0)  # div guard; selected out below
    F = cfg["pSortFactor"]

    o["inputMapSize"] = cfg["pSplitSize"] / cfg["sInputCompressRatio"]     # Eq. 2
    o["inputMapPairs"] = o["inputMapSize"] / cfg["sInputPairWidth"]        # Eq. 3
    o["ioReadCost"] = cfg["pSplitSize"] * cfg["cHdfsReadCost"]
    o["cpuReadCost"] = (
        cfg["pSplitSize"] * cfg["cInUncomprCPUCost"]
        + o["inputMapPairs"] * cfg["cMapCPUCost"]                          # Eq. 4
    )

    o["outMapSize"] = o["inputMapSize"] * cfg["sMapSizeSel"]               # Eq. 5/8
    o["outMapPairs"] = o["inputMapPairs"] * cfg["sMapPairsSel"]            # Eq. 9
    o["outPairWidth"] = o["outMapSize"] / o["outMapPairs"]                 # Eq. 10

    # Map-only branch (Eqs. 6-7).
    io_mapwrite = o["outMapSize"] * cfg["sOutCompressRatio"] * cfg["cHdfsWriteCost"]
    cpu_mapwrite = o["outMapSize"] * cfg["cOutComprCPUCost"]

    # Collect/Spill (Eqs. 11-19).
    # At degenerate profiles (sMapSizeSel -> 0) the pair width is 0 and this
    # division is +inf; _masked_div's double-where keeps the forward value
    # (inf where the mask fails) while the masked-out cotangent stays 0
    # instead of 0 * inf = nan.
    w_ok = o["outPairWidth"] > 0.0
    ser_num = cfg["pSortMB"] * MiB * (1.0 - cfg["pSortRecPerc"]) * cfg["pSpillPerc"]
    o["maxSerPairs"] = ste_floor(_masked_div(ser_num, o["outPairWidth"], w_ok))
    o["maxAccPairs"] = ste_floor(
        cfg["pSortMB"] * MiB * cfg["pSortRecPerc"] * cfg["pSpillPerc"] / 16.0
    )
    o["spillBufferPairs"] = _max(
        torch.minimum(torch.minimum(o["maxSerPairs"], o["maxAccPairs"]), o["outMapPairs"]),
        1.0,
    )                                                                      # Eq. 13
    o["spillBufferSize"] = o["spillBufferPairs"] * o["outPairWidth"]       # Eq. 14
    o["numSpills"] = ste_ceil(o["outMapPairs"] / o["spillBufferPairs"])    # Eq. 15
    o["spillFilePairs"] = o["spillBufferPairs"] * cfg["sCombinePairsSel"]  # Eq. 16
    o["spillFileSize"] = (
        o["spillBufferSize"] * cfg["sCombineSizeSel"] * cfg["sIntermCompressRatio"]
    )                                                                      # Eq. 17

    io_spill = o["numSpills"] * o["spillFileSize"] * cfg["cLocalIOCost"]   # Eq. 18
    sort_depth = _max(torch.log2(o["spillBufferPairs"] / red), 0.0)
    cpu_spill = o["numSpills"] * (                                         # Eq. 19
        o["spillBufferPairs"] * cfg["cPartitionCPUCost"]
        + o["spillBufferPairs"] * cfg["cSerdeCPUCost"]
        + o["spillBufferPairs"] * sort_depth * cfg["cSortCPUCost"]
        + o["spillBufferPairs"] * cfg["cCombineCPUCost"]
        + o["spillBufferSize"] * cfg["sCombineSizeSel"] * cfg["cIntermComprCPUCost"]
    )

    # Merge (Eqs. 20-32), closed forms.
    N = o["numSpills"]
    o["numSpillsFirstPass"] = _first_pass(N, F)                            # Eq. 23
    o["numSpillsIntermMerge"] = _interm_merge(N, F)                        # Eq. 24
    o["numMergePasses"] = _num_passes(N, F)                                # Eq. 25
    o["numSpillsFinalMerge"] = _final_merge(N, F)                          # Eq. 26
    o["mergeValid"] = (N <= F * F).to(N.dtype)

    o["numRecSpilled"] = o["spillFilePairs"] * (                           # Eq. 27
        N + o["numSpillsIntermMerge"] + N * cfg["sCombinePairsSel"]
    )

    use_comb_merge = (                                                     # Eq. 28
        (N > 1.0)
        & (cfg["pUseCombine"] > 0)
        & (o["numSpillsFinalMerge"] >= cfg["pNumSpillsForComb"])
    )
    comb_size = torch.where(use_comb_merge, cfg["sCombineSizeSel"], 1.0)
    comb_pairs = torch.where(use_comb_merge, cfg["sCombinePairsSel"], 1.0)
    o["useCombInMerge"] = use_comb_merge.to(N.dtype)
    o["intermDataSize"] = N * o["spillFileSize"] * comb_size               # Eq. 29
    o["intermDataPairs"] = N * o["spillFilePairs"] * comb_pairs            # Eq. 30

    S = o["numSpillsIntermMerge"]
    io_merge = torch.where(                                                  # Eq. 31
        N > 1.0,
        2.0 * S * o["spillFileSize"] * cfg["cLocalIOCost"]
        + N * o["spillFileSize"] * cfg["cLocalIOCost"]
        + o["intermDataSize"] * cfg["cLocalIOCost"],
        0.0,
    )
    cpu_merge = torch.where(                                                 # Eq. 32
        N > 1.0,
        S
        * (
            o["spillFileSize"] * cfg["cIntermUncomprCPUCost"]
            + o["spillFilePairs"] * cfg["cMergeCPUCost"]
            + (o["spillFileSize"] / cfg["sIntermCompressRatio"])
            * cfg["cIntermComprCPUCost"]
        )
        + N
        * (
            o["spillFileSize"] * cfg["cIntermUncomprCPUCost"]
            + o["spillFilePairs"] * cfg["cMergeCPUCost"]
            + o["spillFilePairs"] * cfg["cCombineCPUCost"]
        )
        + (o["intermDataSize"] / cfg["sIntermCompressRatio"])
        * cfg["cIntermComprCPUCost"],
        0.0,
    )

    # Map-only jobs emit map output straight to HDFS.
    o["intermDataSize"] = torch.where(has_red, o["intermDataSize"], o["outMapSize"])
    o["intermDataPairs"] = torch.where(has_red, o["intermDataPairs"], o["outMapPairs"])

    o["ioSpillCost"] = torch.where(has_red, io_spill, 0.0)
    o["cpuSpillCost"] = torch.where(has_red, cpu_spill, 0.0)
    o["ioMergeCost"] = torch.where(has_red, io_merge, 0.0)
    o["cpuMergeCost"] = torch.where(has_red, cpu_merge, 0.0)
    o["ioMapWriteCost"] = torch.where(has_red, 0.0, io_mapwrite)
    o["cpuMapWriteCost"] = torch.where(has_red, 0.0, cpu_mapwrite)

    o["ioCost"] = torch.where(                                               # Eq. 33
        has_red,
        o["ioReadCost"] + io_spill + io_merge,
        o["ioReadCost"] + io_mapwrite,
    )
    o["cpuCost"] = torch.where(                                              # Eq. 34
        has_red,
        o["cpuReadCost"] + cpu_spill + cpu_merge,
        o["cpuReadCost"] + cpu_mapwrite,
    )
    return o


# --------------------------------------------------------------------------
# §3 — reduce task, branch-free
# --------------------------------------------------------------------------


def _reduce_model(cfg: dict, m: dict) -> dict:
    o: dict = {}
    F = cfg["pSortFactor"]
    red = _max(cfg["pNumReducers"], 1.0)
    M = cfg["pNumMappers"]

    o["segmentComprSize"] = m["intermDataSize"] / red                      # Eq. 35
    o["segmentUncomprSize"] = (
        o["segmentComprSize"] / cfg["sIntermCompressRatio"]
    )                                                                      # Eq. 36
    o["segmentPairs"] = m["intermDataPairs"] / red                         # Eq. 37
    o["totalShuffleSize"] = M * o["segmentComprSize"]                      # Eq. 38
    o["totalShufflePairs"] = M * o["segmentPairs"]                         # Eq. 39
    o["shuffleBufferSize"] = cfg["pShuffleInBufPerc"] * cfg["pTaskMem"]    # Eq. 40
    o["mergeSizeThr"] = cfg["pShuffleMergePerc"] * o["shuffleBufferSize"]  # Eq. 41

    in_mem = o["segmentUncomprSize"] < 0.25 * o["shuffleBufferSize"]
    o["inMemCase"] = in_mem.to(M.dtype)

    # Case 1 (Eqs. 42-47)
    nseg_raw = o["mergeSizeThr"] / _max(o["segmentUncomprSize"], 1e-30)
    nseg_c = ste_ceil(nseg_raw)
    nseg1 = torch.where(
        nseg_c * o["segmentUncomprSize"] <= o["shuffleBufferSize"],
        nseg_c,
        ste_floor(nseg_raw),
    )
    nseg1 = _max(torch.minimum(nseg1, cfg["pInMemMergeThr"]), 1.0)

    nseg = torch.where(in_mem, nseg1, 1.0)                                   # Eq. 48
    o["numSegInShuffleFile"] = nseg
    o["shuffleFileSize"] = torch.where(                                      # Eq. 44/49
        in_mem, nseg * o["segmentComprSize"] * cfg["sCombineSizeSel"],
        o["segmentComprSize"],
    )
    o["shuffleFilePairs"] = torch.where(                                     # Eq. 45/50
        in_mem, nseg * o["segmentPairs"] * cfg["sCombinePairsSel"],
        o["segmentPairs"],
    )
    o["numShuffleFiles"] = torch.where(in_mem, ste_floor(M / nseg), M)       # Eq. 46/51
    o["numSegmentsInMem"] = torch.where(                                     # Eq. 47/52
        in_mem, M - nseg * ste_floor(M / nseg), 0.0
    )

    # Disk merges during shuffle (Eqs. 53-59).
    nsf = o["numShuffleFiles"]
    o["numShuffleMerges"] = torch.where(                                     # Eq. 53
        nsf < 2.0 * F - 1.0,
        0.0,
        ste_floor((nsf - 2.0 * F + 1.0) / F) + 1.0,
    )
    o["numMergShufFiles"] = o["numShuffleMerges"]                          # Eq. 54
    o["mergShufFileSize"] = F * o["shuffleFileSize"]                       # Eq. 55
    o["mergShufFilePairs"] = F * o["shuffleFilePairs"]                     # Eq. 56
    o["numUnmergShufFiles"] = nsf - F * o["numShuffleMerges"]              # Eq. 57
    o["unmergShufFileSize"] = o["shuffleFileSize"]                         # Eq. 58
    o["unmergShufFilePairs"] = o["shuffleFilePairs"]                       # Eq. 59

    o["ioShuffleCost"] = (                                                 # Eq. 60
        nsf * o["shuffleFileSize"] * cfg["cLocalIOCost"]
        + o["numMergShufFiles"] * o["mergShufFileSize"] * 2.0 * cfg["cLocalIOCost"]
    )
    in_mem_term = (                                                        # Eq. 61
        o["totalShuffleSize"] * cfg["cIntermUncomprCPUCost"]
        + nsf * o["shuffleFilePairs"] * cfg["cMergeCPUCost"]
        + nsf * o["shuffleFilePairs"] * cfg["cCombineCPUCost"]
        + nsf
        * (o["shuffleFileSize"] / cfg["sIntermCompressRatio"])
        * cfg["cIntermComprCPUCost"]
    )
    o["cpuShuffleCost"] = (
        torch.where(in_mem, in_mem_term, 0.0)
        + o["numMergShufFiles"] * o["mergShufFileSize"] * cfg["cIntermUncomprCPUCost"]
        + o["numMergShufFiles"] * o["mergShufFilePairs"] * cfg["cMergeCPUCost"]
        + o["numMergShufFiles"]
        * (o["mergShufFileSize"] / cfg["sIntermCompressRatio"])
        * cfg["cIntermComprCPUCost"]
    )

    # Sort/Merge — Step 1 (Eqs. 62-67).
    o["maxSegmentBuffer"] = cfg["pReducerInBufPerc"] * cfg["pTaskMem"]     # Eq. 62
    o["currSegmentBuffer"] = o["numSegmentsInMem"] * o["segmentUncomprSize"]
    o["numSegmentsEvicted"] = torch.where(                                   # Eq. 64
        o["currSegmentBuffer"] > o["maxSegmentBuffer"],
        ste_ceil(
            (o["currSegmentBuffer"] - o["maxSegmentBuffer"])
            / _max(o["segmentUncomprSize"], 1e-30)
        ),
        0.0,
    )
    o["numSegmentsRemainMem"] = o["numSegmentsInMem"] - o["numSegmentsEvicted"]
    o["numFilesOnDisk"] = o["numMergShufFiles"] + o["numUnmergShufFiles"]  # Eq. 66

    few_disk = o["numFilesOnDisk"] < F                                     # Eq. 67
    o["numFilesFromMem"] = torch.where(few_disk, 1.0, o["numSegmentsEvicted"])
    o["filesFromMemSize"] = torch.where(
        few_disk,
        o["numSegmentsEvicted"] * o["segmentComprSize"],
        o["segmentComprSize"],
    )
    o["filesFromMemPairs"] = torch.where(
        few_disk,
        o["numSegmentsEvicted"] * o["segmentPairs"],
        o["segmentPairs"],
    )
    o["step1MergingSize"] = torch.where(few_disk, o["filesFromMemSize"], 0.0)
    o["step1MergingPairs"] = torch.where(few_disk, o["filesFromMemPairs"], 0.0)

    o["filesToMergeStep2"] = o["numFilesOnDisk"] + o["numFilesFromMem"]    # Eq. 68

    # Step 2 (Eqs. 69-72).
    n2 = o["filesToMergeStep2"]
    has_disk = o["numFilesOnDisk"] > 0.0
    interm2 = _interm_merge(n2, F)                                         # Eq. 69
    ratio2 = interm2 / _max(n2, 1e-30)
    pool_size = (
        o["numMergShufFiles"] * o["mergShufFileSize"]
        + o["numUnmergShufFiles"] * o["unmergShufFileSize"]
        + o["numFilesFromMem"] * o["filesFromMemSize"]
    )
    pool_pairs = (
        o["numMergShufFiles"] * o["mergShufFilePairs"]
        + o["numUnmergShufFiles"] * o["unmergShufFilePairs"]
        + o["numFilesFromMem"] * o["filesFromMemPairs"]
    )
    o["step2MergingSize"] = torch.where(has_disk, ratio2 * pool_size, 0.0)   # Eq. 70
    o["step2MergingPairs"] = torch.where(has_disk, ratio2 * pool_pairs, 0.0)  # Eq. 71
    o["filesRemainFromStep2"] = torch.where(has_disk, _final_merge(n2, F), n2)
    o["step2Valid"] = (n2 <= F * F).to(M.dtype)

    # Step 3 (Eqs. 73-77).
    n3 = o["filesRemainFromStep2"] + o["numSegmentsRemainMem"]             # Eq. 73
    o["filesToMergeStep3"] = n3
    interm3 = _interm_merge(n3, F)                                         # Eq. 74
    ratio3 = torch.where(n3 > 0.0, interm3 / _max(n3, 1e-30), 0.0)
    o["step3MergingSize"] = ratio3 * o["totalShuffleSize"]                 # Eq. 75
    o["step3MergingPairs"] = ratio3 * o["totalShufflePairs"]               # Eq. 76
    o["filesRemainFromStep3"] = torch.where(n3 > 0.0, _final_merge(n3, F), 0.0)
    o["step3Valid"] = (n3 <= F * F).to(M.dtype)

    o["totalMergingSize"] = (                                              # Eq. 78
        o["step1MergingSize"] + o["step2MergingSize"] + o["step3MergingSize"]
    )
    o["totalMergingPairs"] = (
        o["step1MergingPairs"] + o["step2MergingPairs"] + o["step3MergingPairs"]
    )
    o["ioSortCost"] = o["totalMergingSize"] * cfg["cLocalIOCost"]          # Eq. 79
    o["cpuSortCost"] = (                                                   # Eq. 80
        o["totalMergingPairs"] * cfg["cMergeCPUCost"]
        + (o["totalMergingSize"] / cfg["sIntermCompressRatio"])
        * cfg["cIntermComprCPUCost"]
        + (o["step2MergingSize"] + o["step3MergingSize"])
        * cfg["cIntermUncomprCPUCost"]
    )

    # Reduce + Write (Eqs. 81-87).
    o["inReduceSize"] = (                                                  # Eq. 81
        nsf * o["shuffleFileSize"] / cfg["sIntermCompressRatio"]
        + o["numSegmentsInMem"] * o["segmentComprSize"] / cfg["sIntermCompressRatio"]
    )
    o["inReducePairs"] = (                                                 # Eq. 82
        nsf * o["shuffleFilePairs"] + o["numSegmentsInMem"] * o["segmentPairs"]
    )
    o["outReduceSize"] = o["inReduceSize"] * cfg["sReduceSizeSel"]         # Eq. 83
    o["outReducePairs"] = o["inReducePairs"] * cfg["sReducePairsSel"]      # Eq. 84
    o["inRedDiskSize"] = (                                                 # Eq. 85
        o["numMergShufFiles"] * o["mergShufFileSize"]
        + o["numUnmergShufFiles"] * o["unmergShufFileSize"]
        + o["numFilesFromMem"] * o["filesFromMemSize"]
    )
    o["ioWriteCost"] = (                                                   # Eq. 86
        o["inRedDiskSize"] * cfg["cLocalIOCost"]
        + o["outReduceSize"] * cfg["sOutCompressRatio"] * cfg["cHdfsWriteCost"]
    )
    o["cpuWriteCost"] = (                                                  # Eq. 87
        o["inReducePairs"] * cfg["cReduceCPUCost"]
        + o["inRedDiskSize"] * cfg["cIntermUncomprCPUCost"]
        + o["outReduceSize"] * cfg["cOutComprCPUCost"]
    )

    o["ioCost"] = o["ioShuffleCost"] + o["ioSortCost"] + o["ioWriteCost"]  # Eq. 88
    o["cpuCost"] = o["cpuShuffleCost"] + o["cpuSortCost"] + o["cpuWriteCost"]
    return o


# --------------------------------------------------------------------------
# §4 + §5 — network and job level
# --------------------------------------------------------------------------


def job_model_torch(cfg: dict) -> dict:
    """Whole-job analytic model (Eqs. 92-98) over batched tensor leaves."""
    cfg = _initializations(cfg)
    has_red = cfg["pNumReducers"] > 0

    m = _map_model(cfg)
    out = {f"m_{k}": v for k, v in m.items()}

    r = _reduce_model(cfg, m)
    # Zero out the reduce side of map-only jobs.
    for k, v in r.items():
        out[f"r_{k}"] = torch.where(has_red, v, 0.0)

    map_slots = cfg["pNumNodes"] * cfg["pMaxMapsPerNode"]
    red_slots = cfg["pNumNodes"] * cfg["pMaxRedPerNode"]
    out["j_ioAllMaps"] = cfg["pNumMappers"] * m["ioCost"] / map_slots      # Eq. 92
    out["j_cpuAllMaps"] = cfg["pNumMappers"] * m["cpuCost"] / map_slots    # Eq. 93
    out["j_ioAllReducers"] = torch.where(                                  # Eq. 94
        has_red, cfg["pNumReducers"] * r["ioCost"] / red_slots, 0.0
    )
    out["j_cpuAllReducers"] = torch.where(                                 # Eq. 95
        has_red, cfg["pNumReducers"] * r["cpuCost"] / red_slots, 0.0
    )

    frac = (cfg["pNumNodes"] - 1.0) / cfg["pNumNodes"]
    net_size = m["intermDataSize"] * cfg["pNumMappers"] * frac             # Eq. 90
    out["j_netTransferSize"] = torch.where(has_red, net_size, 0.0)
    out["j_netCost"] = out["j_netTransferSize"] * cfg["cNetworkCost"]      # Eq. 91
    if "pNumRacks" in cfg:
        # topology hook: Eq. 91 priced a flat network; with declared racks
        # the transfer runs at the incast-contended effective bandwidth of
        # repro_torch.cluster.network (pNumReducers concurrent flows unless
        # the caller supplies nFlows).  Deferred import — repro_torch.core
        # cannot depend on repro_torch.cluster at module scope; network
        # sits below both.
        from repro_torch.cluster.network import effective_bandwidth

        net = out["j_netCost"]
        bw = effective_bandwidth(
            cfg["pNumRacks"],
            cfg.get("crossRackBw", net.new_tensor(float("inf"))),
            cfg.get("oversubscription", net.new_tensor(1.0)),
            cfg.get("nFlows", cfg["pNumReducers"]),
        )
        # double-where: bw > 0 always (it is clamped to (0, 1]), but a
        # where-guarded divide keeps the gradient NaN-free at bw -> 0
        bw_ok = bw > 0.0
        bw_safe = torch.where(bw_ok, bw, torch.ones_like(bw))
        out["j_netCost"] = torch.where(bw_ok, net / bw_safe, net)

    out["j_ioJobCost"] = out["j_ioAllMaps"] + out["j_ioAllReducers"]       # Eq. 96
    out["j_cpuJobCost"] = out["j_cpuAllMaps"] + out["j_cpuAllReducers"]    # Eq. 97
    out["j_totalCost"] = (
        out["j_ioJobCost"] + out["j_cpuJobCost"] + out["j_netCost"]
    )                                                                      # Eq. 98

    out["valid"] = (
        m["mergeValid"]
        * torch.where(has_red, r["step2Valid"] * r["step3Valid"], 1.0)
    )
    return out
