"""Executable MapReduce engine with faithful Hadoop phase semantics.

This is the ground truth the paper's closed-form dataflow models are
validated against (benchmark E7 / tests): every quantity the paper derives —
``numSpills``, ``spillFileSize``, merge-pass counts, shuffle-file counts,
``intermDataSize`` … — is *measured* here from an actual execution:

  map task   : read -> map -> collect (partition) -> spill (sort [+combine])
               -> multi-pass merge (io.sort.factor semantics, combiner in the
               final merge when wide enough)
  reduce task: shuffle (in-memory merge thresholds, disk merges at 2F-1)
               -> 3-step sort/merge -> reduce -> write

Orchestration is host-level Python/numpy — exactly as Hadoop's own task
runtime is JVM code around the sort/merge buffers — while the combiner
(the compute hot-spot) runs on the hand-written CUDA ``seg_combine`` kernel
via :func:`repro_torch.kernels.seg_combine` by default (``use_kernel_combine``,
the reference engine's ``use_pallas_combine``).
Byte sizes follow the paper's accounting: pair counts x pair widths, with
compression modeled by the ratio statistics (Table 2).

Every phase is wall-clock timed; :mod:`repro_torch.mapreduce.profiler` fits the
paper's CostFactors (Table 3) to these timings and predicts other configs.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.core.hadoop.merge_math import merge_plan
from repro_torch.core.hadoop.params import HadoopParams, MiB
from repro_torch.kernels import seg_combine
from .jobs import JobSpec

__all__ = ["MapCounters", "ReduceCounters", "JobCounters", "MapReduceEngine"]


def _hash_partition(keys: np.ndarray, r: int) -> np.ndarray:
    return ((keys * 2654435761) % (1 << 31)) % r


@dataclass
class MapCounters:
    """Measured map-task dataflow (paper §2 quantities)."""
    inputPairs: int = 0
    inputBytes: float = 0.0            # on-disk (compressed) split bytes
    outMapPairs: int = 0
    outMapSize: float = 0.0
    spillBufferPairs: int = 0
    numSpills: int = 0
    spillFilePairs: list = field(default_factory=list)
    spillFileSize: list = field(default_factory=list)
    numMergePasses: int = 0
    numSpillsFinalMerge: int = 0
    usedCombineInMerge: bool = False
    mergeReadBytes: float = 0.0
    mergeWriteBytes: float = 0.0
    numRecSpilled: int = 0
    intermDataPairs: int = 0
    intermDataSize: float = 0.0
    times: dict = field(default_factory=dict)


@dataclass
class ReduceCounters:
    """Measured reduce-task dataflow (paper §3 quantities)."""
    totalShufflePairs: int = 0
    totalShuffleSize: float = 0.0      # compressed bytes fetched
    segmentComprSize: float = 0.0
    numSegInShuffleFile: int = 0
    numShuffleFiles: int = 0
    shuffleFilePairs: list = field(default_factory=list)
    numShuffleMerges: int = 0
    numSegmentsInMem: int = 0
    sortMergeReadBytes: float = 0.0
    inReducePairs: int = 0
    inReduceGroups: int = 0
    outReducePairs: int = 0
    outReduceSize: float = 0.0
    times: dict = field(default_factory=dict)


@dataclass
class JobCounters:
    maps: list = field(default_factory=list)       # MapCounters
    reduces: list = field(default_factory=list)    # ReduceCounters
    netTransferBytes: float = 0.0
    output: tuple | None = None                    # (keys, values)

    # --------------------------------------------------------- aggregates
    def phase_totals(self) -> dict:
        """Aggregate per-phase (bytes, pairs) + wall times for fitting."""
        t: dict[str, float] = {}
        for mc in self.maps:
            for k, v in mc.times.items():
                t[k] = t.get(k, 0.0) + v
        for rc in self.reduces:
            for k, v in rc.times.items():
                t[k] = t.get(k, 0.0) + v
        return t


class MapReduceEngine:
    """Execute a :class:`JobSpec` under :class:`HadoopParams` semantics."""

    def __init__(
        self,
        hp: HadoopParams,
        job: JobSpec,
        *,
        use_kernel_combine: bool = True,
        device=None,
    ):
        """``use_kernel_combine`` (the reference engine's
        ``use_pallas_combine``) sends the combiner's segmented sums through
        :func:`repro_torch.kernels.seg_combine` on ``device``: ``None`` means
        CUDA and raises without a card, ``"cpu"`` takes the kernel's plain
        version.  ``use_kernel_combine=False`` keeps the numpy combiner of
        the reference engine's default, and ``device`` is then not used."""
        self.hp = hp
        self.job = job
        self.use_kernel_combine = use_kernel_combine
        self.device = resolve_device(device) if use_kernel_combine else None
        if job.use_combine != hp.pUseCombine:
            # HadoopParams is authoritative (the tunable knob)
            self.use_combine = hp.pUseCombine
        else:
            self.use_combine = job.use_combine

    # ------------------------------------------------------------- combine
    def _combine(self, part: np.ndarray, keys: np.ndarray, vals: np.ndarray):
        """Merge same-(partition,key) pairs.  Inputs sorted by (part, key)."""
        if keys.size == 0:
            return part, keys, vals
        pk = np.stack([part, keys], 1)
        uniq, inverse = np.unique(pk, axis=0, return_inverse=True)
        if self.use_kernel_combine:
            v = torch.from_numpy(np.asarray(vals, np.float32)[:, None])
            ids = torch.from_numpy(inverse.reshape(-1).astype(np.int32))
            summed = seg_combine(
                v.to(self.device), ids.to(self.device), int(uniq.shape[0])
            )[:, 0].cpu().numpy()
        else:
            summed = np.zeros(uniq.shape[0], np.float32)
            np.add.at(summed, inverse, vals)
        return uniq[:, 0], uniq[:, 1], summed

    # ------------------------------------------------------------ map task
    def run_map_task(self, keys: np.ndarray, values: np.ndarray):
        hp, job = self.hp, self.job
        mc = MapCounters()
        R = max(hp.pNumReducers, 1)

        # ---- read + map (paper §2.1) ----
        t0 = time.perf_counter()
        mc.inputPairs = int(keys.shape[0])
        uncompressed = keys.shape[0] * job.pair_width
        ratio = hp.pIsInCompressed and 0.4 or 1.0
        mc.inputBytes = uncompressed * ratio
        mc.times["read"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        okeys, ovals = job.map_fn(keys, values)
        mc.outMapPairs = int(okeys.shape[0])
        mc.outMapSize = okeys.shape[0] * job.map_out_pair_width
        mc.times["map"] = time.perf_counter() - t0

        if hp.pNumReducers == 0:
            mc.intermDataPairs = mc.outMapPairs
            mc.intermDataSize = mc.outMapSize
            return [(okeys, ovals)], mc

        # ---- collect: partition (paper §2.2) ----
        t0 = time.perf_counter()
        part = _hash_partition(okeys, R)
        mc.times["collect"] = time.perf_counter() - t0

        # ---- spill: buffer sizing exactly as Eqs. 11-15 ----
        out_width = mc.outMapSize / max(mc.outMapPairs, 1)
        max_ser = int(
            hp.pSortMB * MiB * (1 - hp.pSortRecPerc) * hp.pSpillPerc
            // max(out_width, 1e-9)
        )
        max_acc = int(hp.pSortMB * MiB * hp.pSortRecPerc * hp.pSpillPerc // 16)
        buf_pairs = max(1, min(max_ser, max_acc, max(mc.outMapPairs, 1)))
        mc.spillBufferPairs = buf_pairs

        t0 = time.perf_counter()
        spills = []                    # list of (part, key, val) sorted chunks
        interm_ratio = 0.3 if hp.pIsIntermCompressed else 1.0
        for lo in range(0, mc.outMapPairs, buf_pairs):
            p, k, v = part[lo:lo+buf_pairs], okeys[lo:lo+buf_pairs], ovals[lo:lo+buf_pairs]
            order = np.lexsort((k, p))
            p, k, v = p[order], k[order], v[order]
            if self.use_combine:
                p, k, v = self._combine(p, k, v)
            spills.append((p, k, v))
            mc.spillFilePairs.append(int(k.shape[0]))
            mc.spillFileSize.append(
                k.shape[0] * job.map_out_pair_width * interm_ratio
            )
        mc.numSpills = len(spills)
        mc.numRecSpilled = sum(mc.spillFilePairs)
        mc.times["spill"] = time.perf_counter() - t0

        # ---- merge: io.sort.factor multi-pass semantics (paper §2.3) ----
        t0 = time.perf_counter()
        plan = merge_plan(mc.numSpills, hp.pSortFactor)
        mc.numMergePasses = plan.passes
        mc.numSpillsFinalMerge = plan.final_merge_width

        def merge_files(files):
            p = np.concatenate([f[0] for f in files])
            k = np.concatenate([f[1] for f in files])
            v = np.concatenate([f[2] for f in files])
            order = np.lexsort((k, p))
            return p[order], k[order], v[order]

        files = list(spills)
        if len(files) > 1:
            # first pass width P, then exactly-F passes (Eq. 20 semantics)
            widths = [plan.first_pass]
            remaining = len(files) - plan.first_pass
            while remaining >= hp.pSortFactor:
                widths.append(hp.pSortFactor)
                remaining -= hp.pSortFactor
            for w in widths:
                if len(files) <= hp.pSortFactor:
                    break
                if w <= 1:
                    continue
                group, files = files[:w], files[w:]
                merged = merge_files(group)
                rb = sum(g[1].shape[0] for g in group) * job.map_out_pair_width * interm_ratio
                mc.mergeReadBytes += rb
                mc.mergeWriteBytes += rb
                files.append(merged)

        # final merge -> single map-output file
        mc.usedCombineInMerge = (
            mc.numSpills > 1
            and self.use_combine
            and len(files) >= hp.pNumSpillsForComb
        )
        if len(files) > 1:
            mc.mergeReadBytes += sum(
                f[1].shape[0] for f in files
            ) * job.map_out_pair_width * interm_ratio
        p, k, v = merge_files(files) if len(files) > 1 else files[0]
        if mc.usedCombineInMerge:
            p, k, v = self._combine(p, k, v)
        mc.intermDataPairs = int(k.shape[0])
        mc.intermDataSize = k.shape[0] * job.map_out_pair_width * interm_ratio
        if len(spills) > 1:
            mc.mergeWriteBytes += mc.intermDataSize
        mc.times["merge"] = time.perf_counter() - t0

        segments = [
            (k[p == r], v[p == r]) for r in range(R)
        ]
        return segments, mc

    # --------------------------------------------------------- reduce task
    def run_reduce_task(self, segments: list):
        """``segments``: one (keys, values) tuple per mapper (this reducer's
        partition), sizes in *compressed* bytes per the paper's accounting."""
        hp, job = self.hp, self.job
        rc = ReduceCounters()
        interm_ratio = 0.3 if hp.pIsIntermCompressed else 1.0
        width = job.map_out_pair_width

        # ---- shuffle (paper §3.1) ----
        t0 = time.perf_counter()
        seg_pairs = [int(k.shape[0]) for k, _ in segments]
        rc.totalShufflePairs = sum(seg_pairs)
        seg_compr = [n * width * interm_ratio for n in seg_pairs]
        rc.totalShuffleSize = sum(seg_compr)
        rc.segmentComprSize = float(np.mean(seg_compr)) if seg_compr else 0.0
        seg_uncompr = rc.segmentComprSize / interm_ratio

        shuffle_buffer = hp.pShuffleInBufPerc * hp.pTaskMem
        merge_thr = hp.pShuffleMergePerc * shuffle_buffer

        if seg_uncompr < 0.25 * shuffle_buffer and seg_uncompr > 0:
            n_in_file = merge_thr / max(seg_uncompr, 1e-9)
            if np.ceil(n_in_file) * seg_uncompr <= shuffle_buffer:
                n_in_file = int(np.ceil(n_in_file))
            else:
                n_in_file = int(np.floor(n_in_file))
            n_in_file = max(1, min(n_in_file, hp.pInMemMergeThr))
        else:
            n_in_file = 1
        rc.numSegInShuffleFile = n_in_file

        # in-memory merges -> shuffle files on disk (combiner applies here
        # in Case 1 when merging actually happens)
        shuffle_files = []             # (keys, vals) sorted
        case1 = seg_uncompr < 0.25 * shuffle_buffer
        i = 0
        while i + n_in_file <= len(segments):
            group = segments[i:i + n_in_file]
            k = np.concatenate([g[0] for g in group])
            v = np.concatenate([g[1] for g in group])
            order = np.argsort(k, kind="stable")
            k, v = k[order], v[order]
            if self.use_combine and case1 and n_in_file > 1:
                _, k, v = self._combine(np.zeros_like(k), k, v)
            shuffle_files.append((k, v))
            rc.shuffleFilePairs.append(int(k.shape[0]))
            i += n_in_file
        in_mem = segments[i:]
        rc.numShuffleFiles = len(shuffle_files)
        rc.numSegmentsInMem = len(in_mem)

        # disk merges when shuffle files exceed 2F-1 (no combiner)
        F = hp.pSortFactor
        merged_files = []
        while len(shuffle_files) >= 2 * F - 1:
            group, shuffle_files = shuffle_files[:F], shuffle_files[F:]
            k = np.concatenate([g[0] for g in group])
            v = np.concatenate([g[1] for g in group])
            order = np.argsort(k, kind="stable")
            merged_files.append((k[order], v[order]))
            rc.numShuffleMerges += 1
        rc.times["shuffle"] = time.perf_counter() - t0

        # ---- sort/merge steps 1-3 (paper §3.2, counts via merge_math) ----
        t0 = time.perf_counter()
        on_disk = merged_files + shuffle_files
        files_to_merge = len(on_disk) + (1 if in_mem else 0)
        if files_to_merge > 1:
            plan = merge_plan(files_to_merge, F)
            rc.sortMergeReadBytes = (
                plan.interm_reads / max(files_to_merge, 1)
            ) * (sum(f[0].shape[0] for f in on_disk)
                 + sum(g[0].shape[0] for g in in_mem)) * width
        all_k = [f[0] for f in on_disk] + [g[0] for g in in_mem]
        all_v = [f[1] for f in on_disk] + [g[1] for g in in_mem]
        k = np.concatenate(all_k) if all_k else np.empty(0, np.int64)
        v = np.concatenate(all_v) if all_v else np.empty(0, np.float32)
        order = np.argsort(k, kind="stable")
        k, v = k[order], v[order]
        rc.times["sort"] = time.perf_counter() - t0

        # ---- reduce + write (paper §3.3) ----
        t0 = time.perf_counter()
        rc.inReducePairs = int(k.shape[0])
        out_k, out_v = [], []
        if k.size:
            uniq, starts = np.unique(k, return_index=True)
            rc.inReduceGroups = int(uniq.shape[0])
            bounds = np.append(starts, k.shape[0])
            if job.reduce_fn is None or job.reduce_pairs_per_group is None:
                out_k, out_v = [k], [v]
            else:
                groups = [
                    job.reduce_fn(v[bounds[i]:bounds[i+1]])
                    for i in range(uniq.shape[0])
                ]
                out_v = [np.concatenate(groups)]
                out_k = [np.repeat(uniq, [g.shape[0] for g in groups])]
        ok = np.concatenate(out_k) if out_k else np.empty(0, np.int64)
        ov = np.concatenate(out_v) if out_v else np.empty(0, np.float32)
        rc.outReducePairs = int(ok.shape[0])
        out_ratio = 0.4 if hp.pIsOutCompressed else 1.0
        rc.outReduceSize = ok.shape[0] * job.out_pair_width * out_ratio
        rc.times["reduce_write"] = time.perf_counter() - t0
        return (ok, ov), rc

    # -------------------------------------------------------------- job
    def run_job(self, keys: np.ndarray, values: np.ndarray) -> JobCounters:
        hp = self.hp
        jc = JobCounters()
        M = max(hp.pNumMappers, 1)
        splits_k = np.array_split(keys, M)
        splits_v = np.array_split(values, M)

        all_segments: list[list] = [[] for _ in range(max(hp.pNumReducers, 1))]
        map_only_out = []
        for mk, mv in zip(splits_k, splits_v):
            segments, mc = self.run_map_task(mk, mv)
            jc.maps.append(mc)
            if hp.pNumReducers == 0:
                map_only_out.extend(segments)
            else:
                for r, seg in enumerate(segments):
                    all_segments[r].append(seg)

        if hp.pNumReducers == 0:
            ok = np.concatenate([s[0] for s in map_only_out])
            ov = np.concatenate([s[1] for s in map_only_out])
            jc.output = (ok, ov)
            return jc

        # network: all segments except the node-local fraction (Eq. 90)
        nodes = max(hp.pNumNodes, 1)
        total_interm = sum(mc.intermDataSize for mc in jc.maps)
        jc.netTransferBytes = total_interm * (nodes - 1) / nodes

        outs_k, outs_v = [], []
        for r in range(hp.pNumReducers):
            (ok, ov), rc = self.run_reduce_task(all_segments[r])
            jc.reduces.append(rc)
            outs_k.append(ok)
            outs_v.append(ov)
        jc.output = (np.concatenate(outs_k), np.concatenate(outs_v))
        return jc
