"""Fault-tolerant checkpointing: atomic, async, CRC-verified, elastic.

The port of ``repro/checkpoint/manager.py``, with the same on-disk format,
so that either package reads a directory the other wrote::

    <dir>/step_000000123/
        manifest.json      # treedef, per-leaf {shape, dtype, crc32, file},
                           # step, wall time, extra
        leaf_00000.npy ... # one .npy per leaf (the global logical array)

A tree is nested dicts (keys in sorted order, as ``jax.tree_util``
flattens them), lists and tuples of leaves: tensors (DTensors too), numpy
arrays or Python numbers.  ``bfloat16`` leaves are stored as the reference
stores them, 2-byte void records under the manifest's dtype string
``"bfloat16"``, and read back as 2-byte views, so that neither side needs
``ml_dtypes``.

Guarantees:

* **Atomicity** — written to ``step_N.tmp`` then ``os.rename``d; a crash
  mid-save never corrupts the latest valid checkpoint.  ``restore`` scans
  newest to oldest and skips any step whose manifest or CRCs fail.
* **Async** — ``save(..., blocking=False)`` copies every leaf to the host on
  the caller's thread (a non-blocking device copy, then one synchronise),
  then writes on a background thread; its error surfaces at the next
  :meth:`~CheckpointManager.wait`.
* **Keep-N GC** — the oldest checkpoints are pruned after each save.
* **Many ranks** — every rank calls ``save`` (gathering a DTensor is a
  collective); rank 0 of the default process group copies and writes, the
  others return after the gathers.
* **Elastic restore** — leaves are global logical arrays: a DTensor is
  gathered on save (:func:`repro_torch.launch.mesh.full_tensor`, all-reduces
  only, so gloo gathers CUDA tensors too), and ``restore(shardings=...)``
  spreads each leaf onto its (possibly different) mesh and placements with
  ``distribute_tensor``, so a run can move from dp=1 to dp=2 and back.

:attr:`~CheckpointManager.stats` holds the last save's and restore's
bytes and seconds.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.launch.mesh import full_tensor

__all__ = ["CheckpointManager", "flatten", "unflatten"]

#: torch dtypes numpy has no type for, stored as raw records of their width
_RAW = {torch.bfloat16: ("bfloat16", torch.int16)}
_RAW_BY_NAME = {name: (dt, view) for dt, (name, view) in _RAW.items()}


def flatten(tree) -> tuple[list, str]:
    """(leaves in ``jax.tree_util``'s order, a treedef string like the
    reference's): dict keys sorted, lists and tuples in order."""
    leaves: list = []

    def walk(t) -> str:
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}" for k in sorted(t)) + "}"
        if isinstance(t, (list, tuple)):
            inner = ", ".join(walk(v) for v in t)
            return f"[{inner}]" if isinstance(t, list) else f"({inner})"
        leaves.append(t)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def unflatten(example, leaves: list):
    """``leaves`` (in :func:`flatten`'s order) in ``example``'s structure."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)([build(v) for v in t])
        leaf = next(it, it)
        if leaf is it:
            raise ValueError("fewer leaves than the example tree has")
        return leaf

    out = build(example)
    if next(it, it) is not it:
        raise ValueError("more leaves than the example tree has")
    return out


def _contiguous(arr: np.ndarray) -> np.ndarray:
    # np.ascontiguousarray would turn a 0-d array into a 1-d one
    return arr if arr.flags.c_contiguous else arr.copy(order="C")


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(_contiguous(arr).reshape(-1).view(np.uint8))


def _snapshot(leaf) -> torch.Tensor | np.ndarray:
    """A host copy the caller may go on mutating the original of: a DTensor
    gathered, a device tensor copied without blocking (the caller
    synchronises once), a host tensor or array cloned."""
    if isinstance(leaf, DTensor):
        leaf = full_tensor(leaf)
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.device.type == "cpu":
            return leaf.clone()
        return leaf.to("cpu", non_blocking=True)
    return np.array(leaf)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(the array to write, its manifest dtype string)."""
    if isinstance(leaf, np.ndarray):
        return leaf, str(leaf.dtype)
    if leaf.dtype in _RAW:
        name, view = _RAW[leaf.dtype]
        arr = leaf.contiguous().view(view).numpy()
        return arr.view(np.dtype(f"V{arr.itemsize}")), name
    arr = leaf.contiguous().numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype_str: str) -> torch.Tensor:
    """The stored array as a tensor of the manifest's dtype (raw records
    re-viewed, as the reference's ``_restore_dtype`` does)."""
    if dtype_str in _RAW_BY_NAME:
        dt, view = _RAW_BY_NAME[dtype_str]
        raw = _contiguous(arr).view(np.dtype(str(view).removeprefix("torch.")))
        return torch.from_numpy(raw).view(dt)
    if str(arr.dtype) != dtype_str:
        target = np.dtype(dtype_str)
        arr = arr.view(target) if arr.dtype.kind == "V" and \
            arr.dtype.itemsize == target.itemsize else arr.astype(target)
    return torch.from_numpy(_contiguous(arr))


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._last_error: Exception | None = None
        #: ``save``: step, bytes, snapshot_s (host copy on the caller's
        #: thread), write_s (files, CRCs, rename, GC); ``restore``: step,
        #: bytes, seconds
        self.stats: dict[str, dict] = {}

    # ---------------------------------------------------------------- save
    def save(self, step: int, tree, *, blocking: bool = True, extra: dict | None = None):
        """Snapshot ``tree`` for ``step``."""
        self.wait()  # one in-flight async save at a time
        t0 = time.perf_counter()
        leaves, treedef = flatten(tree)
        if dist.is_initialized() and dist.get_rank() != 0:
            for leaf in leaves:         # the gathers are collectives; no copy
                if isinstance(leaf, DTensor):
                    full_tensor(leaf)
            return
        host = [_snapshot(leaf) for leaf in leaves]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        stats = {"step": step, "snapshot_s": time.perf_counter() - t0}

        def write():
            try:
                t1 = time.perf_counter()
                tmp = os.path.join(self.dir, f"step_{step:09d}.tmp")
                final = os.path.join(self.dir, f"step_{step:09d}")
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                manifest = {"step": step, "treedef": treedef, "time": time.time(),
                            "extra": extra or {}, "leaves": []}
                nbytes = 0
                for i, leaf in enumerate(host):
                    arr, dtype_str = _to_numpy(leaf)
                    fname = f"leaf_{i:05d}.npy"
                    np.save(os.path.join(tmp, fname), arr)
                    manifest["leaves"].append({"file": fname, "shape": list(arr.shape),
                                               "dtype": dtype_str, "crc32": _crc(arr)})
                    nbytes += arr.nbytes
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()
                self.stats["save"] = {**stats, "bytes": nbytes,
                                      "write_s": time.perf_counter() - t1}
            except Exception as e:  # surfaced on the next wait()
                self._last_error = e

        if blocking:
            write()
            self._raise_pending()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def _raise_pending(self):
        if self._last_error is not None:
            e, self._last_error = self._last_error, None
            raise e

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"), ignore_errors=True)

    # ------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def _load_step(self, step: int, example_tree, shardings):
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        places = flatten(shardings)[0] if shardings is not None else None
        if places is not None and len(places) != len(manifest["leaves"]):
            raise ValueError("shardings do not match the checkpoint's leaves")
        leaves, nbytes = [], 0
        for i, meta in enumerate(manifest["leaves"]):
            arr = np.load(os.path.join(path, meta["file"]))
            if _crc(arr) != meta["crc32"]:
                raise IOError(f"CRC mismatch in {path}/{meta['file']}")
            nbytes += arr.nbytes
            t = _from_numpy(arr, meta["dtype"])
            if places is not None:
                sh = places[i]
                t = distribute_tensor(t.to(sh.mesh.device_type), sh.mesh,
                                      sh.placements, src_data_rank=None)
            leaves.append(t)
        return unflatten(example_tree, leaves), manifest, nbytes

    def restore(self, example_tree, *, step: int | None = None, shardings=None):
        """The latest (or given) valid checkpoint; skips corrupt ones.

        ``example_tree`` gives the structure (its leaves may be meta
        tensors).  Leaves come back as CPU tensors or, with ``shardings``
        (a tree of :class:`~repro_torch.launch.sharding.NamedPlacement`
        matching ``example_tree``), as DTensors on their mesh: elastic
        scale-up and down.  Returns (tree, manifest) or (None, None) when nothing valid
        exists.
        """
        self.wait()
        steps = [step] if step is not None else list(reversed(self.all_steps()))
        for s in steps:
            t0 = time.perf_counter()
            try:
                tree, manifest, nbytes = self._load_step(s, example_tree, shardings)
            except (OSError, EOFError, ValueError, KeyError):
                continue
            self.stats["restore"] = {"step": s, "bytes": nbytes,
                                     "seconds": time.perf_counter() - t0}
            return tree, manifest
        return None, None
