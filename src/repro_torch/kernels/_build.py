"""Build and load the port's CUDA kernels.

Each kernel is one source ``csrc/<name>.cu`` with a plain C interface.  The
PTX wrappers and host helpers that several sources share live in one header,
``csrc/hopper.cuh``.  A source is compiled with ``nvcc`` for ``sm_90a`` into a
shared library and loaded with ``ctypes``, at first use, into
``build/repro_torch/`` at the root of the checkout.  The library's name
carries a hash of the source, of every ``csrc/*.cuh`` and of the flags, so a
fresh checkout builds each kernel once, in seconds, and an edited source or
header builds anew.  :func:`build` compiles several sources at once, one
``nvcc`` process each, all started together.

Every C launcher is called through :func:`launch`, on PyTorch's current
stream, and returns ``cudaGetLastError()`` after its launch; :func:`check`
turns a non-zero code into an exception.  A tiled kernel's launch geometry is
a :class:`LaunchSpec`, computed in Python from the shapes (so the CPU tests
reach it) and checked against the card's shared-memory limit before the
launch.  A kernel that merges partials on the device keeps them in
:func:`scratch`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

__all__ = ["MAX_SMEM_BYTES", "LaunchSpec", "build", "check", "launch", "load",
           "scratch"]

#: shared memory one block may have on an H100 (227 KB of the SM's 256 KB)
MAX_SMEM_BYTES = 232_448

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# ``-cudart shared``: the library uses the CUDA runtime PyTorch has loaded
# rather than linking a static copy of its own, so the process has one.
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xptxas=-v", "-cudart", "shared", "-shared", "-Xcompiler", "-fPIC"]
_LIBS: dict[str, ctypes.CDLL] = {}
_SCRATCH: dict[tuple, tuple] = {}


@dataclass(frozen=True)
class LaunchSpec:
    """Grid, block and dynamic shared-memory bytes of one kernel launch."""

    grid: tuple[int, int, int]
    block: tuple[int, int, int]
    smem_bytes: int

    def check(self, what: str) -> "LaunchSpec":
        """Raise when the launch needs more shared memory than a block can
        have on an H100; the launch would be refused."""
        if self.smem_bytes > MAX_SMEM_BYTES:
            raise ValueError(
                f"{what}: the launch needs {self.smem_bytes} bytes of shared "
                f"memory, above the {MAX_SMEM_BYTES} a block can have")
        return self


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _target(name: str) -> tuple[Path, Path]:
    """The source of ``name`` and its library, named for a hash of the
    source, every header beside it and the flags."""
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(_FLAGS).encode())
    return src, _BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def build(*names: str) -> dict[str, dict]:
    """Compile ``csrc/<name>.cu`` for each name not yet built, all in
    parallel.  Returns, per name, ``{"path", "seconds", "log"}``: the
    library, the wall time its ``nvcc`` took (0.0 when it was already
    built) and what ``nvcc`` printed (``-Xptxas=-v``: registers, shared
    memory and spills of each kernel)."""
    out: dict[str, dict] = {}
    procs = {}
    for name in names:
        src, lib = _target(name)
        if lib.exists():
            out[name] = {"path": lib, "seconds": 0.0, "log": ""}
            continue
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs[name] = (proc, tmp, lib, time.perf_counter())
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name}.cu:\n{log}")
        os.replace(tmp, lib)
        out[name] = {"path": lib, "seconds": seconds, "log": log}
    return out


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built at first use), with
    ``argtypes`` set from ``signatures`` and ``restype`` int for each C
    function named there."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)[name]["path"]))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def launch(fn, args: tuple, device) -> int:
    """Call the C launcher ``fn(*args, stream)`` with PyTorch's current
    stream on CUDA ``device`` (its raw ``cudaStream_t``, as
    ``torch.cuda.current_stream().cuda_stream`` gives it, without building
    a ``Stream`` object), inside a device context only when ``device`` is
    not the current device.  Returns the launcher's error code."""
    import torch

    index = device.index
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def scratch(device, key: tuple, rows: int, width: int, counters: int) -> tuple:
    """The scratch of a kernel that merges per-CTA partials on the device:
    fp32 ``m`` and ``l`` (rows,), fp32 ``acc`` (rows, width) and ``counters``
    int32 zeros, which the kernel leaves at 0 after every call.

    The buffers are made once per (device, ``key``) and are never freed or
    moved, so that a CUDA graph that captured a launch keeps valid pointers.
    One stream at a time: two calls of one key in flight on two streams
    would share them."""
    import torch

    k = (device.index, *key)
    bufs = _SCRATCH.get(k)
    if bufs is None:
        f32 = dict(dtype=torch.float32, device=device)
        bufs = _SCRATCH.setdefault(k, (
            torch.empty(rows, **f32), torch.empty(rows, **f32),
            torch.empty((rows, width), **f32),
            torch.zeros(counters, dtype=torch.int32, device=device)))
    return bufs


def check(err: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
