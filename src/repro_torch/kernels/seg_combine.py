"""``seg_combine`` on Hopper: the CUDA kernel, its build, and its plain version.

The kernel (``csrc/seg_combine.cu``) replaces the reference package's Pallas
kernel ``repro/kernels/seg_combine.py::seg_combine_kernel``: per-partition
fp32 sums ``out[p, :] = sum(values[n, :] for ids[n] == p)``, with ids outside
``[0, P)`` dropped.  The source says why it is an atomic scatter here
rather than the TPU's one-hot matrix product.

It is compiled with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface and loaded with ``ctypes``, at first use, into
``build/repro_torch/`` at the root of the checkout, keyed by a hash of the
source and flags (so a fresh checkout builds it once, in seconds).

:func:`seg_combine_torch` is the plain PyTorch version of the same
function.  The CPU path of :func:`repro_torch.kernels.seg_combine` and the
tests use it; on the card it is only the yardstick the kernel is held to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["build", "seg_combine_cuda", "seg_combine_torch"]

_SRC = Path(__file__).resolve().parent / "csrc" / "seg_combine.cu"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC"]
_LIB = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build() -> Path:
    """Compile ``seg_combine.cu`` (once per source hash); the library path."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    lib = _BUILD_DIR / f"seg_combine_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *_FLAGS, "-o", str(tmp), str(_SRC)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {_SRC.name}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for fn in (lib.seg_combine_f32, lib.seg_combine_bf16):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def seg_combine_cuda(
    values: torch.Tensor, ids: torch.Tensor, num_parts: int
) -> torch.Tensor:
    """Launch the kernel on the current stream; no checks, no synchronise.

    ``values`` (N, D) contiguous f32/bf16 and ``ids`` (N,) contiguous int32
    on one CUDA device, N * D > 0.  Callers go through
    :func:`repro_torch.kernels.seg_combine`, which checks all of that.
    """
    n, d = values.shape
    out = torch.zeros((num_parts, d), dtype=torch.float32, device=values.device)
    lib = _lib()
    fn = lib.seg_combine_f32 if values.dtype == torch.float32 else lib.seg_combine_bf16
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(values.data_ptr(), ids.data_ptr(), out.data_ptr(),
                 n, d, num_parts, stream)
    if err != 0:
        raise RuntimeError(f"seg_combine kernel launch failed: CUDA error {err}")
    return out


def seg_combine_torch(
    values: torch.Tensor, ids: torch.Tensor, num_parts: int
) -> torch.Tensor:
    """Plain PyTorch version: ids outside ``[0, P)`` contribute nothing,
    then ``index_add_`` in fp32."""
    out = torch.zeros((num_parts, values.shape[1]), dtype=torch.float32,
                      device=values.device)
    if num_parts == 0:
        return out
    keep = (ids >= 0) & (ids < num_parts)
    vals = torch.where(keep[:, None], values.float(), 0.0)
    return out.index_add_(0, torch.where(keep, ids, 0), vals)
