"""``seg_combine`` on Hopper: the CUDA kernel's launcher and its plain version.

The kernel (``csrc/seg_combine.cu``) replaces the reference package's Pallas
kernel ``repro/kernels/seg_combine.py::seg_combine_kernel``: per-partition
fp32 sums ``out[p, :] = sum(values[n, :] for ids[n] == p)``, with ids outside
``[0, P)`` dropped.  The source says why it is an atomic scatter here
rather than the TPU's one-hot matrix product.

It is built and loaded at first use by :mod:`repro_torch.kernels._build`.

:func:`seg_combine_torch` is the plain PyTorch version of the same
function.  The CPU path of :func:`repro_torch.kernels.seg_combine` and the
tests use it; on the card it is only the yardstick the kernel is held to.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import LaunchSpec, check, load

__all__ = ["coverage", "launch_spec", "seg_combine_cuda", "seg_combine_torch"]

THREADS = 256      # one (n, d) element a thread

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p]
_SIGNATURES = {"seg_combine_f32": _ARGS, "seg_combine_bf16": _ARGS}


def launch_spec(n: int, d: int) -> LaunchSpec:
    """The kernel's launch: one thread per (n, d) element, 256 a block."""
    return LaunchSpec(grid=(-(-n * d // THREADS), 1, 1), block=(THREADS, 1, 1),
                      smem_bytes=0)


def coverage(n: int, d: int) -> tuple[tuple[int, int, int], tuple[int, int, int]]:
    """What the grid must cover, per grid axis (x, y, z): the N * D elements
    on x, and what one CTA covers of it: 256 of them.  The kernel drops the
    threads past N * D."""
    return (n * d, 1, 1), (THREADS, 1, 1)


def seg_combine_cuda(
    values: torch.Tensor, ids: torch.Tensor, num_parts: int, spec: LaunchSpec,
) -> torch.Tensor:
    """Launch the kernel on the current stream; no checks, no synchronise.

    ``values`` (N, D) contiguous f32/bf16 and ``ids`` (N,) contiguous int32
    on one CUDA device, N * D > 0, launched with ``spec``.  Callers go
    through :func:`repro_torch.kernels.seg_combine`, which checks all of
    that.
    """
    n, d = values.shape
    out = torch.zeros((num_parts, d), dtype=torch.float32, device=values.device)
    lib = load("seg_combine", _SIGNATURES)
    fn = lib.seg_combine_f32 if values.dtype == torch.float32 else lib.seg_combine_bf16
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(values.data_ptr(), ids.data_ptr(), out.data_ptr(),
                 n, d, num_parts, spec.grid[0], spec.block[0], stream)
    check(err, "seg_combine")
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
