"""Public entry points of the port's kernels.

Each wrapper checks what its kernel takes and raises on anything else,
launches the hand-written CUDA kernel for a CUDA tensor, and takes the
kernel's plain PyTorch version only for a tensor on the CPU.  There is no
fallback: a CUDA tensor launches the kernel or raises.  Each wrapper counts
its kernel launches in ``<wrapper>.launches``, a plain integer, so a run can
show that its main path went through the kernel.
"""

from __future__ import annotations

import torch

from .seg_combine import seg_combine_cuda, seg_combine_torch

__all__ = ["seg_combine"]

_VALUE_DTYPES = (torch.float32, torch.bfloat16)


def seg_combine(
    values: torch.Tensor,       # (N, D) f32 or bf16, contiguous
    part_ids: torch.Tensor,     # (N,) int32, contiguous; outside [0, P) dropped
    num_parts: int,
) -> torch.Tensor:
    """Per-partition sums, shape (P, D) fp32 (the map-side combine).

    Ids outside ``[0, P)`` are dropped, as the reference's Pallas kernel
    drops them.  (The reference's jnp oracle clips ids >= P into row P-1;
    the kernel, and this port, do not.)
    """
    if values.dim() != 2:
        raise ValueError(f"values must be (N, D), got shape {tuple(values.shape)}")
    if values.dtype not in _VALUE_DTYPES:
        raise TypeError(f"values must be float32 or bfloat16, got {values.dtype}")
    if part_ids.dim() != 1 or part_ids.shape[0] != values.shape[0]:
        raise ValueError(
            f"part_ids must be (N,) with N = {values.shape[0]}, "
            f"got shape {tuple(part_ids.shape)}")
    if part_ids.dtype != torch.int32:
        raise TypeError(f"part_ids must be int32, got {part_ids.dtype}")
    if not (values.is_contiguous() and part_ids.is_contiguous()):
        raise ValueError("values and part_ids must be contiguous")
    if values.device != part_ids.device:
        raise ValueError(
            f"values on {values.device} but part_ids on {part_ids.device}")
    num_parts = int(num_parts)
    if num_parts < 0:
        raise ValueError(f"num_parts must be >= 0, got {num_parts}")
    if values.device.type == "cpu":
        return seg_combine_torch(values, part_ids, num_parts)
    if values.device.type != "cuda":
        raise ValueError(f"seg_combine runs on cuda or cpu, not {values.device}")
    if values.numel() == 0 or num_parts == 0:
        return torch.zeros((num_parts, values.shape[1]), dtype=torch.float32,
                           device=values.device)
    out = seg_combine_cuda(values, part_ids, num_parts)
    seg_combine.launches += 1
    return out


seg_combine.launches = 0
