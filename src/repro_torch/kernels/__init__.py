"""Hand-written Hopper kernels of the port, one per TPU kernel on its path.

  seg_combine — per-partition sums (the Hadoop collect/partition/combine
                step), CUDA C++ for sm_90a in ``csrc/seg_combine.cu``;
                replaces the reference's Pallas ``seg_combine_kernel``.

Each kernel has its launcher and plain PyTorch version (``<name>.py``) and a
checked, counted public wrapper (``ops.py``).
"""

from .ops import seg_combine

__all__ = ["seg_combine"]
