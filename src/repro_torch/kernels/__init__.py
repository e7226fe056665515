"""Hand-written Hopper kernels of the port, one per TPU kernel on its path.

  seg_combine      — per-partition sums (the Hadoop collect/partition/
                     combine step), ``csrc/seg_combine.cu``;
  flash_attention  — blocked online-softmax GQA attention for prefill:
                     bf16 on ``wgmma`` with TMA-fed tiles,
                     ``csrc/flash_attention_wgmma.cu``; fp32 on the CUDA
                     cores, ``csrc/flash_attention.cu``;
  decode_attention — one token's GQA attention over a full or ring KV
                     cache in one launch: CTAs share the live span at
                     ``pos`` and the last one merges; bf16 on the tensor
                     cores (``mma.sync``), fp32 on the CUDA cores,
                     ``csrc/decode_attention.cu``;
  fixture_copy     — a tiled copy, the kernel of the static analyzer's
                     known-bad launch fixture, ``csrc/fixture_copy.cu``.

Each is CUDA C++ for sm_90a, built by :mod:`._build` and bound with ctypes,
and replaces the reference's Pallas kernel of the same name
(``fixture_copy``: the one in ``repro/analysis/fixtures.py``).  Each has its
launcher and plain PyTorch version (``<name>.py``) and a checked, counted
public wrapper (``ops.py``).
"""

from .ops import fixture_copy, flash_attention, gqa_decode_attention, seg_combine

__all__ = ["fixture_copy", "flash_attention", "gqa_decode_attention",
           "seg_combine"]
