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
                     known-bad launch fixture, ``csrc/fixture_copy.cu``;
  mla_decode       — absorbed multi-head latent attention for one decode
                     token: 16 heads over one latent cache row of 576,
                     values its first 512 columns, in one launch: a
                     persistent CTA a SM over an equal share of the
                     (batch row, tile) work, a producer warp keeping TMA
                     copies in flight, ``csrc/mla_decode.cu`` (no TPU
                     counterpart: the reference has no latent attention).

Each is CUDA C++ for sm_90a, built by :mod:`._build` and bound with ctypes,
and, but for ``mla_decode``, replaces the reference's Pallas kernel of the
same name (``fixture_copy``: the one in ``repro/analysis/fixtures.py``).  Each has its
launcher and plain PyTorch version (``<name>.py``) and a checked, counted
public wrapper (``ops.py``).  The PTX wrappers and host helpers that several
sources share (``cp.async``, mbarriers, TMA, ``ldmatrix``, ``mma.sync``,
lane reductions, the shared-memory limit, tensor-map encoding) live once, in
``csrc/hopper.cuh``.  Every launcher makes its one C call through
``_build.launch``, on PyTorch's current stream; the kernels that merge
partials on the device keep them in ``_build.scratch``.
"""

from .ops import (fixture_copy, flash_attention, gqa_decode_attention,
                  mla_decode_attention, seg_combine)

__all__ = ["fixture_copy", "flash_attention", "gqa_decode_attention",
           "mla_decode_attention", "seg_combine"]
