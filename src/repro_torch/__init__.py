"""repro_torch — the PyTorch/CUDA port of the Hadoop performance models.

It mirrors the module paths of the JAX package ``repro`` and imports none of
it: plain tensor code is PyTorch, and the one kernel of the job-tuning path,
``seg_combine``, is a hand-written CUDA kernel for Hopper
(:mod:`repro_torch.kernels`).  Entry points take ``device=None``, meaning the
CUDA card, and raise without one unless given ``device="cpu"``
(:func:`repro_torch.compat.resolve_device`).
"""
