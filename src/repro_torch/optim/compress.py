"""Gradient compression for the cross-pod all-reduce.

The port of ``repro/optim/compress.py``.  Two compressors applied *before*
the gradient all-reduce, with error feedback so that compression noise is
unbiased over steps:

* ``bf16`` — round to bfloat16 (half the cross-pod bytes).
* ``int8`` — per-tensor symmetric int8 quantization (a quarter), with an
  error-feedback accumulator (EF-SGD) carried by the caller.

Gradients are dicts of tensors by parameter name (the port's pytree); the
compressed int8 leaves are ``(int8 values, fp32 scale)`` tuples.  Only the
slow ``pod`` axis reduction uses them (:mod:`repro_torch.runtime.crosspod`).
"""

from __future__ import annotations

import torch

__all__ = ["compress_init", "compress_grads", "decompress_grads"]


def compress_init(params: dict, method: str) -> dict | None:
    """The error-feedback state: fp32 zeros per leaf for ``int8``, else
    None."""
    if method == "int8":
        return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
    return None


def _quant_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, fp32 scale): ``scale = max(max |g|, 1e-12) / 127``."""
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_grads(grads: dict, err: dict | None, method: str):
    """Returns (compressed dict, new error dict): bf16 leaves, or
    ``(int8 values, fp32 scale)`` tuples whose residual goes to the error
    state."""
    if method == "none":
        return grads, err
    if method == "bf16":
        return {k: g.to(torch.bfloat16) for k, g in grads.items()}, err
    if method == "int8":
        out, errs = {}, {}
        for k, g in grads.items():
            corrected = g.to(torch.float32) + err[k]
            q, scale = _quant_int8(corrected)
            out[k] = (q, scale)
            errs[k] = corrected - q.to(torch.float32) * scale
        return out, errs
    raise ValueError(f"unknown compression method {method!r}")


def decompress_grads(comp: dict, grads_like: dict, method: str) -> dict:
    """Back to each leaf of ``grads_like``'s dtype."""
    if method == "none":
        return comp
    if method == "bf16":
        return {k: c.to(grads_like[k].dtype) for k, c in comp.items()}
    if method == "int8":
        return {k: (q.to(torch.float32) * s).to(grads_like[k].dtype)
                for k, (q, s) in comp.items()}
    raise ValueError(method)
