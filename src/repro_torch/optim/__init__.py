"""Optimizers of the port: the in-tree AdamW that calibration, gradient
search and training descend with, and the reference's gradient compression
(``compress.py``: bf16, and int8 with error feedback) for the cross-pod
reduction of :mod:`repro_torch.runtime.crosspod`."""

from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm, lr_at
from .compress import compress_grads, compress_init, decompress_grads

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm", "lr_at",
           "compress_grads", "compress_init", "decompress_grads"]
