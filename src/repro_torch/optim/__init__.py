"""Optimizers of the port: the in-tree AdamW that calibration and gradient
search descend with.  The reference package's gradient compression
(``repro/optim/compress.py``) comes with training (``ROADMAP.md`` queue 1,
item 16)."""

from .adamw import AdamWConfig, adamw_init, adamw_update, lr_at

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "lr_at"]
