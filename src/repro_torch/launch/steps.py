"""Step-function factories shared by the launchers.

The port of ``repro/launch/steps.py`` holds only :func:`init_params` so far:
serving runs ``LM.prefill`` / ``LM.decode_step`` eagerly, so it needs no
step factory.  The train step comes with training (``ROADMAP.md`` queue 1
item 16).
"""

from __future__ import annotations

import torch

from repro_torch.models import weights
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import LM

__all__ = ["init_params"]


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device=None) -> LM:
    """Seeded weights for ``cfg`` on ``device`` (None: the CUDA card); the
    counterpart of the reference's ``init_params(key, cfg)``.  Families not
    ported yet (enc-dec among them) raise ``NotImplementedError``."""
    return weights.init(cfg, generator, device=device)
