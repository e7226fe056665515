"""Registry of the architectures the port serves.

``get_config(name)`` resolves an ``--arch`` id to its exact public config,
as the reference's ``repro.configs.get_config`` does.  ``ARCHS`` lists the
architectures this port has; asking for one of the reference's others
raises ``NotImplementedError`` naming the ``ROADMAP.md`` item that ports it.
The shape cells of ``repro/configs/shapes.py`` belong to the dry-run slice.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "get_config"]

ARCHS: dict[str, str] = {
    "gemma2-9b": "gemma2_9b",
    "starcoder2-7b": "starcoder2_7b",
    "granite-3-8b": "granite_3_8b",
    "stablelm-1.6b": "stablelm_1_6b",
    "internvl2-26b": "internvl2_26b",
}

_PENDING: dict[str, str] = {
    "deepseek-moe-16b": "queue 1 item 17 (MoE)",
    "moonshot-v1-16b-a3b": "queue 1 item 17 (MoE)",
    "mamba2-130m": "queue 1 item 17 (SSM)",
    "recurrentgemma-9b": "queue 1 item 17 (RG-LRU and prefix layers)",
    "seamless-m4t-large-v2": "queue 1 item 17 (enc-dec)",
}


def get_config(name: str) -> ModelConfig:
    key = name.replace("_", "-")
    if key in _PENDING:
        raise NotImplementedError(
            f"{key} is not ported yet: ROADMAP.md {_PENDING[key]}")
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[key]}")
    return mod.CONFIG
