"""Registry of the architectures the port serves.

``get_config(name)`` resolves an ``--arch`` id to its exact public config,
as the reference's ``repro.configs.get_config`` does; ``ARCHS`` lists all
ten architectures, in the reference's order.  The shape cells of
``repro/configs/shapes.py`` belong to the dry-run slice.
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
    "recurrentgemma-9b": "recurrentgemma_9b",
    "internvl2-26b": "internvl2_26b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mamba2-130m": "mamba2_130m",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}


def get_config(name: str) -> ModelConfig:
    key = name.replace("_", "-")
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[key]}")
    return mod.CONFIG
