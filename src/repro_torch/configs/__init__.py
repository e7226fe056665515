"""Registry of the architectures the port serves.

``get_config(name)`` resolves an ``--arch`` id to its exact public config,
as the reference's ``repro.configs.get_config`` does; ``ARCHS`` lists all
ten architectures, in the reference's order.  ``PORT_ARCHS`` lists the
architectures the port serves beyond the reference's (DeepSeek-V2-Lite,
with latent attention), which ``get_config`` finds too.  The shape cells of
``repro/configs/shapes.py`` and their input specifications are
:mod:`repro_torch.configs.shapes`, re-exported here as ``repro.configs``
does.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable, input_specs, skip_reason
from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "PORT_ARCHS", "SHAPES", "ShapeSpec", "applicable", "get_config",
           "input_specs", "skip_reason"]

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


#: architectures only the port has (the reference has no latent attention)
PORT_ARCHS: dict[str, str] = {
    "deepseek-v2-lite": "deepseek_v2_lite",
}


def get_config(name: str) -> ModelConfig:
    key = name.replace("_", "-")
    module = ARCHS.get(key) or PORT_ARCHS.get(key)
    if module is None:
        raise KeyError(f"unknown arch {name!r}; known: {sorted({**ARCHS, **PORT_ARCHS})}")
    return importlib.import_module(f"repro_torch.configs.{module}").CONFIG
