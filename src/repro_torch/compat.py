"""Device policy of the PyTorch port.

Every entry point of :mod:`repro_torch` that makes tensors takes
``device=None``, which means the CUDA card.  Without a card the entry point
raises unless the caller asked for the CPU explicitly (``device="cpu"``, as
the tests do): a run never carries on silently on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["has_cuda", "resolve_device"]


def has_cuda() -> bool:
    """True when PyTorch sees at least one CUDA device."""
    return torch.cuda.is_available()


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for and absent."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not has_cuda():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
