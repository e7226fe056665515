"""The harness's side of the program under test (``repro_torch``): its
configuration as the config file states it, and its model holding the
weights the harness drew."""

from __future__ import annotations

import torch

#: keys of a config file that are not the program's configuration fields
META_KEYS = ("arch", "source", "reduced", "assumed", "departures", "notes")


def port_config(config: dict):
    """The program's ``ModelConfig``: its registered config ``arch`` with
    every field the file states set to the file's value."""
    from repro_torch.configs import get_config

    base = get_config(config["arch"])
    fields = {k: v for k, v in config.items() if k not in META_KEYS}
    unknown = [k for k in fields if not hasattr(base, k)]
    if unknown:
        raise KeyError(f"{config['arch']}: no such config fields {unknown}")
    return base.replace(**fields)


@torch.no_grad()
def load_model(cfg, weights: dict, device, param_dtype: torch.dtype):
    """The program's ``LM`` for ``cfg`` built without storage, each
    parameter then set to the harness's tensor of the same name (shapes and
    dtypes must agree)."""
    from torch import nn

    from repro_torch.models import weights as port_weights

    model = port_weights.empty(cfg, device="meta", param_dtype=param_dtype)
    names = [n for n, _ in model.named_parameters()]
    if sorted(names) != sorted(weights):
        raise KeyError(f"layouts differ: {sorted(set(names) ^ set(weights))[:8]}")
    for name in names:
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner) if owner else model
        old = getattr(module, leaf)
        new = weights[name]
        if tuple(new.shape) != tuple(old.shape) or new.dtype != old.dtype:
            raise ValueError(f"{name}: harness {tuple(new.shape)} {new.dtype}, "
                             f"program {tuple(old.shape)} {old.dtype}")
        setattr(module, leaf, nn.Parameter(new, requires_grad=old.requires_grad))
    model.init_buffers(torch.device(device))
    return model
