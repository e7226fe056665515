"""AdamW with decoupled weight decay and linear-warmup cosine schedule.

Built here (no ``torch.optim``): the state mirrors the parameter dict, and
the arithmetic is the reference package's (``repro/optim/adamw.py``) cast
for cast, so that a descent of 80 to 400 steps follows the reference's
trajectory.  As there, the schedule, the bias corrections, the gradient
(cast before the moments) and the global norm are float32; the moments and
parameters keep their own dtype (float64 in calibration and gradient
search) by promotion.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm", "lr_at"]


@dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_ratio * peak``, in
    float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.peak_lr * (
        cfg.min_lr_ratio
        + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    )
    return torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: dict[str, torch.Tensor]) -> dict:
    first = next(iter(params.values()))
    return {
        "m": {k: torch.zeros_like(p) for k, p in params.items()},
        "v": {k: torch.zeros_like(p) for k, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def global_norm(grads: dict[str, torch.Tensor]) -> torch.Tensor:
    # the reference flattens the dict in sorted-key order
    sq = [torch.sum(torch.square(grads[k].to(torch.float32))) for k in sorted(grads)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def adamw_update(
    grads: dict[str, torch.Tensor],
    state: dict,
    params: dict[str, torch.Tensor],
    cfg: AdamWConfig,
    *,
    grad_norm: torch.Tensor | None = None,
) -> tuple[dict[str, torch.Tensor], dict, dict]:
    """Returns (new_params, new_state, metrics); nothing is updated in
    place.  ``grad_norm``: the global norm of the whole gradients, for a
    caller that updates one rank's shards of them (default: the norm of
    ``grads``)."""
    count = state["count"] + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.grad_clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(cfg, count)

    c32 = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=c32.device), c32)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=c32.device), c32)

    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].to(torch.float32) * scale
        m = cfg.b1 * state["m"][k] + (1 - cfg.b1) * g
        v = cfg.b2 * state["v"][k] + (1 - cfg.b2) * torch.square(g)
        mhat = m / bc1
        vhat = v / bc2
        step = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p
        new_p[k] = (p - lr * step).to(p.dtype)
        new_m[k], new_v[k] = m, v

    new_state = {"m": new_m, "v": new_v, "count": count}
    return new_p, new_state, {"grad_norm": gnorm, "lr": lr}
