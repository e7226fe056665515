"""Reference training steps: the plain float32 LM of :mod:`.lm` under
next-token cross-entropy, gradients accumulated over microbatches, and
AdamW as the benchmarked system documents it (global-norm clipping, linear
warm-up then cosine decay, bias-corrected moments, decoupled weight decay
on every parameter).

:func:`follow` runs the first steps from the harness's weights and batches
and returns what the benchmark compares: each step's loss, each leaf's
norm of the first step's clipped gradient, and each leaf's norm of the
parameters' change after the last step.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .lm import Precision, decoder_layer, embed, logits

__all__ = ["follow", "loss", "lr_at"]


def lr_at(opt: dict, step: int) -> float:
    if step < opt["warmup_steps"]:
        return opt["peak_lr"] * step / max(opt["warmup_steps"], 1)
    t = (step - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1)
    t = min(max(t, 0.0), 1.0)
    r = opt["min_lr_ratio"]
    return opt["peak_lr"] * (r + (1 - r) * 0.5 * (1 + math.cos(math.pi * t)))


def loss(w: dict, inputs: torch.Tensor, targets: torch.Tensor, cfg: dict,
         prec: Precision) -> torch.Tensor:
    """Mean next-token cross-entropy of a dense model; each layer is
    recomputed in the backward pass, so only one layer's activations live
    at a time."""
    if cfg.get("n_experts", 0):
        raise ValueError("the training reference covers dense models")
    x = embed(inputs, w)
    positions = torch.arange(inputs.shape[1], device=inputs.device)
    for i in range(cfg["n_layers"]):
        x = checkpoint(lambda h, i=i: decoder_layer(h, w, i, cfg, positions, prec)[0],
                       x, use_reentrant=False)
    lg = logits(x, w, cfg, prec)
    return F.cross_entropy(lg.flatten(0, 1), targets.flatten())


def follow(w0: dict, batches: list, cfg: dict, opt: dict, n_micro: int,
           prec: Precision) -> dict:
    """``len(batches)`` AdamW steps from the weights ``w0`` (left as they
    are), each batch ``(inputs, targets)`` split into ``n_micro`` row
    blocks.  Returns ``losses``, ``grad_norms`` (leaf -> norm of the first
    step's clipped gradient), ``change_norms`` (leaf -> norm of the last
    parameters minus ``w0``)."""
    names = list(w0)
    p = {k: w0[k].detach().float().clone().requires_grad_(True) for k in names}
    m = {k: torch.zeros_like(p[k]) for k in names}
    v = {k: torch.zeros_like(p[k]) for k in names}
    losses, grad_norms = [], {}
    for step, (inputs, targets) in enumerate(batches, start=1):
        acc = {k: torch.zeros_like(p[k]) for k in names}
        total = 0.0
        rows = inputs.shape[0] // n_micro
        for j in range(n_micro):
            sl = slice(j * rows, (j + 1) * rows)
            value = loss(p, inputs[sl], targets[sl], cfg, prec)
            grads = torch.autograd.grad(value, [p[k] for k in names])
            for k, g in zip(names, grads):
                acc[k] += g
            del grads
            total += float(value.detach())
        losses.append(total / n_micro)
        with torch.no_grad():
            g = {k: acc[k].div_(n_micro) for k in names}
            gnorm = math.sqrt(sum(float(g[k].square().sum()) for k in sorted(names)))
            scale = min(opt["grad_clip_norm"] / max(gnorm, 1e-9), 1.0)
            lr = lr_at(opt, step)
            bc1 = 1 - opt["b1"] ** step
            bc2 = 1 - opt["b2"] ** step
            for k in names:
                gk = g[k] * scale
                if step == 1:
                    grad_norms[k] = float(gk.norm())
                m[k].mul_(opt["b1"]).add_(gk, alpha=1 - opt["b1"])
                v[k].mul_(opt["b2"]).add_(gk.square(), alpha=1 - opt["b2"])
                upd = (m[k] / bc1) / ((v[k] / bc2).sqrt() + opt["eps"])
                p[k] -= lr * (upd + opt["weight_decay"] * p[k])
            del g, acc
    with torch.no_grad():
        change = {k: float((p[k] - w0[k].float()).norm()) for k in names}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
