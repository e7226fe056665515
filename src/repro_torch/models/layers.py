"""Common neural layers: norms, MLPs, rotary positions, soft-capping.

The port of ``repro/models/layers.py``.  Each function takes its parameters
as a mapping (a ``dict`` of tensors or an ``nn.ParameterDict``) with the
reference's keys, so the two packages' parameters line up leaf for leaf.
Matmul weights are cast to the activations' dtype at use, as the reference
casts its fp32 weights; a serving model stores them in the compute dtype
(``cfg.dtype``) already, so there the cast is a no-op.  Norm scales are fp32.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ParamTree", "apply_norm", "apply_mlp", "rope_frequencies",
           "apply_rope", "softcap"]


class ParamTree(nn.Module):
    """A nested parameter dict as a module: ``tree[name]`` reads a parameter
    or a subtree, so the reference's functional code (``p["experts"]["wi"]``,
    ``"shared" in p``) reads the port's parameters under the reference's
    names, and ``named_parameters()`` gives dotted names
    (``moe.experts.wi``).  Leaves are made uninitialised from
    ``{name: (shape, dtype)}``."""

    def __init__(self, spec: Mapping, device):
        super().__init__()
        for name, leaf in spec.items():
            if isinstance(leaf, Mapping):
                self.add_module(name, ParamTree(leaf, device))
            else:
                shape, dtype = leaf
                self.register_parameter(name, nn.Parameter(
                    torch.empty(shape, dtype=dtype, device=device)))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def apply_norm(p: Mapping, x: torch.Tensor, norm_type: str, eps: float) -> torch.Tensor:
    """RMSNorm / LayerNorm with fp32 statistics (bf16-safe)."""
    xf = x.float()
    if norm_type == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(x.dtype)


def apply_mlp(p: Mapping, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    """swiglu / geglu: ``act(x @ wg) * (x @ wi) @ wo``; gelu: ``gelu(x @ wi) @ wo``.

    GELU is the tanh approximation, ``jax.nn.gelu``'s default.
    """
    h = x @ p["wi"].to(x.dtype)
    if mlp_type in ("swiglu", "geglu"):
        g = x @ p["wg"].to(x.dtype)
        act = F.silu(g) if mlp_type == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["wo"].to(x.dtype)


def rope_frequencies(head_dim: int, fraction: float, theta: float,
                     device=None) -> torch.Tensor:
    """Inverse frequencies (fp32) for the rotary subspace (fraction of head_dim)."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps)


def apply_rope(
    x: torch.Tensor,            # (..., seq, head_dim)
    positions: torch.Tensor,    # (..., seq) integer, broadcastable against x
    inv_freq: torch.Tensor,     # (rot/2,) fp32
) -> torch.Tensor:
    """Rotate the leading ``2 * len(inv_freq)`` channels in fp32, as
    interleaved pairs ``(x[..., 0::2], x[..., 1::2])``; pass the rest
    through."""
    rot = 2 * inv_freq.shape[0]
    if rot == 0:
        return x
    angles = positions[..., None].float() * inv_freq     # (..., seq, rot/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x_rot = x[..., :rot].float()
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    y = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    y = y.reshape(y.shape[:-2] + (rot,)).to(x.dtype)
    if rot < x.shape[-1]:
        return torch.cat([y, x[..., rot:]], dim=-1)
    return y


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    """Gemma-2 style soft-capping in fp32, cast back: ``cap * tanh(x / cap)``."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)
