"""RG-LRU recurrent block (RecurrentGemma / Griffin).

The port of ``repro/models/rglru.py``, in plain PyTorch (the reference has
no Pallas kernel here): a gated linear branch and a recurrent branch
(causal conv -> Real-Gated LRU), multiplied and projected back::

    r_t = sigmoid(W_a x_t + b_a)            # recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            # input gate
    a_t = exp(c * r_t * (-softplus(L)))     # decay in (0, 1), c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The gates, the decay and h are fp32, and ``wa``, ``wx``, their biases and
``lam`` are kept in fp32, as the reference uses them.  Prefill solves the
linear recurrence with a log-depth doubling scan (Hillis-Steele) in fp32:
``ceil(log2 S)`` steps of ``(a, u) <- (a_t a_{t-s}, a_t u_{t-s} + u_t)``,
the reference's ``associative_scan`` with the same combine.  (A closed form
through cumulative log-decays would overflow: ``log a`` reaches about
``-8 softplus(lam)`` a step.)  Decode is the exact O(1) update.  GELU is
the tanh form, ``jax.nn.gelu``'s default.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from .config import ModelConfig

__all__ = ["init_rglru_state", "linear_scan", "lam_init", "rglru_decode",
           "rglru_prefill", "rglru_spec"]

_C = 8.0  # Griffin's fixed gate sharpness

#: parameters used in fp32 whatever the compute dtype, as the reference does
FP32_LEAVES = ("wa", "ba", "wx", "bx", "lam")


def rglru_spec(cfg: ModelConfig, dtype) -> dict:
    """The reference's ``init_rglru`` tree as ``{name: (shape, dtype)}``."""
    d, r = cfg.d_model, cfg.d_rnn
    f32 = torch.float32
    return {"in_x": ((d, r), dtype), "in_g": ((d, r), dtype),
            "conv_w": ((cfg.rglru_conv, r), dtype), "conv_b": ((r,), dtype),
            "wa": ((r, r), f32), "ba": ((r,), f32),
            "wx": ((r, r), f32), "bx": ((r,), f32),
            "lam": ((r,), f32), "out": ((r, d), dtype)}


def lam_init(r: int, device=None) -> torch.Tensor:
    """The reference's Lambda: ``log(expm1(linspace(2, 6, r)))``, so that
    ``a^c`` spans about (0.9, 0.999)."""
    return torch.log(torch.expm1(torch.linspace(2.0, 6.0, r, device=device)))


def init_rglru_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    r = cfg.d_rnn
    return {"h": torch.zeros((batch, r), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.rglru_conv - 1, r), dtype=dtype,
                                device=device)}


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _gates(p: Mapping, x: torch.Tensor):
    """x: (..., r) conv output -> (a, gated input u), fp32."""
    xf = x.float()
    r_gate = torch.sigmoid(xf @ p["wa"] + p["ba"])
    i_gate = torch.sigmoid(xf @ p["wx"] + p["bx"])
    a = torch.exp(-_C * r_gate * F.softplus(p["lam"]))
    u = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i_gate * xf)
    return a, u


def linear_scan(a: torch.Tensor, u: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """All h_t of ``h_t = a_t h_{t-1} + u_t`` (h_{-1} = 0) along ``dim``, by
    doubling: after the step with shift s, (a_t, u_t) compose the last 2s
    steps up to t."""
    a, u = a.movedim(dim, 0), u.movedim(dim, 0)
    s, n = 1, a.shape[0]
    while s < n:
        u = torch.cat([u[:s], a[s:] * u[:-s] + u[s:]])
        a = torch.cat([a[:s], a[s:] * a[:-s]])
        s *= 2
    return u.movedim(0, dim)


def rglru_prefill(p: Mapping, x: torch.Tensor, cfg: ModelConfig
                  ) -> tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (y (B, S, d), final state)."""
    B, S, _ = x.shape
    dtype = x.dtype
    gate = _gelu(x @ p["in_g"].to(dtype))
    xr_raw = x @ p["in_x"].to(dtype)                               # (B, S, r)
    km1 = cfg.rglru_conv - 1
    w = p["conv_w"].to(dtype)
    pad = F.pad(xr_raw, (0, 0, km1, 0))
    conv = torch.zeros_like(xr_raw)
    for i in range(cfg.rglru_conv):
        conv = conv + pad[:, i:i + S, :] * w[i]
    conv = conv + p["conv_b"].to(dtype)

    a, u = _gates(p, conv)
    h_all = linear_scan(a, u, dim=1)                               # (B, S, r)
    y = (h_all.to(dtype) * gate) @ p["out"].to(dtype)
    take = min(S, km1)
    state_conv = torch.zeros((B, km1, xr_raw.shape[-1]), dtype=dtype, device=x.device)
    state_conv[:, km1 - take:] = xr_raw[:, S - take:]
    return y, {"h": h_all[:, -1], "conv": state_conv}


def rglru_decode(p: Mapping, x: torch.Tensor, state: Mapping, cfg: ModelConfig
                 ) -> tuple[torch.Tensor, dict]:
    """One-token decode; x: (B, 1, d).  Returns (y, the new state); the
    caller writes the state where it keeps it."""
    dtype = x.dtype
    gate = _gelu(x @ p["in_g"].to(dtype))                          # (B, 1, r)
    xr = x @ p["in_x"].to(dtype)
    hist = torch.cat([state["conv"], xr], dim=1)                   # (B, K, r)
    conv = torch.einsum("bkr,kr->br", hist, p["conv_w"].to(dtype)) + p["conv_b"].to(dtype)
    a, u = _gates(p, conv)                                         # (B, r)
    h = a * state["h"] + u
    y = (h[:, None, :].to(dtype) * gate) @ p["out"].to(dtype)
    return y, {"h": h, "conv": hist[:, 1:]}
