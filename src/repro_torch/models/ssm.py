"""Mamba-2 block via the SSD (state-space duality) chunked algorithm.

The port of ``repro/models/ssm.py``, in plain PyTorch (the reference has no
Pallas kernel here).  Prefill splits the sequence into chunks of 128: inside
a chunk the recurrence runs in its quadratic "attention-like" dual form,
across chunks only the (H, P, N) states are carried, by a Python loop over
the chunks (the reference's ``lax.scan``).  Decode is the exact O(1)
recurrence ``h = a h + dt * (B (x) x)``, ``y = C . h + D x``, with h in
fp32.

Three details follow the reference exactly:

* the sequence is zero-padded to a multiple of the chunk, and the padding's
  outputs are dropped;
* the conv cache holds the last ``K - 1`` *pre-activation* channel rows,
  right-aligned, with zeros in front when the prompt is shorter;
* the intra-chunk decay ``exp(cum_i - cum_j)`` above the diagonal can
  overflow; the port masks the exponent (-inf) before ``exp``, where the
  reference masks the product after it.  The forward is the same number,
  and autograd through the mask stays finite.

A single B/C group is shared by every head (n_groups 1, as mamba2-130m);
dt, A and D are per-head scalars kept in fp32.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import apply_norm

__all__ = ["init_ssm_state", "ssm_decode", "ssm_prefill", "ssm_spec"]

#: parameters used in fp32 whatever the compute dtype, as the reference does
FP32_LEAVES = ("A_log", "D", "dt_bias")


def _dims(cfg: ModelConfig):
    d_in = cfg.d_inner_ssm
    H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return d_in, H, P, N, d_in + 2 * N          # the conv runs over [x, B, C]


def ssm_spec(cfg: ModelConfig, dtype) -> dict:
    """The reference's ``init_ssm`` tree as ``{name: (shape, dtype)}``."""
    d = cfg.d_model
    d_in, H, P, N, conv_ch = _dims(cfg)
    f32 = torch.float32
    return {"in_proj": ((d, 2 * d_in + 2 * N + H), dtype),
            "conv_w": ((cfg.ssm_conv, conv_ch), dtype),
            "conv_b": ((conv_ch,), dtype),
            "A_log": ((H,), f32), "D": ((H,), f32), "dt_bias": ((H,), f32),
            "norm": {"scale": ((d_in,), f32)},
            "out_proj": ((d_in, d), dtype)}


def init_ssm_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    d_in, H, P, N, conv_ch = _dims(cfg)
    return {"h": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                                device=device)}


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    d_in, H, P, N, _ = _dims(cfg)
    return proj[..., :d_in], proj[..., d_in:2 * d_in + 2 * N], proj[..., -H:]


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along the sequence, xbc (B, S, C), w (K, C),
    as the reference's K unrolled shifts; then SiLU."""
    K, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(K):
        out = out + pad[:, i:i + S, :] * w[i]
    return F.silu(out + b)


def _out(p: Mapping, y: torch.Tensor, z: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    y = apply_norm(p["norm"], y * F.silu(z), "rmsnorm", cfg.norm_eps)
    return y @ p["out_proj"].to(y.dtype)


def _chunk(h, xc, bc, cc, dtc, lac):
    """One chunk of the SSD scan from state ``h`` (B, H, P, N): returns the
    next state and the chunk's outputs (B, L, H, P), all fp32."""
    L = xc.shape[1]
    cum = torch.cumsum(lac, dim=1)                                 # (B, L, H)
    # inter-chunk: the carried state's contribution
    y_inter = torch.einsum("bln,bhpn->blhp", cc, h) * torch.exp(cum)[..., None]
    # intra-chunk quadratic dual form, the exponent masked above the diagonal
    cb = torch.einsum("bin,bjn->bij", cc, bc)
    mask = torch.ones((L, L), dtype=torch.bool, device=h.device).tril()
    seg = cum[:, :, None, :] - cum[:, None, :, :]                  # (B, L, L, H)
    decay = torch.exp(torch.where(mask[None, :, :, None], seg, -torch.inf))
    w = cb[..., None] * decay
    y_intra = torch.einsum("bijh,bjh,bjhp->bihp", w, dtc, xc)
    # the state handed to the next chunk
    wj = torch.exp(cum[:, -1:, :] - cum) * dtc                     # (B, L, H)
    s_add = torch.einsum("bjh,bjn,bjhp->bhpn", wj, bc, xc)
    h_new = torch.exp(cum[:, -1, :])[..., None, None] * h + s_add
    return h_new, y_inter + y_intra


def ssm_prefill(p: Mapping, x: torch.Tensor, cfg: ModelConfig, *,
                chunk: int = 128) -> tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (y (B, S, d), final recurrent state)."""
    B, S, _ = x.shape
    d_in, H, P, N, conv_ch = _dims(cfg)
    dtype = x.dtype
    proj = x @ p["in_proj"].to(dtype)
    z, xbc_raw, dt_raw = _split_proj(cfg, proj)
    xbc = _causal_conv(xbc_raw, p["conv_w"].to(dtype), p["conv_b"].to(dtype))
    xs = xbc[..., :d_in].reshape(B, S, H, P)
    Bm, Cm = xbc[..., d_in:d_in + N], xbc[..., d_in + N:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])                 # (B, S, H)
    la = -torch.exp(p["A_log"]) * dt                               # log decay <= 0

    pad = (-S) % chunk
    seqs = [xs.float(), Bm.float(), Cm.float(), dt, la]
    if pad:
        seqs = [F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad)) for a in seqs]
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(0, S + pad, chunk):
        h, y_c = _chunk(h, *(a[:, c:c + chunk] for a in seqs))
        ys.append(y_c)
    y = torch.cat(ys, dim=1)[:, :S]
    y = y + p["D"][None, None, :, None] * xs.float()
    out = _out(p, y.reshape(B, S, d_in).to(dtype), z, cfg)

    # the conv cache: the last K-1 pre-activation rows, right-aligned
    km1 = cfg.ssm_conv - 1
    conv = torch.zeros((B, km1, conv_ch), dtype=dtype, device=x.device)
    take = min(S, km1)
    conv[:, km1 - take:] = xbc_raw[:, S - take:]
    return out, {"h": h, "conv": conv}


def ssm_decode(p: Mapping, x: torch.Tensor, state: Mapping, cfg: ModelConfig
               ) -> tuple[torch.Tensor, dict]:
    """One-token decode; x: (B, 1, d).  Returns (y, the new state); the
    caller writes the state where it keeps it."""
    B = x.shape[0]
    d_in, H, P, N, _ = _dims(cfg)
    dtype = x.dtype
    proj = x @ p["in_proj"].to(dtype)
    z, xbc_raw, dt_raw = _split_proj(cfg, proj)
    hist = torch.cat([state["conv"], xbc_raw], dim=1)              # (B, K, C)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", hist, p["conv_w"].to(dtype))
                      + p["conv_b"].to(dtype))
    xs = conv_out[:, :d_in].reshape(B, H, P).float()
    Bm = conv_out[:, d_in:d_in + N].float()
    Cm = conv_out[:, d_in + N:].float()
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])           # (B, H)
    a = torch.exp(-torch.exp(p["A_log"]) * dt)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt, Bm, xs)
    h = a[..., None, None] * state["h"] + upd
    y = torch.einsum("bn,bhpn->bhp", Cm, h) + p["D"][None, :, None] * xs
    out = _out(p, y.reshape(B, 1, d_in).to(dtype), z, cfg)
    return out, {"h": h, "conv": hist[:, 1:]}
