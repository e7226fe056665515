"""A plain float32 multi-head latent attention (MLA) LM, DeepSeek-V2's
(arXiv:2405.04434 §2.1 and its published modelling code): the benchmark's
reference for latent-attention configurations.

Plain PyTorch: it imports nothing of the program under test and nothing of
JAX, and takes from :mod:`perfbench.reference.lm` only what that file
exports for every configuration (the norm, the FFN with its DeepSeekMoE
block, the embedding, the logits, :class:`Precision`).  Its attention is
its own, in the published, non-absorbed form, for each head h:

* q = x W_q, split into [q_nope | q_pe]; [c_kv | k_pe] = x W_kv_a;
  c_kv = RMSNorm(c_kv) with its own scale; [k_nope | v] = c_kv W_kv_b;
* q_pe and the one k_pe of all heads rotated as interleaved pairs
  (2i, 2i + 1) at the YaRN frequencies, times the YaRN amplitude
  m(factor, mscale) / m(factor, mscale_all_dim);
* scores [q_nope | q_pe] . [k_nope | k_pe] times (dn + dr) ** -0.5 * m ** 2,
  m = m(factor, mscale_all_dim) = 0.1 mscale_all_dim ln(factor) + 1; causal
  softmax; out = P v, then W_o.

The configuration comes in the benchmark's flat keys
(:func:`perfbench.mla_weights.flat`), the weights in
:func:`perfbench.mla_weights.layout`'s names.  Every product goes through
the :class:`Precision` (its ``mm`` for the weights, its ``q`` on both
operands of the attention's products), float32 with TF32 off unless the
control asks for less.  Departures from the source, which the program
shares: the top-k gates renormalised to sum 1 (``norm_topk_prob`` true),
and a prefill that drops a document's expert assignments beyond capacity
(the program's prefill of one document, k-major), while decode routes
dropless.
"""

from __future__ import annotations

import math

import torch

from .lm import Precision, embed, ffn, logits, norm

__all__ = ["chosen_logits", "mla_layer", "softmax_scale", "yarn_frequencies"]

#: query rows a block of the attention takes
BLOCK_ROWS = 1024


def _mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_frequencies(cfg: dict, device=None) -> torch.Tensor:
    """The rotary dims' inverse frequencies, as DeepSeek-V2's
    ``DeepseekV2YarnRotaryEmbedding`` computes them: for i < dr / 2 the
    plain theta ** (-2i / dr) times 1 - r plus the same divided by the
    factor times r, where the ramp r rises linearly from 0 at the
    correction dim of ``beta_fast`` turns in the original context to 1 at
    that of ``beta_slow`` turns."""
    dim, base, factor = cfg["qk_rope_head_dim"], cfg["rope_theta"], cfg["rope_scaling_factor"]
    plain = base ** (-torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    if factor <= 1:
        return plain
    orig = cfg["rope_original_max_position"]

    def corr(turns):
        return dim * math.log(orig / (turns * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr(cfg["rope_beta_fast"])), 0)
    high = min(math.ceil(corr(cfg["rope_beta_slow"])), dim - 1)
    high = high + 0.001 if low == high else high
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    return plain / factor * ramp + plain * (1 - ramp)


def softmax_scale(cfg: dict) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    if cfg["rope_scaling_factor"] > 1 and cfg["rope_mscale_all_dim"]:
        scale *= _mscale(cfg["rope_scaling_factor"], cfg["rope_mscale_all_dim"]) ** 2
    return scale


def _rope(x: torch.Tensor, positions: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Rotate pairs (2i, 2i + 1) of x (..., S, dr) at ``positions`` (S,)."""
    inv = yarn_frequencies(cfg, x.device)
    amp = (_mscale(cfg["rope_scaling_factor"], cfg["rope_mscale"])
           / _mscale(cfg["rope_scaling_factor"], cfg["rope_mscale_all_dim"]))
    ang = positions.float()[:, None] * inv
    cos, sin = torch.cos(ang) * amp, torch.sin(ang) * amp
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * cos - b * sin, b * cos + a * sin], dim=-1).flatten(-2)


def latent(h: torch.Tensor, w: dict, p: str, cfg: dict, positions, prec: Precision):
    """[normalised c_kv | roped k_pe] (B, S, R + dr) of h (B, S, d)."""
    R = cfg["kv_lora_rank"]
    kv = prec.mm(h, w[p + "attn.kv_a"])
    c = kv[..., :R]
    c = c * torch.rsqrt(c.square().mean(-1, keepdim=True) + cfg["norm_eps"]) \
        * w[p + "attn.kv_norm.scale"].float()
    return torch.cat([c, _rope(kv[..., R:], positions, cfg)], dim=-1)


def mla_layer(x: torch.Tensor, w: dict, i: int, cfg: dict, positions: torch.Tensor,
              prec: Precision, *, past: tuple | None = None, capacity: int | None = None):
    """One pre-norm block over x (B, S, d) at ``positions`` (S,), attending
    causally over ``past`` (latent rows (B, P, R + dr), their positions)
    and itself.  Returns (x, this call's latent rows)."""
    p = f"layers.{i}."
    B, S, _ = x.shape
    H, R = cfg["n_heads"], cfg["kv_lora_rank"]
    dn, dv = cfg["qk_nope_head_dim"], cfg["v_head_dim"]
    h = norm(x, w, p + "ln1", cfg)
    q = prec.mm(h, w[p + "attn.q"].flatten(1)).view(B, S, H, -1).transpose(1, 2)
    q = torch.cat([q[..., :dn], _rope(q[..., dn:], positions, cfg)], dim=-1)
    lat = latent(h, w, p, cfg, positions, prec)
    lat_all, k_pos = lat, positions
    if past is not None:
        lat_all = torch.cat([past[0], lat], dim=1)
        k_pos = torch.cat([past[1], positions])
    Sk = lat_all.shape[1]
    kv = prec.mm(lat_all[..., :R], w[p + "attn.kv_b"].flatten(1))
    kv = kv.view(B, Sk, H, -1).transpose(1, 2)                   # (B, H, Sk, dn + dv)
    k = torch.cat([kv[..., :dn], lat_all[:, None, :, R:].expand(B, H, Sk, -1)], dim=-1)
    q, k, v = prec.q(q), prec.q(k), prec.q(kv[..., dn:])
    scale = softmax_scale(cfg)
    out = torch.empty((B, H, S, dv), dtype=torch.float32, device=x.device)
    for r0 in range(0, S, BLOCK_ROWS):
        r1 = min(S, r0 + BLOCK_ROWS)
        s = (q[:, :, r0:r1] @ k.transpose(-1, -2)) * scale
        s = s.masked_fill(k_pos[None, :] > positions[r0:r1, None], float("-inf"))
        out[:, :, r0:r1] = torch.softmax(s, dim=-1) @ v
    o = out.transpose(1, 2).reshape(B, S, H * dv)
    x = x + prec.mm(o, w[p + "attn.o"].flatten(0, 1))
    x = x + ffn(norm(x, w, p + "ln2", cfg), w, i, cfg, capacity, prec)
    return x, lat


@torch.no_grad()
def chosen_logits(w: dict, cfg: dict, document: torch.Tensor, follows: torch.Tensor,
                  first: int, capacity: int | None, prec: Precision) -> torch.Tensor:
    """Logits (n * (L - first), V) over the sequences [document, follows[j]]
    (document (S,), follows (n, L)) at the positions of ``follows`` from
    ``first`` on, one layer at a time: the document alone (routed with
    ``capacity``, as the program's prefill routes it), then the n
    continuations over its latent rows (dropless)."""
    S = document.shape[0]
    n, L = follows.shape
    dev = document.device
    pos_d = torch.arange(S, device=dev)
    pos_f = torch.arange(S, S + L, device=dev)
    xd, xf = embed(document[None], w), embed(follows, w)
    for i in range(cfg["n_layers"]):
        xd_next, lat = mla_layer(xd, w, i, cfg, pos_d, prec, capacity=capacity)
        xf, _ = mla_layer(xf, w, i, cfg, pos_f, prec, past=(lat.expand(n, -1, -1), pos_d))
        xd = xd_next
    return logits(xf[:, first:], w, cfg, prec).flatten(0, 1)
