"""A plain float32 decoder-only LM: the benchmark's reference.

Written from the published descriptions, in plain PyTorch: it imports
nothing of the program under test (``repro_torch``) and nothing of JAX.  It
covers what the benchmark's configurations use: RMSNorm or LayerNorm,
rotary embeddings on the leading ``rope_fraction`` of each head (as
interleaved pairs), causal multi-head attention with grouped kv heads, a
SwiGLU MLP, and a DeepSeekMoE block (a softmax router over ``n_experts``,
top-k with ties to the lower index, gates renormalised over the k, SwiGLU
experts, always-on shared experts, dense FFNs before ``moe_layer_start``).

Routing capacity follows the rule the benchmarked system documents: with
``capacity`` set, an expert takes at most that many assignments, first
choices of every token before second choices (k-major), in token order
within one k; an assignment past the capacity is dropped.  ``capacity``
None is dropless.

Weights come as ``{name: tensor}`` in the harness's layout
(:mod:`perfbench.weights`), in any dtype: each matmul weight is read in
float32 at use, one layer at a time.  Every product goes through a
:class:`Precision`, float32 with TF32 off unless the control asks for a
lower precision.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["Precision", "attention", "decoder_layer", "embed", "ffn", "logits",
           "norm", "rope"]

_F8_MAX = {"e4m3": 448.0, "e5m2": 57344.0}
_F8_DTYPE = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}


def _fp8(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` rounded to fp8 with one scale for the tensor (its absolute
    maximum onto the format's largest value), back in float32."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / _F8_MAX[kind]
    return (x / scale).to(_F8_DTYPE[kind]).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    """Forward: the input rounded to e4m3; backward: the incoming gradient
    rounded to e5m2 (the usual fp8 training recipe)."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, "e4m3")

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, "e5m2")


class Precision:
    """How the reference multiplies: ``"fp32"`` (TF32 off); ``"fp8"`` (both
    operands of every matmul rounded to e4m3 with a per-tensor scale, their
    gradients to e5m2; float32 accumulation): the control; ``"bf16"`` (both
    operands rounded to bfloat16): the configurations' own compute
    precision, a witness of what rounding alone does."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8", "bf16"):
            raise ValueError(f"precision {kind!r}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp8":
            return _Fp8.apply(x)
        if self.kind == "bf16":
            return x.to(torch.bfloat16).to(torch.float32)
        return x

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.q(x) @ self.q(w.float())


def fp32_matmuls() -> None:
    """Turn TF32 off: float32 products stay float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def norm(x: torch.Tensor, w: dict, prefix: str, cfg: dict) -> torch.Tensor:
    scale = w[prefix + ".scale"].float()
    if cfg["norm_type"] == "layernorm":
        return F.layer_norm(x, x.shape[-1:], scale, w[prefix + ".bias"].float(),
                            cfg["norm_eps"])
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + cfg["norm_eps"]) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Rotate channel pairs (2i, 2i + 1) of the leading ``rope_fraction`` of
    each head by ``position * theta ** (-2i / rot)``; x (B, H, S, hd)."""
    hd = x.shape[-1]
    rot = int(hd * cfg["rope_fraction"])
    rot -= rot % 2
    if rot == 0:
        return x
    inv = cfg["rope_theta"] ** (-torch.arange(0, rot, 2, device=x.device,
                                              dtype=torch.float32) / rot)
    ang = positions.float()[:, None] * inv                      # (S, rot/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    a, b = x[..., 0:rot:2], x[..., 1:rot:2]
    out = torch.stack([a * cos - b * sin, b * cos + a * sin], dim=-1)
    return torch.cat([out.flatten(-2), x[..., rot:]], dim=-1)


def attention(q, k, v, q_pos, k_pos) -> torch.Tensor:
    """Softmax attention of q (B, H, Sq, hd) over k, v (B, KV, Sk, hd), each
    query seeing the keys at positions up to its own; one kv head serves
    H / KV query heads."""
    H, KV = q.shape[1], k.shape[1]
    k = k.repeat_interleave(H // KV, dim=1)
    v = v.repeat_interleave(H // KV, dim=1)
    s = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    s = s.masked_fill(k_pos[None, :] > q_pos[:, None], float("-inf"))
    return torch.softmax(s, dim=-1) @ v


def _heads(x, n):
    B, S, _ = x.shape
    return x.view(B, S, n, -1).transpose(1, 2)


def swiglu(x, wi, wg, wo, prec: Precision):
    return prec.mm(F.silu(prec.mm(x, wg)) * prec.mm(x, wi), wo)


def route(x: torch.Tensor, router: torch.Tensor, cfg: dict, capacity: int | None,
          prec: Precision):
    """Top-k experts and renormalised gates of each token of x (T, d); with
    ``capacity``, the k-major rule's keep mask (T, K)."""
    probs = torch.softmax(prec.mm(x, router), dim=-1)
    order = torch.sort(-probs, dim=-1, stable=True).indices[:, :cfg["moe_top_k"]]
    gates = torch.gather(probs, 1, order)
    gates = gates / gates.sum(-1, keepdim=True)
    keep = torch.ones_like(order, dtype=torch.bool)
    if capacity is not None:
        for e in range(cfg["n_experts"]):
            hit = (order == e).T.reshape(-1)                    # k-major
            rank = torch.cumsum(hit.long(), 0) - 1
            drop = (hit & (rank >= capacity)).view(order.shape[1], -1).T
            keep &= ~drop
    return order, gates, keep


def moe(x: torch.Tensor, w: dict, p: str, cfg: dict, capacity: int | None,
        prec: Precision) -> torch.Tensor:
    """A DeepSeekMoE block over x (T, d)."""
    order, gates, keep = route(x, w[p + "router"], cfg, capacity, prec)
    y = torch.zeros_like(x)
    for e in range(cfg["n_experts"]):
        t, j = torch.nonzero((order == e) & keep, as_tuple=True)
        if t.numel() == 0:
            continue
        out = swiglu(x[t], w[p + "experts.wi"][e], w[p + "experts.wg"][e],
                     w[p + "experts.wo"][e], prec)
        y = y.index_add(0, t, out * gates[t, j, None])
    if cfg.get("n_shared_experts", 0):
        y = y + swiglu(x, w[p + "shared.wi"], w[p + "shared.wg"], w[p + "shared.wo"],
                       prec)
    return y


def ffn(x: torch.Tensor, w: dict, i: int, cfg: dict, capacity: int | None,
        prec: Precision) -> torch.Tensor:
    p = f"layers.{i}."
    if cfg.get("n_experts", 0) and i >= cfg.get("moe_layer_start", 0):
        B, S, d = x.shape
        return moe(x.reshape(B * S, d), w, p + "moe.", cfg, capacity, prec).view(B, S, d)
    return swiglu(x, w[p + "mlp.wi"], w[p + "mlp.wg"], w[p + "mlp.wo"], prec)


def decoder_layer(x: torch.Tensor, w: dict, i: int, cfg: dict, positions,
                  prec: Precision, *, past: tuple | None = None,
                  capacity: int | None = None):
    """One pre-norm block over x (B, S, d) at ``positions`` (S,).  ``past``
    (k, v, k_pos) are keys and values of earlier positions to attend to as
    well.  Returns (x, (k, v)) with this call's rotated keys and values."""
    p = f"layers.{i}."
    H, KV = cfg["n_heads"], cfg["n_kv_heads"]
    h = norm(x, w, p + "ln1", cfg)
    q = rope(_heads(prec.mm(h, w[p + "attn.q"].flatten(1)), H), positions, cfg)
    k = rope(_heads(prec.mm(h, w[p + "attn.k"].flatten(1)), KV), positions, cfg)
    v = _heads(prec.mm(h, w[p + "attn.v"].flatten(1)), KV)
    ka, va, kp = k, v, positions
    if past is not None:
        ka = torch.cat([past[0], k], dim=2)
        va = torch.cat([past[1], v], dim=2)
        kp = torch.cat([past[2], positions])
    o = attention(prec.q(q), prec.q(ka), prec.q(va), positions, kp)
    B, _, S, _ = o.shape
    o = o.transpose(1, 2).reshape(B, S, -1)
    x = x + prec.mm(o, w[p + "attn.o"].flatten(0, 1))
    x = x + ffn(norm(x, w, p + "ln2", cfg), w, i, cfg, capacity, prec)
    return x, (k, v)


def embed(tokens: torch.Tensor, w: dict) -> torch.Tensor:
    return w["embed"][tokens].float()


def logits(x: torch.Tensor, w: dict, cfg: dict, prec: Precision) -> torch.Tensor:
    return prec.mm(norm(x, w, "final_norm", cfg), w["lm_head"])
