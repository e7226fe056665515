"""Multi-head latent attention (MLA), DeepSeek-V2's attention (arXiv:2405.04434
§2.1), with its YaRN rope scaling.  The reference package has no MLA: this
follows DeepSeek-V2's published modelling code.

A layer's weights (``attn``, a :class:`~repro_torch.models.layers.ParamTree`):
``q`` (d, H, dn + dr), ``kv_a`` (d, R + dr), ``kv_norm.scale`` (R,) fp32,
``kv_b`` (R, H, dn + dv) and ``o`` (H, dv, d), with R = ``kv_lora_rank``,
dn = ``qk_nope_head_dim``, dr = ``qk_rope_head_dim``, dv = ``v_head_dim``:

* q = x W_q, per head [q_nope (dn) | q_pe (dr)] (no q LoRA);
* [c_kv (R) | k_pe (dr)] = x W_kv_a; c_kv = RMSNorm(c_kv) (its own scale,
  ``norm_eps``); k_pe is one rotary key that every head shares;
* per head [k_nope (dn) | v (dv)] = c_kv W_kv_b;
* rope on q_pe and k_pe as interleaved pairs (2i, 2i + 1) at the YaRN
  frequencies (:func:`yarn_frequencies`);
* softmax scale (dn + dr) ** -0.5 * m ** 2 with m = 0.1 * mscale_all_dim *
  ln(factor) + 1 (:func:`softmax_scale`).

**Prefill** (:func:`mla_prefill`) forms k = [k_nope | k_pe] and v per head
and runs the flash kernel at a q/k head dim of dn + dr, with v padded by
zeros to that dim and the output sliced back to dv; the softmax scale's m**2
is folded into q.  Its cache is the **latent cache**: ``{"latent": (B, S,
R + dr)}``, each position's normalised c_kv and roped k_pe, R + dr values a
token and layer whatever the number of heads.

**Decode** (:func:`mla_decode`) is absorbed: W_UK and W_UV are views of
W_kv_b (its first dn and last dv columns of each head), q_nope W_UK^T gives
an R-wide query per head, each head's scores are taken against the latent
rows, [q_lat | q_pe] . [c_kv | k_pe], and the attention's output, a
mixture of c_kv rows, goes through W_UV and then W_o.  The scores and the
mixture are the MLA decode kernel's
(:func:`repro_torch.kernels.mla_decode_attention`): one latent "kv head"
under the H query heads, values the first R columns of the same rows.
``pos`` stays on the device, so the step can be replayed as a CUDA graph.

Spans: ``attn.mla_prefill`` around each layer's prefill.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as _flash_kernel
from repro_torch.kernels import mla_decode_attention as _mla_decode_kernel
from repro_torch.kernels.mla_decode import mla_decode_torch
from repro_torch.obs import span

from .attention import _out_project, chunked_attention, get_attention_impl, project_heads
from .config import ModelConfig
from .layers import apply_norm, apply_rope

__all__ = ["mla_decode", "mla_prefill", "mla_spec", "softmax_scale", "yarn_frequencies",
           "yarn_mscale"]


def yarn_mscale(factor: float, mscale: float) -> float:
    """``yarn_get_mscale``: 0.1 * mscale * ln(factor) + 1, or 1 at factor <= 1."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def _correction_dim(rotations: float, dim: int, theta: float, max_pos: int) -> float:
    """The rotary dim whose wavelength fits ``rotations`` turns in
    ``max_pos`` positions (``yarn_find_correction_dim``)."""
    return dim * math.log(max_pos / (rotations * 2 * math.pi)) / (2 * math.log(theta))


def yarn_frequencies(cfg: ModelConfig, device=None) -> torch.Tensor:
    """Inverse frequencies (fp32, dr / 2) of the rotary dims: theta **
    (-2i / dr), divided by the factor (interpolation) below the ramp, as
    they are (extrapolation) above it, and blended linearly over the ramp
    between the correction dims of ``beta_fast`` and ``beta_slow``
    rotations in the original context."""
    dim, theta, factor = cfg.qk_rope_head_dim, cfg.rope_theta, cfg.rope_scaling_factor
    extra = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                            / dim)
    if factor <= 1:
        return extra
    low = max(math.floor(_correction_dim(cfg.rope_beta_fast, dim, theta,
                                         cfg.rope_original_max_position)), 0)
    high = min(math.ceil(_correction_dim(cfg.rope_beta_slow, dim, theta,
                                         cfg.rope_original_max_position)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp                       # the extrapolated share
    return extra / factor * (1.0 - keep) + extra * keep


def softmax_scale(cfg: ModelConfig) -> float:
    """(dn + dr) ** -0.5, times m ** 2 under YaRN with ``mscale_all_dim``."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    if cfg.rope_scaling_factor > 1 and cfg.rope_mscale_all_dim:
        scale *= yarn_mscale(cfg.rope_scaling_factor, cfg.rope_mscale_all_dim) ** 2
    return scale


def _check(cfg: ModelConfig) -> None:
    if cfg.q_lora_rank is not None:
        raise NotImplementedError(f"{cfg.name}: MLA with a q LoRA is not built")
    if cfg.rope_scaling_factor > 1 and yarn_mscale(
            cfg.rope_scaling_factor, cfg.rope_mscale) != yarn_mscale(
            cfg.rope_scaling_factor, cfg.rope_mscale_all_dim):
        raise NotImplementedError(f"{cfg.name}: YaRN with mscale != mscale_all_dim "
                                  "(a rotary amplitude other than 1) is not built")


def mla_spec(cfg: ModelConfig, dtype) -> dict:
    """The ``attn`` tree of an MLA layer: ``{name: (shape, dtype)}``."""
    _check(cfg)
    d, H, R = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {"q": ((d, H, dn + dr), dtype), "kv_a": ((d, R + dr), dtype),
            "kv_norm": {"scale": ((R,), torch.float32)},
            "kv_b": ((R, H, dn + dv), dtype), "o": ((H, dv, d), dtype)}


def _latent(p, x: torch.Tensor, positions: torch.Tensor, inv_freq, cfg: ModelConfig):
    """[normalised c_kv | roped k_pe] (B, S, R + dr) of x (B, S, d) at
    ``positions`` (S,) or a 0-dim tensor."""
    R = cfg.kv_lora_rank
    kv = x @ p["kv_a"].to(x.dtype)
    c = apply_norm(p["kv_norm"], kv[..., :R], "rmsnorm", cfg.norm_eps)
    k_pe = apply_rope(kv[..., R:], positions.reshape(1, -1), inv_freq)
    return torch.cat([c, k_pe], dim=-1)


def mla_prefill(p, x: torch.Tensor, inv_freq: torch.Tensor, cfg: ModelConfig, *,
                cache_size: int | None = None):
    """MLA over a prompt x (B, S, d), causal; returns (y, the latent cache
    of ``cache_size`` slots or None)."""
    with span("attn.mla_prefill"):
        B, S, _ = x.shape
        H, R, dn, dv = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.v_head_dim
        positions = torch.arange(S, device=x.device)
        q = project_heads(x, p["q"])                            # (B, H, S, dn + dr)
        q_pe = apply_rope(q[..., dn:], positions[None, None, :], inv_freq)
        latent = _latent(p, x, positions, inv_freq, cfg)        # (B, S, R + dr)
        kv = project_heads(latent[..., :R], p["kv_b"])          # (B, H, S, dn + dv)
        k_pe = latent[:, None, :, R:].expand(B, H, S, -1)
        k = torch.cat([kv[..., :dn], k_pe], dim=-1)
        # the kernels scale scores by hd ** -0.5: MLA's m ** 2 goes into q
        ratio = softmax_scale(cfg) * k.shape[-1] ** 0.5
        q = (torch.cat([q[..., :dn], q_pe], dim=-1).float() * ratio).to(x.dtype)
        v = F.pad(kv[..., dn:], (0, k.shape[-1] - dv))          # V padded to hd
        if get_attention_impl() == "kernel":
            out = _flash_kernel(q, k.contiguous(), v.contiguous(), causal=True)
        else:
            out = chunked_attention(q, k, v, causal=True)
        y = _out_project(out[..., :dv], p["o"])
        cache = None
        if cache_size is not None:
            cache = {"latent": torch.zeros((B, cache_size, latent.shape[-1]),
                                           dtype=x.dtype, device=x.device)}
            upto = min(S, cache_size)
            cache["latent"][:, :upto] = latent[:, :upto]
    return y, cache


def mla_decode(p, x: torch.Tensor, cache: dict, pos: torch.Tensor,
               inv_freq: torch.Tensor, cfg: ModelConfig):
    """One token x (B, 1, d) at ``pos`` (0-dim int32 on the device), absorbed:
    writes its latent row at slot ``pos`` in place and attends over slots
    0 .. pos.  Returns (y, cache)."""
    B = x.shape[0]
    R, dn = cfg.kv_lora_rank, cfg.qk_nope_head_dim
    lat = cache["latent"]
    lat.index_copy_(1, pos.reshape(1).long(), _latent(p, x, pos, inv_freq, cfg))
    q = project_heads(x, p["q"])[:, :, 0]                       # (B, H, dn + dr)
    q_pe = apply_rope(q[:, :, None, dn:], pos.reshape(1, 1, 1), inv_freq)[:, :, 0]
    w = p["kv_b"].to(x.dtype)
    w_uk, w_uv = w[:, :, :dn], w[:, :, dn:]                     # views of W_kv_b
    q_lat = torch.einsum("bhn,rhn->bhr", q[..., :dn], w_uk)
    qa = torch.cat([q_lat, q_pe], dim=-1).contiguous()          # (B, H, R + dr)
    if get_attention_impl() == "kernel":
        o_lat = _mla_decode_kernel(qa, lat, pos, scale=softmax_scale(cfg), v_dim=R)
    else:
        o_lat = mla_decode_torch(qa, lat, pos, scale=softmax_scale(cfg), v_dim=R)
    out = torch.einsum("bhr,rhv->bhv", o_lat, w_uv)             # (B, H, dv)
    return _out_project(out[:, :, None], p["o"]), cache
