"""Decoder-only LM: dense, MoE, hybrid (RG-LRU + local attention) and SSM
families, served and trained, with the vision frontend's ``extra_embeds``.

The port of ``repro/models/lm.py``.  The reference keeps a heterogeneous
prefix of unstacked layers (recurrentgemma's two RG-LRU layers, a MoE
config's dense first layer), then stacks each pattern member's parameters
over groups and scans; here :class:`LM` is an ``nn.Module`` whose
:class:`DecoderLayer` s sit in one ``nn.ModuleList`` in layer order: the
prefix, then the reference's scan order (for each group, each member of
``cfg.layer_pattern``), so layer ``n_prefix + g * len(pattern) + mi`` is the
reference's ``params["groups"][mi][..][g]`` and layer ``i < n_prefix`` its
``params["prefix"][i]``.  Caches are a list of per-layer caches in the same
order: ``{"k", "v"}`` for an attention layer, ``{"h", "conv"}`` for a
recurrent one.

``forward``, ``prefill``, ``decode_step`` and ``loss_fn`` keep the
reference's names and semantics.  ``pos`` is a 0-dim int32 tensor on the
device: a decode step never reads it on the host, and writes every cache and
recurrent state in place, so that a CUDA graph can replay it.
``extra_embeds`` (B, E, d), the vision frontend's patch embeddings, are
cast to the compute dtype and put before the token embeddings; ``prefill``'s
next position counts them, and ``loss_fn`` drops their logits.
``forward(remat=True)`` (the reference's ``jax.checkpoint`` of each scan
group) recomputes each layer in the backward pass with
``torch.utils.checkpoint``; the numbers are the same.  ``forward``'s third
output is the MoE layers' summed aux loss (0 without MoE), which
``loss_fn`` weighs in.

Parameters: a serving model stores its matmul weights in the compute dtype
``cfg.dtype``, cast once at load (the reference casts its fp32 weights at
every use, which gives the same numbers).  Norm parameters, and the
recurrent blocks' parameters that the reference uses in fp32 (the SSM's
``A_log``, ``D``, ``dt_bias``; the RG-LRU's gates ``wa``, ``wx``, their
biases and ``lam``), stay fp32.  A training model is built with
``param_dtype=torch.float32``: fp32 master weights, cast to ``cfg.dtype`` at
each use, so gradients and AdamW state are fp32, as in the reference.  The
reference's ``act_sharding.constrain`` has no counterpart on one device.
Encoder-decoder configs are :class:`repro_torch.models.encdec.EncDec`.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.compat import resolve_device

from .attention import (
    attn_block_decode,
    attn_block_prefill,
    full_slot_positions,
    ring_slot_positions,
)
from .config import ModelConfig
from .layers import ParamTree, apply_mlp, apply_norm, rope_frequencies, softcap
from .moe import apply_moe, moe_spec
from .opt_flags import get_flags
from .rglru import rglru_decode, rglru_prefill, rglru_spec
from .ssm import ssm_decode, ssm_prefill, ssm_spec

__all__ = ["LM", "DecoderLayer", "ffn_kind", "layer_kinds", "prefix_kinds"]


def prefix_kinds(cfg: ModelConfig) -> list[str]:
    """Layers before the repeated pattern (the reference's unstacked
    prefix): ``cfg.prefix_pattern``, then a MoE config's first
    ``moe_layer_start`` layers, which keep a dense FFN (``"attn_dense"``)."""
    kinds = list(cfg.prefix_pattern)
    if cfg.n_experts and cfg.moe_layer_start > 0:
        kinds += ["attn_dense"] * cfg.moe_layer_start
    return kinds


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """Every layer's kind in the port's order: the prefix, then for each
    group each member of ``cfg.layer_pattern`` (the reference's group
    layer ``g * P + mi`` is layer ``n_prefix + g * P + mi``)."""
    return prefix_kinds(cfg) + list(cfg.layer_pattern) * cfg.n_groups


def ffn_kind(cfg: ModelConfig, kind: str) -> str:
    """Which FFN a layer uses: ``moe`` | ``dense`` | ``none`` (an SSM layer
    is the whole block)."""
    if kind == "ssm":
        return "none"
    if kind == "attn_dense":
        return "dense"
    return "moe" if cfg.n_experts else "dense"


def _norm(d: int, norm_type: str, device) -> nn.ParameterDict:
    p = {"scale": nn.Parameter(torch.ones(d, device=device))}
    if norm_type == "layernorm":
        p["bias"] = nn.Parameter(torch.zeros(d, device=device))
    return nn.ParameterDict(p)


def _weights(shapes: dict, dtype, device) -> nn.ParameterDict:
    return nn.ParameterDict({
        name: nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
        for name, shape in shapes.items()})


def attention_weights(cfg: ModelConfig, dtype, device) -> nn.ParameterDict:
    """q (d, H, hd), k and v (d, KV, hd), o (H, hd, d)."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return _weights({"q": (d, H, hd), "k": (d, KV, hd), "v": (d, KV, hd),
                     "o": (H, hd, d)}, dtype, device)


def mlp_weights(d: int, ff: int, mlp_type: str, dtype, device) -> nn.ParameterDict:
    shapes = {"wi": (d, ff), "wo": (ff, d)}
    if mlp_type in ("swiglu", "geglu"):
        shapes["wg"] = (d, ff)
    return _weights(shapes, dtype, device)


class DecoderLayer(nn.Module):
    """One residual block: a (sandwich-)normed token mixer, then the FFN.

    The mixer is attention (``attn``: q, k, v, o) for the kinds ``"attn"``,
    ``"local"`` and ``"attn_dense"``, ``rglru`` or ``ssm``; the FFN a dense
    ``mlp`` (wi, wg, wo; ``d_ff_dense`` wide in an ``"attn_dense"`` layer),
    a ``moe`` or none (``ssm``).  Parameters keep the reference's names:
    ``ln1``, the mixer, ``post1``, ``ln2``, the FFN, ``post2``.
    """

    def __init__(self, cfg: ModelConfig, kind: str, *, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.kind = kind
        self.mixer = "attn" if kind == "attn_dense" else kind
        self.ffn = ffn_kind(cfg, kind)
        self.ln1 = _norm(d, cfg.norm_type, device)
        if self.mixer in ("attn", "local"):
            self.attn = attention_weights(cfg, dtype, device)
        elif self.mixer == "rglru":
            self.rglru = ParamTree(rglru_spec(cfg, dtype), device)
        elif self.mixer == "ssm":
            self.ssm = ParamTree(ssm_spec(cfg, dtype), device)
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
        if self.ffn != "none":
            self.ln2 = _norm(d, cfg.norm_type, device)
            if self.ffn == "moe":
                self.moe = ParamTree(moe_spec(cfg, dtype), device)
            else:
                width = cfg.d_ff_dense if (kind == "attn_dense" and cfg.d_ff_dense) \
                    else cfg.d_ff
                self.mlp = mlp_weights(d, width, cfg.mlp_type, dtype, device)
        if cfg.use_post_norm:
            self.post1 = _norm(d, cfg.norm_type, device)
            if self.ffn != "none":
                self.post2 = _norm(d, cfg.norm_type, device)

    def _apply_norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(getattr(self, name), x, self.cfg.norm_type, self.cfg.norm_eps)

    def _residual(self, x: torch.Tensor, h: torch.Tensor, capacity: int | None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """x + the mixer's output, then the FFN's residual; returns (x, aux)."""
        if self.cfg.use_post_norm:
            h = self._apply_norm("post1", h)
        x = x + h
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.ffn == "none":
            return x, aux
        h = self._apply_norm("ln2", x)
        if self.ffn == "moe":
            h, aux = apply_moe(self.moe, h, self.cfg, capacity=capacity)
        else:
            h = apply_mlp(self.mlp, h, self.cfg.mlp_type)
        if self.cfg.use_post_norm:
            h = self._apply_norm("post2", h)
        return x + h, aux

    def train_forward(self, x, inv_freq):
        """The layer without caches (what ``torch.utils.checkpoint`` reruns),
        under the profiler range ``lm.layer``: in the backward pass that
        range is the recomputation.  Returns (x, aux)."""
        with record_function("lm.layer"):
            x, _, aux = self.prefill(x, inv_freq, None)
            return x, aux

    def prefill(self, x, inv_freq, cache_len: int | None):
        """Returns (x, cache or None, aux): the cache a ``{"k", "v"}`` dict
        of an attention layer, the ``{"h", "conv"}`` state of a recurrent
        one."""
        cfg = self.cfg
        h = self._apply_norm("ln1", x)
        if self.mixer in ("attn", "local"):
            size = None
            if cache_len is not None:
                size = min(cache_len, cfg.window_size) if self.mixer == "local" \
                    else cache_len
            h, cache = attn_block_prefill(
                self.attn, h, inv_freq, kind=self.mixer, window=cfg.window_size,
                logit_cap=cfg.attn_logit_softcap, cache_size=size)
        else:
            fn = rglru_prefill if self.mixer == "rglru" else ssm_prefill
            h, cache = fn(getattr(self, self.mixer), h, cfg)
            if cache_len is None:
                cache = None
        x, aux = self._residual(x, h, None)
        return x, cache, aux

    def decode(self, x, cache, pos, inv_freq, slot_pos):
        """One token; writes ``cache`` in place and returns (x, cache).  The
        MoE FFN runs dropless (capacity = B tokens, from the shape)."""
        cfg = self.cfg
        h = self._apply_norm("ln1", x)
        if self.mixer in ("attn", "local"):
            h, cache = attn_block_decode(
                self.attn, h, cache, pos, inv_freq, kind=self.mixer,
                window=cfg.window_size, logit_cap=cfg.attn_logit_softcap,
                slot_pos=slot_pos)
        else:
            fn = rglru_decode if self.mixer == "rglru" else ssm_decode
            h, new = fn(getattr(self, self.mixer), h, cache, cfg)
            for key, value in new.items():
                cache[key].copy_(value)
        x, _ = self._residual(x, h, x.shape[0] * x.shape[1])
        return x, cache


class LM(nn.Module):
    """Decoder-only LM with uninitialised weights; fill them with
    :func:`repro_torch.models.weights.init` or ``from_jax_params``.

    Matmul weights and the embedding are stored in ``param_dtype`` (default
    ``cfg.dtype``) and cast to ``cfg.dtype`` at each use (no copy when the
    two agree); norm scales and biases are fp32.  ``device=None`` means the
    CUDA card.
    """

    def __init__(self, cfg: ModelConfig, *, device=None,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        if cfg.is_encdec:
            raise ValueError(f"{cfg.name} is an encoder-decoder config: build it "
                             "with repro_torch.models.encdec.EncDec")
        dev = resolve_device(device)
        dtype = getattr(torch, cfg.dtype)
        self.cfg = cfg
        self.compute_dtype = dtype
        dtype = param_dtype or dtype
        self.embed = nn.Parameter(
            torch.empty((cfg.vocab_size, cfg.d_model), dtype=dtype, device=dev))
        self.final_norm = _norm(cfg.d_model, cfg.norm_type, dev)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, kind, dtype=dtype, device=dev)
            for kind in layer_kinds(cfg))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.empty((cfg.d_model, cfg.vocab_size), dtype=dtype, device=dev))
        self.register_buffer("inv_freq", rope_frequencies(
            cfg.head_dim, cfg.rope_fraction, cfg.rope_theta, device=dev),
            persistent=False)
        # the reference multiplies by jnp.asarray(d_model**0.5, dtype): in
        # bf16 that is 59.75 for gemma2-9b, not 59.866
        self.register_buffer("embed_scale", torch.tensor(
            cfg.d_model ** 0.5, dtype=self.compute_dtype, device=dev),
            persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _embed(self, tokens: torch.Tensor,
               extra_embeds: torch.Tensor | None = None) -> torch.Tensor:
        x = self.embed[tokens].to(self.compute_dtype)
        if self.cfg.tie_embeddings:
            x = x * self.embed_scale
        if extra_embeds is not None:
            x = torch.cat([extra_embeds.to(self.compute_dtype), x], dim=1)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            logits = x @ self.embed.to(x.dtype).T
        else:
            logits = x @ self.lm_head.to(x.dtype)
        return softcap(logits, self.cfg.final_logit_softcap)

    def forward(self, tokens: torch.Tensor, cache_len: int | None = None,
                logits_slice: int | None = None, *,
                extra_embeds: torch.Tensor | None = None, remat: bool = False):
        """Full-sequence forward.  Returns (logits, caches, aux_loss).

        ``cache_len``: build serve caches of this size (prefill mode); None
        for training.  ``logits_slice``: only produce logits for the last N
        positions.  ``extra_embeds`` (B, E, d) come before the tokens, so
        the logits cover E + S positions.  ``remat``: recompute each layer
        in the backward pass (training only).  ``aux_loss``: the MoE layers'
        load-balancing losses summed (fp32; 0 without MoE).
        """
        x = self._embed(tokens, extra_embeds)
        caches = [] if cache_len is not None else None
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in self.layers:
            if remat and cache_len is None and torch.is_grad_enabled():
                x, aux = checkpoint(layer.train_forward, x, self.inv_freq,
                                    use_reentrant=False)
            else:
                x, cache, aux = layer.prefill(x, self.inv_freq, cache_len)
                if caches is not None:
                    caches.append(cache)
            aux_total = aux_total + aux
        x = apply_norm(self.final_norm, x, self.cfg.norm_type, self.cfg.norm_eps)
        if logits_slice is not None:
            x = x[:, -logits_slice:]
        return self._logits(x), caches, aux_total

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int, *,
                extra_embeds: torch.Tensor | None = None):
        """Serve-path prompt processing: (last-token logits (B, 1, V), caches
        sized for ``max_len``, the next position as a 0-dim int32: the
        prompt's tokens plus the ``extra_embeds`` rows before them)."""
        logits, caches, _ = self.forward(tokens, cache_len=max_len, logits_slice=1,
                                         extra_embeds=extra_embeds)
        seq = tokens.shape[1] + (0 if extra_embeds is None else extra_embeds.shape[1])
        pos = torch.tensor(seq, dtype=torch.int32, device=tokens.device)
        return logits, caches, pos

    def loss_fn(self, batch: dict, *, remat: bool = True,
                aux_weight: float = 0.01):
        """Next-token cross-entropy (+ ``aux_weight`` times the MoE aux loss), the
        reference's ``lm.loss_fn``.  ``batch``: ``inputs``, ``targets`` (B, S)
        int, optional ``mask`` (B, S) and ``extra_embeds``; the targets align
        with the token part of the sequence.  Returns (total, metrics) with
        metrics ``loss``, ``aux_loss`` and ``tokens``, all computed in fp32.
        ``OptFlags.sharded_loss`` picks the cross-entropy's vocab-shard form
        (every (B, S, V) op elementwise), the same function.
        """
        extra = batch.get("extra_embeds")
        logits, _, aux = self.forward(batch["inputs"], extra_embeds=extra,
                                      remat=remat)
        if extra is not None:
            logits = logits[:, extra.shape[1]:]
        logits = logits.float()
        targets = batch["targets"].long()
        if get_flags().sharded_loss:
            m = logits.amax(dim=-1, keepdim=True).detach()
            z = torch.exp(logits - m).sum(dim=-1)
            logz = torch.log(z) + m[..., 0]
            vocab = torch.arange(logits.shape[-1], device=logits.device)
            gold = torch.where(vocab == targets[..., None], logits, 0.0).sum(dim=-1)
        else:
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, targets[..., None])[..., 0]
        nll = logz - gold
        mask = batch.get("mask")
        mask = torch.ones_like(nll) if mask is None else mask.to(nll.dtype)
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        total = loss + aux_weight * aux
        return total, {"loss": loss, "aux_loss": aux, "tokens": mask.sum()}

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches: list, pos: torch.Tensor):
        """One decode step for ``token`` (B, 1) at position ``pos`` (0-dim
        int32 on the device).  Writes the caches in place and returns
        (logits (B, 1, V), caches)."""
        x = self._embed(token)
        slot_pos: dict[tuple, torch.Tensor] = {}    # one per (mixer, size)
        for layer, cache in zip(self.layers, caches):
            key = None
            if layer.mixer in ("attn", "local"):
                size = cache["k"].shape[2]
                key = (layer.mixer, size)
                if key not in slot_pos:
                    slot_pos[key] = (ring_slot_positions(pos, size)
                                     if layer.mixer == "local"
                                     else full_slot_positions(size, x.device))
            x, _ = layer.decode(x, cache, pos, self.inv_freq, slot_pos.get(key))
        x = apply_norm(self.final_norm, x, self.cfg.norm_type, self.cfg.norm_eps)
        return self._logits(x), caches
