"""Decoder-only LM: dense models of ``"attn"`` / ``"local"`` layers, served
and trained, with the vision frontend's ``extra_embeds``.

The port of ``repro/models/lm.py`` for the families ported so far.  The
reference stacks each pattern member's parameters over groups and scans; here
:class:`LM` is an ``nn.Module`` whose :class:`DecoderLayer` s sit in one
``nn.ModuleList`` in layer order, the reference's scan order (for each group,
each member of ``cfg.layer_pattern``), so layer ``g * len(pattern) + mi`` is
the reference's ``params["groups"][mi][..][g]``.  Caches are a list of
per-layer ``{"k", "v"}`` dicts in the same order.

``forward``, ``prefill``, ``decode_step`` and ``loss_fn`` keep the
reference's names and semantics.  ``pos`` is a 0-dim int32 tensor on the
device: a decode step never reads it on the host.  ``extra_embeds`` (B, E,
d), the vision frontend's patch embeddings, are cast to the compute dtype
and put before the token embeddings; ``prefill``'s next position counts
them, and ``loss_fn`` drops their logits.  ``forward(remat=True)`` (the
reference's ``jax.checkpoint`` of each scan group) recomputes each layer in
the backward pass with ``torch.utils.checkpoint``; the numbers are the same.

Parameters: a serving model stores its matmul weights in the compute dtype
``cfg.dtype``, cast once at load (the reference casts its fp32 weights at
every use, which gives the same numbers).  A training model is built with
``param_dtype=torch.float32``: fp32 master weights, cast to ``cfg.dtype`` at
each use, so gradients and AdamW state are fp32, as in the reference.  The
reference's ``act_sharding.constrain`` has no counterpart on one device.
MoE, SSM, RG-LRU, prefix layers, the audio frontend and enc-dec raise
``NotImplementedError`` naming the ``ROADMAP.md`` item that ports them.
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
from .layers import apply_mlp, apply_norm, rope_frequencies, softcap
from .opt_flags import get_flags

__all__ = ["LM", "DecoderLayer"]


def _check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this port does not build yet."""
    todo = []
    if cfg.is_encdec:
        todo.append("enc-dec (ROADMAP.md queue 1 item 17)")
    if cfg.n_experts:
        todo.append("MoE (ROADMAP.md queue 1 item 17)")
    if cfg.prefix_pattern:
        todo.append("prefix layers (ROADMAP.md queue 1 item 17)")
    other = sorted(set(cfg.layer_pattern) - {"attn", "local"})
    if other:
        todo.append(f"{'/'.join(other)} layers (SSM, RG-LRU: ROADMAP.md "
                    "queue 1 item 17)")
    if cfg.frontend not in (None, "vision"):
        todo.append(f"the {cfg.frontend} frontend (enc-dec: ROADMAP.md queue 1 "
                    "item 17)")
    if todo:
        raise NotImplementedError(f"{cfg.name}: not ported yet: {'; '.join(todo)}")


def _norm(cfg: ModelConfig, device) -> nn.ParameterDict:
    p = {"scale": nn.Parameter(torch.ones(cfg.d_model, device=device))}
    if cfg.norm_type == "layernorm":
        p["bias"] = nn.Parameter(torch.zeros(cfg.d_model, device=device))
    return nn.ParameterDict(p)


def _weights(shapes: dict, dtype, device) -> nn.ParameterDict:
    return nn.ParameterDict({
        name: nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
        for name, shape in shapes.items()})


class DecoderLayer(nn.Module):
    """One residual block: (sandwich-)normed attention, then a dense FFN.

    Parameters keep the reference's names: ``ln1``, ``attn`` (q, k, v, o),
    ``post1``, ``ln2``, ``mlp`` (wi, wg, wo), ``post2``.
    """

    def __init__(self, cfg: ModelConfig, kind: str, *, dtype, device):
        super().__init__()
        d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.cfg = cfg
        self.kind = kind
        self.ln1 = _norm(cfg, device)
        self.attn = _weights({"q": (d, H, hd), "k": (d, KV, hd), "v": (d, KV, hd),
                              "o": (H, hd, d)}, dtype, device)
        self.ln2 = _norm(cfg, device)
        mlp = {"wi": (d, cfg.d_ff), "wo": (cfg.d_ff, d)}
        if cfg.mlp_type in ("swiglu", "geglu"):
            mlp["wg"] = (d, cfg.d_ff)
        self.mlp = _weights(mlp, dtype, device)
        if cfg.use_post_norm:
            self.post1 = _norm(cfg, device)
            self.post2 = _norm(cfg, device)

    def _apply_norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(getattr(self, name), x, self.cfg.norm_type, self.cfg.norm_eps)

    def _residual(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.use_post_norm:
            h = self._apply_norm("post1", h)
        x = x + h
        h = apply_mlp(self.mlp, self._apply_norm("ln2", x), self.cfg.mlp_type)
        if self.cfg.use_post_norm:
            h = self._apply_norm("post2", h)
        return x + h

    def train_forward(self, x, inv_freq):
        """The layer without caches (what ``torch.utils.checkpoint`` reruns),
        under the profiler range ``lm.layer``: in the backward pass that
        range is the recomputation."""
        with record_function("lm.layer"):
            return self.prefill(x, inv_freq, None)[0]

    def prefill(self, x, inv_freq, cache_len: int | None):
        cfg = self.cfg
        size = None
        if cache_len is not None:
            size = min(cache_len, cfg.window_size) if self.kind == "local" else cache_len
        h, cache = attn_block_prefill(
            self.attn, self._apply_norm("ln1", x), inv_freq, kind=self.kind,
            window=cfg.window_size, logit_cap=cfg.attn_logit_softcap,
            cache_size=size)
        return self._residual(x, h), cache

    def decode(self, x, cache, pos, inv_freq, slot_pos):
        cfg = self.cfg
        h, cache = attn_block_decode(
            self.attn, self._apply_norm("ln1", x), cache, pos, inv_freq,
            kind=self.kind, window=cfg.window_size,
            logit_cap=cfg.attn_logit_softcap, slot_pos=slot_pos)
        return self._residual(x, h), cache


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
        _check_supported(cfg)
        dev = resolve_device(device)
        dtype = getattr(torch, cfg.dtype)
        self.cfg = cfg
        self.compute_dtype = dtype
        dtype = param_dtype or dtype
        self.embed = nn.Parameter(
            torch.empty((cfg.vocab_size, cfg.d_model), dtype=dtype, device=dev))
        self.final_norm = _norm(cfg, dev)
        P = cfg.pattern_len
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, cfg.layer_pattern[i % P], dtype=dtype, device=dev)
            for i in range(cfg.n_groups * P))
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
        in the backward pass (training only).  ``aux_loss`` is 0: the dense
        families have none.
        """
        x = self._embed(tokens, extra_embeds)
        caches = [] if cache_len is not None else None
        for layer in self.layers:
            if remat and cache_len is None and torch.is_grad_enabled():
                x = checkpoint(layer.train_forward, x, self.inv_freq,
                               use_reentrant=False)
                continue
            x, cache = layer.prefill(x, self.inv_freq, cache_len)
            if caches is not None:
                caches.append(cache)
        x = apply_norm(self.final_norm, x, self.cfg.norm_type, self.cfg.norm_eps)
        if logits_slice is not None:
            x = x[:, -logits_slice:]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._logits(x), caches, aux

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
        """Next-token cross-entropy (+ the MoE aux term, 0 here), the
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
        slot_pos: dict[tuple, torch.Tensor] = {}    # one per (kind, size)
        for layer, cache in zip(self.layers, caches):
            size = cache["k"].shape[2]
            key = (layer.kind, size)
            if key not in slot_pos:
                slot_pos[key] = (ring_slot_positions(pos, size) if layer.kind == "local"
                                 else full_slot_positions(size, x.device))
            x, _ = layer.decode(x, cache, pos, self.inv_freq, slot_pos[key])
        x = apply_norm(self.final_norm, x, self.cfg.norm_type, self.cfg.norm_eps)
        return self._logits(x), caches
