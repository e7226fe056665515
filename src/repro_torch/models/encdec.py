"""Encoder-decoder LM (the seamless-m4t backbone).

The port of ``repro/models/encdec.py`` as an ``nn.Module``, :class:`EncDec`.
The encoder is ``cfg.n_enc_layers`` blocks of bidirectional attention (with
RoPE) and an MLP; the decoder ``cfg.n_layers`` blocks of causal
self-attention, cross-attention over the encoder's output and an MLP.  The
audio frontend is the reference's stub: the caller passes frame embeddings
(B, S_src, d).

Serving: ``prefill`` encodes the source once, computes each decoder layer's
cross-attention K/V from the encoder output through that layer's own
``cross`` k and v weights, and keeps them as a static cache; the
self-attention caches are the decoder-only models' full caches.  The caches
are a dict: ``"self"`` and ``"cross"``, lists of per-layer ``{"k", "v"}``,
and ``"cross_pos"``, the 0-dim int32 position every cross decode attends at
(the source length: every slot seen), made once at prefill so that a decode
step makes no tensor from a host number and a CUDA graph can replay it.

Over a ``model`` mesh axis every block splits as the decoder-only
model's do (:mod:`~repro_torch.models.attention`, ``layers.apply_mlp``):
the encoder, self and cross attention by heads (the cross keys and values
of the rank's kv heads from the encoder output under ``copy_to_model``),
the MLP by width, the tied embedding and the logits by vocab.  Where the
rules shard the caches' sequence, a rank holds its span of the self caches'
slots and of the cross caches' source positions, and attends over them as
:mod:`~repro_torch.models.attention` says.

Two differences from :class:`~repro_torch.models.lm.LM`, both the
reference's: the decoder embeds its tokens *without* the ``sqrt(d)`` scale
although the embeddings are tied, and ``loss_fn`` has no aux term and no
vocab-sharded branch.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.compat import resolve_device

from . import tensor_parallel as tp
from .attention import (
    attn_block_decode,
    attn_block_prefill,
    full_slot_positions,
    init_kv_cache,
    kv_projection,
    model_split,
)
from .act_sharding import constrain
from .config import ModelConfig
from .layers import apply_mlp, apply_norm, rope_frequencies, softcap
from .lm import _norm, attention_weights, mlp_weights, vocab_embed

__all__ = ["EncDec"]


class EncoderLayer(nn.Module):
    """``ln1``, bidirectional ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _norm(cfg.d_model, cfg.norm_type, device)
        self.attn = attention_weights(cfg, dtype, device)
        self.ln2 = _norm(cfg.d_model, cfg.norm_type, device)
        self.mlp = mlp_weights(cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype, device)

    def forward(self, x, inv_freq):
        cfg = self.cfg
        h = apply_norm(self.ln1, x, cfg.norm_type, cfg.norm_eps)
        h, _ = attn_block_prefill(self.attn, h, inv_freq, kind="encoder",
                                  window=cfg.window_size, logit_cap=None,
                                  heads=(cfg.n_heads, cfg.n_kv_heads))
        x = constrain(x + h, "residual")
        h = apply_norm(self.ln2, x, cfg.norm_type, cfg.norm_eps)
        return constrain(x + apply_mlp(self.mlp, h, cfg.mlp_type), "residual")


class CrossDecoderLayer(nn.Module):
    """``ln1``, causal ``self`` attention, ``ln_x``, ``cross`` attention,
    ``ln2``, ``mlp``: the reference's names."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.ln1 = _norm(d, cfg.norm_type, device)
        self.self = attention_weights(cfg, dtype, device)
        self.ln_x = _norm(d, cfg.norm_type, device)
        self.cross = attention_weights(cfg, dtype, device)
        self.ln2 = _norm(d, cfg.norm_type, device)
        self.mlp = mlp_weights(d, cfg.d_ff, cfg.mlp_type, dtype, device)

    def _norm(self, name, x):
        return apply_norm(getattr(self, name), x, self.cfg.norm_type, self.cfg.norm_eps)

    def cross_kv(self, enc_out):
        """The encoder output's keys and values (B, KV, S_src, hd),
        contiguous: the decode kernel reads them as a cache.  Over the
        ``model`` axis, the rank's kv heads (every kv head where the cache's
        sequence is split over ``model``)."""
        cfg = self.cfg
        split, kv_heads = model_split(self.cross, (cfg.n_heads, cfg.n_kv_heads))
        if split:
            enc_out = tp.copy_to_model(enc_out)
        k, v = kv_projection(self.cross, enc_out,
                             None if tp.seq_on_model() else kv_heads)
        return k.contiguous(), v.contiguous()

    def prefill(self, x, enc_out, inv_freq, cache_len: int | None):
        """Returns (x, self cache, cross cache); the caches are None when
        ``cache_len`` is."""
        cfg = self.cfg
        heads = (cfg.n_heads, cfg.n_kv_heads)
        h, self_cache = attn_block_prefill(
            self.self, self._norm("ln1", x), inv_freq, kind="attn",
            window=cfg.window_size, logit_cap=None, cache_size=cache_len,
            heads=heads)
        x = constrain(x + h, "residual")
        k, v = self.cross_kv(enc_out)
        h, _ = attn_block_prefill(self.cross, self._norm("ln_x", x), inv_freq,
                                  kind="cross", window=cfg.window_size,
                                  logit_cap=None, kv_override=(k, v), heads=heads)
        x = constrain(x + h, "residual")
        x = constrain(x + apply_mlp(self.mlp, self._norm("ln2", x), cfg.mlp_type),
                      "residual")
        cross_cache = None
        if cache_len is not None:
            # the rank's span of the source positions under a sequence split
            first, n = tp.seq_span(k.shape[2])
            cross_cache = {"k": k[:, :, first:first + n].contiguous(),
                           "v": v[:, :, first:first + n].contiguous()}
        return x, self_cache, cross_cache

    def train_forward(self, x, enc_out, inv_freq):
        return self.prefill(x, enc_out, inv_freq, None)[0]

    def decode(self, x, self_cache, cross_cache, pos, cross_pos, inv_freq,
               slot_pos, cross_slot_pos):
        cfg = self.cfg
        heads = (cfg.n_heads, cfg.n_kv_heads)
        h, _ = attn_block_decode(self.self, self._norm("ln1", x),
                                 self_cache, pos, inv_freq, kind="attn",
                                 window=cfg.window_size, logit_cap=None,
                                 slot_pos=slot_pos, heads=heads)
        x = x + h
        h, _ = attn_block_decode(self.cross, self._norm("ln_x", x), cross_cache,
                                 cross_pos, inv_freq, kind="cross",
                                 window=cfg.window_size, logit_cap=None,
                                 slot_pos=cross_slot_pos, heads=heads)
        x = x + h
        return x + apply_mlp(self.mlp, self._norm("ln2", x), cfg.mlp_type)


class EncDec(nn.Module):
    """Encoder-decoder LM with uninitialised weights; fill them with
    :func:`repro_torch.models.weights.init` or ``from_jax_params``.
    Parameters: ``embed`` (tied), ``enc.i``, ``enc_norm``, ``dec.i``,
    ``final_norm``; dtypes as :class:`~repro_torch.models.lm.LM`'s.
    ``device=None`` means the CUDA card."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        if not cfg.is_encdec:
            raise ValueError(f"{cfg.name} has no encoder: build it with "
                             "repro_torch.models.lm.LM")
        if not cfg.tie_embeddings:
            raise ValueError(f"{cfg.name}: the enc-dec model ties its embeddings")
        dev = resolve_device(device)
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.dtype)
        dtype = param_dtype or self.compute_dtype
        self.embed = nn.Parameter(
            torch.empty((cfg.vocab_size, cfg.d_model), dtype=dtype, device=dev))
        self.enc = nn.ModuleList(EncoderLayer(cfg, dtype=dtype, device=dev)
                                 for _ in range(cfg.n_enc_layers))
        self.enc_norm = _norm(cfg.d_model, cfg.norm_type, dev)
        self.dec = nn.ModuleList(CrossDecoderLayer(cfg, dtype=dtype, device=dev)
                                 for _ in range(cfg.n_layers))
        self.final_norm = _norm(cfg.d_model, cfg.norm_type, dev)
        self.model_shard = (0, 1)
        self.init_buffers(dev)

    def init_buffers(self, device) -> None:
        """The RoPE frequencies on ``device``."""
        cfg = self.cfg
        self.register_buffer("inv_freq", rope_frequencies(
            cfg.head_dim, cfg.rope_fraction, cfg.rope_theta, device=device),
            persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _norm(self, name, x):
        return apply_norm(getattr(self, name), x, self.cfg.norm_type, self.cfg.norm_eps)

    def _logits(self, x):
        """(..., V) logits, or the rank's vocab shard of them."""
        if self.embed.shape[0] < self.cfg.vocab_size:
            x = tp.copy_to_model(x)
        logits = x @ self.embed.T.to(x.dtype)
        return softcap(logits, self.cfg.final_logit_softcap)

    def _check_shard(self) -> None:
        have = (tp.model_rank(), tp.model_size())
        if self.model_shard[1] != have[1] or (have[1] > 1 and self.model_shard != have):
            raise RuntimeError(
                f"{self.cfg.name}: a module built as model rank/size "
                f"{self.model_shard} runs under model group {have}")

    def encode(self, src_embeds: torch.Tensor, *, remat: bool = False) -> torch.Tensor:
        """src_embeds (B, S_src, d) from the (stubbed) frontend -> the
        normed encoder output (B, S_src, d) in the compute dtype."""
        x = src_embeds.to(self.compute_dtype)
        for layer in self.enc:
            if remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, self.inv_freq, use_reentrant=False)
            else:
                x = layer(x, self.inv_freq)
        return self._norm("enc_norm", x)

    def forward(self, src_embeds: torch.Tensor, tokens: torch.Tensor,
                cache_len: int | None = None, logits_slice: int | None = None, *,
                remat: bool = False):
        """Teacher-forced forward; returns (logits, caches or None)."""
        self._check_shard()
        enc_out = self.encode(src_embeds, remat=remat)
        x = vocab_embed(self.embed, tokens, self.cfg.vocab_size, self.compute_dtype)
        self_caches, cross_caches = [], []
        for layer in self.dec:
            if remat and cache_len is None and torch.is_grad_enabled():
                x = checkpoint(layer.train_forward, x, enc_out, self.inv_freq,
                               use_reentrant=False)
                continue
            x, self_c, cross_c = layer.prefill(x, enc_out, self.inv_freq, cache_len)
            self_caches.append(self_c)
            cross_caches.append(cross_c)
        x = self._norm("final_norm", x)
        if logits_slice is not None:
            x = x[:, -logits_slice:]
        caches = None
        if cache_len is not None:
            caches = {"self": self_caches, "cross": cross_caches,
                      "cross_pos": torch.tensor(src_embeds.shape[1], dtype=torch.int32,
                                                device=x.device)}
        return self._logits(x), caches

    @torch.no_grad()
    def prefill(self, src_embeds: torch.Tensor, tokens: torch.Tensor, max_len: int):
        """(last-token logits (B, 1, V), caches with self caches of
        ``max_len``, the next position as a 0-dim int32)."""
        logits, caches = self.forward(src_embeds, tokens, cache_len=max_len,
                                      logits_slice=1)
        pos = torch.tensor(tokens.shape[1], dtype=torch.int32, device=tokens.device)
        return logits, caches, pos

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches: dict, pos: torch.Tensor):
        """One decode step for ``token`` (B, 1) at ``pos`` (0-dim int32 on the
        device); writes the self caches in place and returns (logits (B, 1,
        V), caches)."""
        self._check_shard()
        x = vocab_embed(self.embed, token, self.cfg.vocab_size, self.compute_dtype)
        slot_pos, cross_slot_pos = (
            self._span_positions(caches[key][0]["k"].shape[2], x.device)
            for key in ("self", "cross"))
        for layer, self_c, cross_c in zip(self.dec, caches["self"], caches["cross"]):
            x = layer.decode(x, self_c, cross_c, pos, caches["cross_pos"],
                             self.inv_freq, slot_pos, cross_slot_pos)
        x = self._norm("final_norm", x)
        return self._logits(x), caches

    @staticmethod
    def _span_positions(local: int, device) -> torch.Tensor:
        """The positions of a full cache's slots held by this rank, whose
        cache has ``local`` of them (its span under a sequence split)."""
        first, n = tp.seq_span(local * tp.seq_size())
        return full_slot_positions(local * tp.seq_size(), device)[first:first + n]

    def cache_spec(self, batch: int, max_len: int, src_len: int) -> dict:
        """Zeroed caches in the compute dtype: self caches of ``max_len``,
        cross caches of ``src_len`` (the reference's
        ``cache_spec_encdec``), with their ``cross_pos``."""
        cfg, dev = self.cfg, self.device
        kv = self.dec[0].self["k"].shape[1]       # the rank's kv heads

        def one(size):
            return init_kv_cache(batch, kv, tp.seq_span(size)[1], cfg.head_dim,
                                 self.compute_dtype, dev)

        return {"self": [one(max_len) for _ in self.dec],
                "cross": [one(src_len) for _ in self.dec],
                "cross_pos": torch.tensor(src_len, dtype=torch.int32, device=dev)}

    def loss_fn(self, batch: dict, *, remat: bool = True):
        """Next-token cross-entropy, the reference's ``loss_fn_encdec``.
        ``batch``: ``src_embeds`` (B, S_src, d), ``inputs`` and ``targets``
        (B, T) int, optional ``mask``.  Returns (loss, metrics ``loss``,
        ``tokens``), in fp32."""
        logits, _ = self.forward(batch["src_embeds"], batch["inputs"], remat=remat)
        if logits.shape[-1] < self.cfg.vocab_size:
            logits = tp.gather_from_model(logits)       # exact: before the cast
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, batch["targets"].long()[..., None])[..., 0]
        nll = logz - gold
        mask = batch.get("mask")
        mask = torch.ones_like(nll) if mask is None else mask.to(nll.dtype)
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return loss, {"loss": loss, "tokens": mask.sum()}
