"""Step-function factories shared by the launchers.

The port of ``repro/launch/steps.py``:

* :func:`init_params` — a seeded :class:`~repro_torch.models.lm.LM`, or
  :class:`~repro_torch.models.encdec.EncDec` for an enc-dec config;
* :func:`make_train_step` — gradient accumulation over microbatches
  (:func:`accumulate_grads`: fp32 accumulators, divided by the depth) and
  the AdamW update of :mod:`repro_torch.optim`; microbatching bounds
  activation memory;
* :func:`pick_microbatches` — the reference's accumulation depth, and
  :func:`micro_depth`, the same unless ``OptFlags.n_micro_override`` is set;
* :func:`make_prefill_step` / :func:`make_decode_step` — the serving steps
  the dry-run traces (:mod:`repro_torch.launch.dryrun`), around the model's
  ``prefill`` and ``decode_step``.

Both models' ``loss_fn`` take a batch dict and return (total, metrics), so
one train step serves both (the reference's ``_loss`` picks
``loss_fn_encdec`` for an enc-dec config; an enc-dec batch carries
``src_embeds``).  The server calls ``prefill`` / ``decode_step`` itself;
the two serving factories give the dry-run the reference's step signature,
``step(model, batch) -> dict``.  On the card they run through the attention
kernels, like every caller of the model.

Under a model group of more than one rank
(:mod:`repro_torch.models.tensor_parallel`) the serving steps run each
rank's shards where ``output_pspecs`` places them: the rank's vocab shard
of the logits, and caches of the rank's kv heads or, where the rules shard
a cache's sequence (``sharding.cache_seq_axes``, installed with the group),
of the rank's span of slots.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn
from torch.profiler import record_function

from repro_torch.models import weights
from repro_torch.models.config import ModelConfig
from repro_torch.models.opt_flags import get_flags
from repro_torch.optim import AdamWConfig, adamw_update

__all__ = ["accumulate_grads", "init_params", "make_decode_step", "make_prefill_step",
           "make_train_step", "micro_depth", "pick_microbatches"]


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device=None, param_dtype: torch.dtype | None = None,
                model: tuple[int, int] = (0, 1)) -> nn.Module:
    """Seeded weights for ``cfg`` on ``device`` (None: the CUDA card); the
    counterpart of the reference's ``init_params(key, cfg)``.
    ``param_dtype=torch.float32`` builds the fp32 master weights training
    needs; ``model=(rank, size)`` one rank's shards over a ``model`` axis.
    An enc-dec config gives an :class:`~repro_torch.models.encdec.EncDec`."""
    return weights.init(cfg, generator, device=device, param_dtype=param_dtype,
                        model=model)


def pick_microbatches(
    global_batch: int, seq_len: int, dp_size: int, *, tokens_per_mb: int = 8192
) -> int:
    """Largest accumulation depth that keeps per-device microbatch tokens
    near ``tokens_per_mb`` while dividing the per-replica batch evenly."""
    per_dp = max(1, global_batch // max(dp_size, 1))
    want = max(1, (per_dp * seq_len) // tokens_per_mb)
    n = 1
    for cand in (1, 2, 4, 8, 16, 32):
        if cand <= want and per_dp % cand == 0 and global_batch % cand == 0:
            n = cand
    return n


def micro_depth(global_batch: int, seq_len: int, dp_size: int) -> int:
    """``OptFlags.n_micro_override`` when set, else :func:`pick_microbatches`
    (how the reference's launchers pick the depth)."""
    return get_flags().n_micro_override or pick_microbatches(
        global_batch, seq_len, dp_size)


#: the profiler range around one microbatch of :func:`accumulate_grads`
MICROBATCH_RANGE = "train_step.microbatch"


def _device_batch(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def accumulate_grads(model: nn.Module, batch: dict, n_microbatches: int = 1):
    """(fp32 gradients of ``model.loss_fn``'s total by parameter name, the
    total loss): ``batch`` split along the batch axis into
    ``n_microbatches`` contiguous microbatches, each one's gradient
    accumulated in fp32, the sum and the loss divided by the depth.  Each
    microbatch runs under the profiler range :data:`MICROBATCH_RANGE`
    (the dry-run weights what it counts there), its forward and backward
    under ``train_step.forward`` and ``train_step.backward``."""
    n = int(n_microbatches)
    params = dict(model.named_parameters())
    names = list(params)
    batch = _device_batch(batch, model.device)
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not split into "
                         f"{n} microbatches")
    mb = rows // n
    acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in params.items()}
    loss = torch.zeros((), dtype=torch.float32, device=model.device)
    for i in range(n):
        with record_function(MICROBATCH_RANGE):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            with record_function("train_step.forward"):
                total, _ = model.loss_fn(micro)
            with record_function("train_step.backward"):
                grads = torch.autograd.grad(total, [params[k] for k in names])
            for k, g in zip(names, grads):
                acc[k] += g.float()
            del grads
            loss = loss + total.detach()
    if n > 1:
        acc = {k: g / n for k, g in acc.items()}
        loss = loss / n
    return acc, loss


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    n_microbatches: int = 1) -> Callable:
    """``train_step(model, opt_state, batch) -> (model, opt_state, metrics)``.

    ``batch`` holds ``inputs``, ``targets`` and optionally ``mask`` and
    ``extra_embeds`` (an enc-dec batch ``src_embeds`` too), numpy arrays
    or tensors, moved to the model's device.  :func:`accumulate_grads`
    gives the fp32 gradients and the loss over ``n_microbatches``, and
    :func:`repro_torch.optim.adamw_update` updates the parameters, which
    are written back into ``model`` in place.  ``opt_state`` is
    :func:`repro_torch.optim.adamw_init` of
    ``dict(model.named_parameters())``.  Metrics: ``loss`` (the total),
    with ``grad_norm`` and ``lr`` from the update.
    """
    def train_step(model: nn.Module, opt_state: dict, batch: dict):
        acc, loss = accumulate_grads(model, batch, n_microbatches)
        params = dict(model.named_parameters())
        with torch.no_grad():
            new, opt_state, opt_metrics = adamw_update(
                acc, opt_state, {k: p.detach() for k, p in params.items()},
                opt_cfg)
            for k, p in params.items():
                p.copy_(new[k])
        return model, opt_state, {"loss": loss, **opt_metrics}

    return train_step


def make_prefill_step(cfg: ModelConfig, max_len: int) -> Callable:
    """``prefill_step(model, batch) -> {"logits", "caches", "pos"}``: the
    reference's ``make_prefill_step``.  ``batch`` holds ``inputs`` (B, S)
    and optionally ``extra_embeds``; an enc-dec config's ``src_embeds``
    (B, S_src, d) and its ``inputs`` prompt.  Caches are sized ``max_len``."""
    if cfg.is_encdec:
        def prefill_step(model: nn.Module, batch: dict) -> dict:
            logits, caches, pos = model.prefill(batch["src_embeds"], batch["inputs"],
                                                max_len)
            return {"logits": logits, "caches": caches, "pos": pos}
    else:
        def prefill_step(model: nn.Module, batch: dict) -> dict:
            logits, caches, pos = model.prefill(batch["inputs"], max_len,
                                                extra_embeds=batch.get("extra_embeds"))
            return {"logits": logits, "caches": caches, "pos": pos}
    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """``decode_step(model, batch) -> {"logits", "caches"}``: the
    reference's ``make_decode_step``.  ``batch`` holds ``token`` (B, 1),
    ``caches`` (written in place) and ``pos``, a 0-dim int32 tensor."""
    def decode_step(model: nn.Module, batch: dict) -> dict:
        logits, caches = model.decode_step(batch["token"], batch["caches"], batch["pos"])
        return {"logits": logits, "caches": caches}
    return decode_step
