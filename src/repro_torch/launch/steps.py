"""Step-function factories shared by the launchers.

The port of ``repro/launch/steps.py``:

* :func:`init_params` — a seeded :class:`~repro_torch.models.lm.LM`;
* :func:`make_train_step` — gradient accumulation over microbatches
  (:func:`accumulate_grads`: fp32 accumulators, divided by the depth) and
  the AdamW update of :mod:`repro_torch.optim`; microbatching bounds
  activation memory;
* :func:`pick_microbatches` — the reference's accumulation depth, and
  :func:`micro_depth`, the same unless ``OptFlags.n_micro_override`` is set.

Serving runs ``LM.prefill`` / ``LM.decode_step`` eagerly, so it needs no
step factory.  Enc-dec models raise ``NotImplementedError`` (``ROADMAP.md``
queue 1 item 17).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.profiler import record_function

from repro_torch.models import weights
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import LM
from repro_torch.models.opt_flags import get_flags
from repro_torch.optim import AdamWConfig, adamw_update

__all__ = ["accumulate_grads", "init_params", "make_train_step", "micro_depth",
           "pick_microbatches"]


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device=None, param_dtype: torch.dtype | None = None) -> LM:
    """Seeded weights for ``cfg`` on ``device`` (None: the CUDA card); the
    counterpart of the reference's ``init_params(key, cfg)``.
    ``param_dtype=torch.float32`` builds the fp32 master weights training
    needs.  Families not ported yet (enc-dec among them) raise
    ``NotImplementedError``."""
    return weights.init(cfg, generator, device=device, param_dtype=param_dtype)


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


def _device_batch(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def accumulate_grads(model: LM, batch: dict, n_microbatches: int = 1):
    """(fp32 gradients of ``LM.loss_fn``'s total by parameter name, the
    total loss): ``batch`` split along the batch axis into
    ``n_microbatches`` contiguous microbatches, each one's gradient
    accumulated in fp32, the sum and the loss divided by the depth.  The
    forward and backward of each microbatch run under the profiler ranges
    ``train_step.forward`` and ``train_step.backward``."""
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
    ``extra_embeds`` (numpy arrays or tensors, moved to the model's
    device).  :func:`accumulate_grads` gives the fp32 gradients and the
    loss over ``n_microbatches``, and
    :func:`repro_torch.optim.adamw_update` updates the parameters, which
    are written back into ``model`` in place.  ``opt_state`` is
    :func:`repro_torch.optim.adamw_init` of
    ``dict(model.named_parameters())``.  Metrics: ``loss`` (the total),
    with ``grad_norm`` and ``lr`` from the update.
    """
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: enc-dec training is not ported yet (ROADMAP.md "
            "queue 1 item 17)")

    def train_step(model: LM, opt_state: dict, batch: dict):
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
