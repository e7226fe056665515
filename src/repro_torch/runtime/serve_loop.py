"""Batched serving runtime: prefill + decode over per-request KV caches.

The port of ``repro/runtime/serve_loop.py``.  A :class:`Server` serves
requests through the shared admission queue: free slots prefill queued
requests, and each lockstep tick decodes one token for every unfinished
slot; finished slots are retired and admit the next request.
:meth:`Server.throughput_batch` is the fixed-batch path (one prefill and
``new_tokens - 1`` decode steps for a whole prompt batch).

Where the reference jit-compiles prefill and decode, the port runs
``LM.prefill`` / ``LM.decode_step`` eagerly; their attention goes through the
CUDA kernels on the card.  Caches are written in place.  The batched path
keeps the token and the position on the device between steps; ``generate``
reads each sampled token on the host, as the reference does.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Iterator, Mapping

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import LM
from repro_torch.obs import MetricsRegistry
from repro_torch.obs import current as _obs_current
from repro_torch.runtime.batching import AdmissionQueue, LatencyStats

__all__ = ["Request", "Server"]


class _CounterView(Mapping):
    """Read-only mapping over a registry's ``server.*`` counters (the
    reference's ``Server.stats``)."""

    _KEYS = ("prefills", "decode_ticks", "tokens_out")

    def __init__(self, registry: MetricsRegistry):
        self._registry = registry

    def __getitem__(self, key: str) -> int:
        if key not in self._KEYS:
            raise KeyError(key)
        return int(self._registry.counter(f"server.{key}").value)

    def __iter__(self) -> Iterator[str]:
        return iter(self._KEYS)

    def __len__(self) -> int:
        return len(self._KEYS)


@dataclass
class Request:
    rid: int
    prompt: list
    max_new_tokens: int = 16
    generated: list = field(default_factory=list)
    done: bool = False
    latency_s: float = 0.0      # END-TO-END: admission -> last token emitted


class Server:
    """Serve ``model`` (an :class:`LM` on ``device``; None: the CUDA card)
    with caches of ``max_len`` positions.  ``temperature`` 0 is greedy
    (argmax, first index on ties); above 0 it samples from a seeded
    ``torch.Generator``."""

    def __init__(self, cfg: ModelConfig, model: LM, *, max_len: int = 256,
                 temperature: float = 0.0, device=None):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"the model is on {model.device}, the server on "
                             f"{self.device}")
        self.cfg = cfg
        self.model = model
        self.max_len = max_len
        self.temperature = temperature
        self._generator = torch.Generator(device=model.device).manual_seed(0)
        #: the server's own always-on registry (prefills/ticks/tokens live
        #: here; merge into an ambient one with ``ob.registry.merge``)
        self.metrics = MetricsRegistry()
        #: read-only view of the ``server.*`` counters
        self.stats = _CounterView(self.metrics)
        self.latency = LatencyStats()

    def _check_fits(self, prompt_len: int, new_tokens: int) -> None:
        # the last generated token is not fed back, so the highest cache
        # position written is prompt_len + new_tokens - 2
        if prompt_len < 1 or prompt_len + new_tokens - 1 > self.max_len:
            raise ValueError(
                f"a prompt of {prompt_len} tokens with {new_tokens} new tokens "
                f"does not fit caches of max_len={self.max_len}")

    def _sample(self, logits: torch.Tensor) -> int:
        last = logits[0, -1]
        if self.temperature <= 0:
            return int(torch.argmax(last))
        probs = torch.softmax(last.float() / self.temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=self._generator))

    def generate(self, requests: list[Request],
                 max_slots: int | None = None) -> list[Request]:
        """Serve a list of requests with per-request caches (B=1 slots),
        batching decode ticks across active requests round-robin.

        At most ``max_slots`` requests are in flight at once (all of them
        when ``None``); a finished slot immediately admits the next queued
        request.  ``req.latency_s`` is end to end (admission to last token),
        and ``stats["decode_ticks"]`` counts lockstep ticks, one per decode
        round.
        """
        for req in requests:
            self._check_fits(len(req.prompt), req.max_new_tokens)
        ob = _obs_current()
        queue: AdmissionQueue[Request] = AdmissionQueue(
            depth_gauge=self.metrics.gauge("server.queue_depth"))
        t_admit: dict[int, float] = {}
        for req in requests:
            t_admit[id(req)] = time.perf_counter()
            queue.put(req)
        slots = len(requests) if max_slots is None else max(1, max_slots)

        active: list[tuple[Request, list, torch.Tensor]] = []
        while active or len(queue):
            # admission: fill free slots from the queue (prefill each)
            while len(active) < slots:
                req = queue.pop()
                if req is None:
                    break
                with ob.tracer.span("server.prefill", rid=req.rid,
                                    prompt_len=len(req.prompt)):
                    toks = torch.tensor([req.prompt], dtype=torch.long,
                                        device=self.device)
                    logits, caches, pos = self.model.prefill(toks, self.max_len)
                self.metrics.counter("server.prefills").inc()
                req.generated.append(self._sample(logits))
                active.append((req, caches, pos))

            # one lockstep decode tick over every unfinished slot
            ticked = False
            tokens_this_tick = 0
            for i, (req, caches, pos) in enumerate(active):
                if len(req.generated) >= req.max_new_tokens:
                    continue
                if not ticked:
                    self.metrics.counter("server.decode_ticks").inc()
                    ticked = True
                tok = torch.tensor([[req.generated[-1]]], dtype=torch.long,
                                   device=self.device)
                logits, caches = self.model.decode_step(tok, caches, pos)
                req.generated.append(self._sample(logits))
                self.metrics.counter("server.tokens_out").inc()
                tokens_this_tick += 1
                active[i] = (req, caches, pos + 1)
            if ticked and ob.enabled:
                ob.tracer.counter("server", active_slots=len(active),
                                  queued=len(queue),
                                  tokens_per_tick=tokens_this_tick)

            # retire finished slots (freeing them for queued requests)
            still: list[tuple[Request, list, torch.Tensor]] = []
            for req, caches, pos in active:
                if len(req.generated) >= req.max_new_tokens:
                    req.done = True
                    req.latency_s = time.perf_counter() - t_admit[id(req)]
                    self.latency.record(req.latency_s)
                    self.metrics.histogram("server.latency_s").record(
                        req.latency_s)
                else:
                    still.append((req, caches, pos))
            active = still
        return requests

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def throughput_batch(self, prompts: np.ndarray, new_tokens: int) -> dict:
        """Fixed-batch generation (all slots in lockstep): one prefill and
        ``new_tokens - 1`` greedy decode steps for a (B, S) prompt batch.
        ``prefill_s`` and ``decode_s`` end in a device synchronise."""
        B, S = prompts.shape
        self._check_fits(S, new_tokens)
        self._sync()
        t0 = time.perf_counter()
        logits, caches, pos = self.model.prefill(
            torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                            device=self.device), self.max_len)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        self._sync()
        prefill_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        outs = [tok]
        for _ in range(new_tokens - 1):
            logits, caches = self.model.decode_step(tok, caches, pos)
            tok = torch.argmax(logits[:, -1:], dim=-1)
            outs.append(tok)
            pos = pos + 1
        self._sync()
        decode_s = time.perf_counter() - t1
        return {
            "prefill_s": prefill_s,
            "decode_s": decode_s,
            "tokens": B * new_tokens,
            "tok_per_s": B * new_tokens / max(decode_s, 1e-9),
            "output": torch.cat(outs, dim=1).cpu().numpy(),
        }
