"""Batched serving runtime: prefill + decode over per-request KV caches.

The port of ``repro/runtime/serve_loop.py``.  A :class:`Server` serves
requests through the shared admission queue: free slots prefill queued
requests, and each lockstep tick decodes one token for every unfinished
slot; finished slots are retired and admit the next request.
:meth:`Server.throughput_batch` is the fixed-batch path (one prefill and
``new_tokens - 1`` decode steps for a whole prompt batch).

Where the reference jit-compiles prefill and decode, the port runs
``LM.prefill`` eagerly and, in :meth:`Server.throughput_batch`, replays
``LM.decode_step`` as a CUDA graph on the card
(:mod:`repro_torch.runtime.decode_graph`); their attention goes through the
CUDA kernels.  Caches are written in place.  The batched path keeps the
token and the position on the device between steps; ``generate`` runs
eagerly and reads each sampled token on the host, as the reference does.

:meth:`Server.open_batch` opens sessions that keep their caches across
turns (document QA over a warm prefix): each distinct prompt is prefilled
once, alone, and its cache rows are copied into every session that shares
it; each :meth:`BatchSession.turn` rewinds the position to the prompt's end,
feeds a question through the replayed decode step and decodes an answer.
The port only (the reference has no sessions).
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
from repro_torch.obs import MetricsRegistry, span
from repro_torch.obs import current as _obs_current
from repro_torch.runtime.batching import AdmissionQueue, LatencyStats
from repro_torch.runtime.decode_graph import GreedyDecoder

__all__ = ["BatchSession", "Request", "Server"]


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
        if cfg.is_encdec:
            raise ValueError(f"{cfg.name} is an encoder-decoder: the Server "
                             "serves decoder-only models, as the reference's does; "
                             "use EncDec.prefill and GreedyDecoder")
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
                with span("server.prefill", rid=req.rid, prompt_len=len(req.prompt)):
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

    def throughput_batch(self, prompts: np.ndarray, new_tokens: int, *,
                         cuda_graph: bool | None = None) -> dict:
        """Fixed-batch generation (all slots in lockstep): one prefill and
        ``new_tokens - 1`` greedy decode steps for a (B, S) prompt batch.

        The decode steps run through a :class:`GreedyDecoder` over static
        token and position buffers.  ``cuda_graph`` (default: on for a CUDA
        model) captures the step once as a CUDA graph and replays it; False
        runs the same steps eagerly; True on the CPU raises.  ``prefill_s``
        and ``decode_s`` end in a device synchronise; ``decode_s`` leaves
        out the capture, whose host time is ``capture_s``.

        Spans (:func:`repro_torch.obs.span`): ``server.batch`` around the
        call, inside it ``server.prefill`` (the interval ``prefill_s``
        times), ``server.decode`` (the decoder's creation to the last
        synchronise) and ``server.release`` (the decoder, its graph and
        the caches freed once the tokens are on the host).  The registry
        counts ``server.batches`` and ``server.graph_captures``, the
        batches whose decoder captured its graph anew."""
        B, S = prompts.shape
        self._check_fits(S, new_tokens)
        if cuda_graph is None:
            cuda_graph = self.device.type == "cuda"
        with span("server.batch", B=B, S=S, new_tokens=new_tokens):
            self._sync()
            with span("server.prefill"):
                t0 = time.perf_counter()
                logits, caches, pos = self.model.prefill(
                    torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                                    device=self.device), self.max_len)
                tok = torch.argmax(logits[:, -1:], dim=-1)
                self._sync()
                prefill_s = time.perf_counter() - t0
            with span("server.decode"):
                t1 = time.perf_counter()
                decoder = GreedyDecoder(self.model, caches, tok, pos,
                                        cuda_graph=cuda_graph)
                outs = [tok]
                for _ in range(new_tokens - 1):
                    outs.append(decoder.step().clone())
                self._sync()
                decode_s = time.perf_counter() - t1 - decoder.capture_s
            output = torch.cat(outs, dim=1).cpu().numpy()
            capture_s, captured = decoder.capture_s, decoder.captured
            with span("server.release"):
                del decoder, outs, tok, logits, caches, pos
        self.metrics.counter("server.batches").inc()
        if captured:
            self.metrics.counter("server.graph_captures").inc()
        return {
            "prefill_s": prefill_s,
            "decode_s": decode_s,
            "capture_s": capture_s,
            "cuda_graph": cuda_graph,
            "tokens": B * new_tokens,
            "tok_per_s": B * new_tokens / max(decode_s, 1e-9),
            "output": output,
        }

    def open_batch(self, prompts: np.ndarray, turn_tokens: int, *,
                   cuda_graph: bool | None = None) -> "BatchSession":
        """Open one session for each row of ``prompts`` (B, S), each to be
        asked turns of at most ``turn_tokens`` question and answer tokens.

        Each distinct prompt is prefilled once, alone (so a prefill's T is
        one prompt's S), into caches of ``max_len``; its cache rows are then
        copied into every session whose prompt it is.  The sessions share
        one :class:`GreedyDecoder` over the batch's caches (``cuda_graph``:
        as in :meth:`throughput_batch`; its graph is captured on the first
        turn and replayed by every later one).

        Spans: ``server.open`` around the call, inside it one
        ``server.prefill`` a distinct prompt and ``server.share`` around the
        row copies.  The registry counts ``server.prefills`` and
        ``server.prefix_rows_shared``: cache positions the sessions got by
        copy rather than by a prefill of their own, (B - distinct) x S."""
        prompts = np.asarray(prompts)
        B, S = prompts.shape
        self._check_fits(S, turn_tokens)
        if cuda_graph is None:
            cuda_graph = self.device.type == "cuda"
        uniq, inverse = np.unique(prompts, axis=0, return_inverse=True)
        inverse = inverse.reshape(-1)
        with span("server.open", B=B, S=S, distinct=len(uniq)):
            caches = None
            for u, prompt in enumerate(uniq):
                with span("server.prefill"):
                    _, own, _ = self.model.prefill(
                        torch.as_tensor(prompt[None], dtype=torch.long,
                                        device=self.device), self.max_len)
                self.metrics.counter("server.prefills").inc()
                with span("server.share"):
                    rows = torch.as_tensor(np.flatnonzero(inverse == u), device=self.device)
                    if caches is None:
                        caches = [{k: torch.empty((B,) + t.shape[1:], dtype=t.dtype,
                                                  device=t.device)
                                   for k, t in layer.items()} for layer in own]
                    for layer, part in zip(caches, own):
                        for k, t in part.items():
                            layer[k].index_copy_(0, rows, t.expand((len(rows),) + t.shape[1:]))
                del own
            self._sync()
        self.metrics.counter("server.prefix_rows_shared").inc((B - len(uniq)) * S)
        token = torch.zeros((B, 1), dtype=torch.long, device=self.device)
        pos = torch.tensor(S, dtype=torch.int32, device=self.device)
        decoder = GreedyDecoder(self.model, caches, token, pos, cuda_graph=cuda_graph)
        return BatchSession(self, decoder, S)


class BatchSession:
    """The sessions :meth:`Server.open_batch` opened: their caches (held by
    their decoder) and the prompt's length, where every turn starts."""

    def __init__(self, server: Server, decoder: GreedyDecoder, prompt_len: int):
        self.server = server
        self.decoder = decoder
        self.prompt_len = prompt_len
        self.batch = decoder.token.shape[0]

    def turn(self, questions, answer_tokens: int) -> dict:
        """Ask every session its row of ``questions`` (B, q) and decode
        ``answer_tokens`` greedy tokens of answer (B, n).

        The position rewinds to the prompt's end, so each turn reads the
        prompt and its own question only.  Each question token is written
        into the decoder's token buffer before its step, which discards its
        argmax but the last's, the answer's first token; then ``n - 1``
        more steps.  ``decode_s`` covers the q + n - 1 steps (ending in a
        synchronise, the capture left out); ``capture_s`` is this turn's
        capture (0.0 after the first turn).

        Spans: ``server.turn`` ⊃ ``server.rewind``, ``server.question``,
        ``server.decode``.  The registry counts ``server.turns`` and, for a
        latent-attention model, ``mla.latent_slots_read``: B x its MLA
        layers x the sum over the turn's steps of pos + 1, the latent rows
        the steps' attention reads (a replayed graph runs no Python, so the
        host counts them)."""
        srv, dec = self.server, self.decoder
        questions = torch.as_tensor(np.asarray(questions), dtype=torch.long,
                                    device=srv.device)
        B, q = questions.shape
        if B != self.batch or q < 1 or answer_tokens < 1:
            raise ValueError(f"a turn takes ({self.batch}, q >= 1) questions and "
                             f"answer_tokens >= 1, not {tuple(questions.shape)}, "
                             f"{answer_tokens}")
        srv._check_fits(self.prompt_len + q, answer_tokens)
        steps = q + answer_tokens - 1
        captured = dec.capture_s
        with span("server.turn", B=B, q=q, answer_tokens=answer_tokens):
            with span("server.rewind"):
                dec.pos.fill_(self.prompt_len)
            t0 = time.perf_counter()
            with span("server.question"):
                for j in range(q):
                    dec.token.copy_(questions[:, j:j + 1])
                    dec.step()
            with span("server.decode"):
                outs = [dec.token.clone()]
                for _ in range(answer_tokens - 1):
                    outs.append(dec.step().clone())
                srv._sync()
            capture_s = dec.capture_s - captured
            decode_s = time.perf_counter() - t0 - capture_s
            output = torch.cat(outs, dim=1).cpu().numpy()
        srv.metrics.counter("server.turns").inc()
        n_mla = sum(1 for layer in dec.model.layers if layer.mixer == "mla")
        slots = B * n_mla * sum(self.prompt_len + j + 1 for j in range(steps))
        if n_mla:
            srv.metrics.counter("mla.latent_slots_read").inc(slots)
        return {"output": output, "decode_s": decode_s, "capture_s": capture_s,
                "steps": steps, "latent_slots_read": slots}
