"""Greedy decode over static buffers, replayed as a CUDA graph on the card.

The reference jit-compiles its decode step (``repro/runtime/serve_loop.py``);
the port's counterpart is a CUDA graph: one step is captured once and each
later step replays it, so the host makes one graph launch instead of over
3,000 kernel launches a step.  What makes the step capturable is that every
input it reads stays at one address and changes on the device:

* the token (B, 1) and the position (0-dim int32) live in static buffers;
  the step writes its greedy token into the token buffer and adds 1 to the
  position in place;
* ``decode_step`` writes the caches and recurrent states in place and
  reads ``pos`` only on the device (ring slot positions, cache index, the
  decode kernel's span; an enc-dec's cross position is a tensor its
  prefill made);
* the decode kernel's scratch and merge counters are kept per device and
  shape, and the counters are back at 0 after every call.

:class:`GreedyDecoder` runs that step.  With ``cuda_graph=True`` (a CUDA
model only) the first step runs eagerly on a side stream, which also builds
the kernels, sets their attributes and creates the cuBLAS workspace there;
the second step captures the step on that stream and every step from then
on replays the graph.  A failed capture raises.  With ``cuda_graph=False``
the same static-buffer step runs eagerly, on any device.

Launch counts stay true: a wrapper counts in Python, which a replay does not
run, so the decoder takes each wrapper's count during capture back out
(nothing ran) and adds it again on every replay.

Spans (:func:`repro_torch.obs.span`): ``decoder.first_step`` around the
eager step on the side stream, ``decoder.capture`` around the capture (the
interval ``capture_s`` times).  Replays run no Python, so they have none.
"""

from __future__ import annotations

import time

import torch

from repro_torch.kernels import ops
from repro_torch.models.lm import LM
from repro_torch.obs import span

__all__ = ["GreedyDecoder"]

# the wrappers whose launches a replay repeats
_WRAPPERS = (ops.flash_attention, ops.gqa_decode_attention, ops.seg_combine,
             ops.fixture_copy)


def _counts() -> list[tuple[int, dict]]:
    return [(w.launches, dict(getattr(w, "launches_by_variant", {})))
            for w in _WRAPPERS]


def _add(deltas: list[tuple[int, dict]], sign: int) -> None:
    for w, (n, by) in zip(_WRAPPERS, deltas):
        w.launches += sign * n
        for k, v in by.items():
            w.launches_by_variant[k] += sign * v


class GreedyDecoder:
    """Greedy decode steps of ``model`` (an :class:`LM`, or an
    :class:`~repro_torch.models.encdec.EncDec` with its prefill's caches)
    over ``caches`` from ``token`` (B, 1)
    at ``pos`` (0-dim int32): each :meth:`step` feeds the token buffer at
    the position buffer, writes the argmax token back into the token buffer
    and advances the position by one.  The buffers are copies of ``token``
    and ``pos``, and keep their addresses for the decoder's life."""

    def __init__(self, model: LM, caches, token: torch.Tensor,
                 pos: torch.Tensor, *, cuda_graph: bool = False):
        if cuda_graph and model.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a model on a CUDA card, not "
                             f"on {model.device}")
        self.model = model
        self.caches = caches
        self.token = token.clone()          # static input and output
        self.pos = pos.clone()              # static input, advanced in place
        self.logits: torch.Tensor | None = None   # the last step's (B, 1, V)
        self.cuda_graph = cuda_graph
        #: host seconds the capture took (0.0 until it happens)
        self.capture_s = 0.0
        self.steps = 0
        self._graph: torch.cuda.CUDAGraph | None = None
        self._stream: torch.cuda.Stream | None = None
        self._deltas: list[tuple[int, dict]] = []

    def _run(self) -> torch.Tensor:
        logits, _ = self.model.decode_step(self.token, self.caches, self.pos)
        self.token.copy_(torch.argmax(logits[:, -1:], dim=-1))
        self.pos.add_(1)
        return logits

    @property
    def captured(self) -> bool:
        """Whether the decoder has captured its step as a CUDA graph."""
        return self._graph is not None

    def _capture(self) -> None:
        with span("decoder.capture"):
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            before = _counts()
            with torch.cuda.graph(graph, stream=self._stream):
                logits = self._run()
            after = _counts()
            # nothing ran during capture: take its counts back out
            self._deltas = [(a[0] - b[0], {k: a[1][k] - b[1][k] for k in a[1]})
                            for a, b in zip(after, before)]
            _add(self._deltas, -1)
            self._graph, self.logits = graph, logits
            self.capture_s = time.perf_counter() - t0

    def step(self) -> torch.Tensor:
        """Run one decode step; returns the token buffer (B, 1), which the
        next step overwrites (clone it to keep it)."""
        if not self.cuda_graph:
            self.logits = self._run()
        elif self.steps == 0:
            # warm-up, a real step, on the stream the capture will use
            with span("decoder.first_step"):
                self._stream = torch.cuda.Stream(device=self.model.device)
                self._stream.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(self._stream):
                    self.logits = self._run()
                torch.cuda.current_stream().wait_stream(self._stream)
        else:
            if self._graph is None:
                self._capture()
            self._graph.replay()
            _add(self._deltas, +1)
        self.steps += 1
        return self.token
