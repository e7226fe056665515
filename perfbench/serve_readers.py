"""What the serving metrics read, shared by the readers of the two families
that split them by the end-to-end metric they move: ``serve.*`` (cells
reporting ``serve_tokens_per_s``) and ``long_prompt.*`` (cells reporting
``long_prompt_tokens_per_s``).  Each ``metrics/<metric>.py`` binds one of
these as its ``read``."""

from __future__ import annotations

from perfbench.arith import BF16_OPS_PER_S, decode_bound, flash_bound, serve_batch_flop
from perfbench.stats import percentile_interp


def tokens_per_s(obs):
    """Prompt plus generated tokens of every batch completed in the window
    over the time from the window's start to the last batch's end (host
    clock)."""
    return sum(r["tokens"] for r in obs.records) / obs.records[-1]["t_end"]


def prefill_ms(obs):
    """Mean of ``throughput_batch``'s own ``prefill_s`` (its clock ends in a
    device synchronise) over the batches of the run, in ms."""
    return 1e3 * sum(r["prefill_s"] for r in obs.records) / len(obs.records)


def decode_step_ms(obs):
    """``throughput_batch``'s ``decode_s`` summed over the run's batches over
    their decode steps (``new_tokens - 1`` each), in ms."""
    return 1e3 * sum(r["decode_s"] for r in obs.records) / sum(r["steps"] for r in obs.records)


def capture_ms(obs):
    """Mean of ``throughput_batch``'s ``capture_s`` (the decode step's CUDA
    graph capture, once a batch) over the run's batches, in ms."""
    return 1e3 * sum(r["capture_s"] for r in obs.records) / len(obs.records)


def batch_p90_s(obs):
    """The 90th percentile of the time from the call of
    ``Server.throughput_batch`` to its tokens on the host, over every batch
    of the window after the profiled ones."""
    rest = obs.records[obs.trace.items:] if obs.trace is not None else obs.records
    if not rest:
        return None
    return percentile_interp(sorted(r["t_end"] - r["t_start"] for r in rest), 90.0)


def decode_attn_roofline(obs):
    """The decode kernel's share of its roofline over the traced batches: for
    every call, the bytes of its live slots (step j of a batch runs at
    position ``prompt + j - 1`` and reads ``prompt + j`` slots) at HBM
    bandwidth, summed, over the kernel's summed device time, in %."""
    if obs.trace is None:
        return None
    times = obs.trace.kernels("decode_attention_kernel")
    if not times:
        return None
    c, t = obs.config, obs.workload["traffic"]
    bound = sum(decode_bound(t["rows"], c["n_heads"], c["n_kv_heads"], c["head_dim"],
                             t["prompt"] + j)["seconds"]
                for j in range(1, t["new_tokens"]))
    bound *= c["n_layers"] * obs.trace.items
    return 100.0 * bound / sum(times)


def flash_fwd_roofline(obs):
    """The bf16 flash kernel's share of its roofline at the prefill's
    geometry (the batch's rows, all heads, causal over the prompt): the
    benchmark's bound times the launches in the trace over their device
    time, in %."""
    if obs.trace is None:
        return None
    times = obs.trace.kernels("flash_attention_wgmma")
    if not times:
        return None
    c, t = obs.config, obs.workload["traffic"]
    bound = flash_bound(t["rows"], c["n_heads"], c["n_kv_heads"], t["prompt"],
                        t["prompt"], c["head_dim"], causal=True)["seconds"]
    return 100.0 * bound * len(times) / sum(times)


def mfu(obs):
    """Model FLOPs of the traced batches' prompt and generated tokens over
    the traced window's time at the bf16 peak, in %."""
    t = obs.trace
    if t is None:
        return None
    tr = obs.workload["traffic"]
    flop = serve_batch_flop(obs.config, tr["rows"], tr["prompt"], tr["new_tokens"]) * t.items
    return 100.0 * flop / (t.window_s * BF16_OPS_PER_S)


def device_idle(obs):
    """Share of the traced window in which no device activity ran, in %."""
    t = obs.trace
    if t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
