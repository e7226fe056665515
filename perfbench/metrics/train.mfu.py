"""Model FLOPs of the traced steps (three times the forward, no
recomputation) over the traced window's time at the bf16 peak, in %."""

from perfbench.arith import BF16_OPS_PER_S, train_step_flop


def read(obs):
    t = obs.trace
    if t is None:
        return None
    tr = obs.workload["traffic"]
    flop = train_step_flop(obs.config, tr["rows"], tr["seq"]) * t.items
    return 100.0 * flop / (t.window_s * BF16_OPS_PER_S)
