"""The bf16 flash kernel's share of its roofline at the training step's
geometry (a microbatch's rows, all heads, causal over ``seq``): the
benchmark's bound times the launches in the trace over their device time,
in %."""

from perfbench.arith import flash_bound


def read(obs):
    if obs.trace is None:
        return None
    times = obs.trace.kernels("flash_attention_wgmma")
    if not times:
        return None
    c, t = obs.config, obs.workload["traffic"]
    bound = flash_bound(t["rows"] // t["microbatches"], c["n_heads"], c["n_kv_heads"],
                        t["seq"], t["seq"], c["head_dim"], causal=True)["seconds"]
    return 100.0 * bound * len(times) / sum(times)
