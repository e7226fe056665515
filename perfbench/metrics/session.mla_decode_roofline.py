"""The MLA decode kernel's share of its roofline over the traced turns: the
bound of every latent row the turns' steps read (``latent_slots_read`` of
each traced turn's record, the program's ``mla.latent_slots_read``) and of
their q and outputs (:func:`perfbench.mla_arith.decode_bound`) over the
kernel's summed device time, in %."""

from perfbench.mla_arith import decode_bound


def read(obs):
    t = obs.trace
    if t is None:
        return None
    times = t.kernels("mla_decode_kernel")
    traced = obs.records[:t.items]
    if not times or not traced or any("latent_slots_read" not in r for r in traced):
        return None
    c, tr = obs.config, obs.workload["traffic"]
    n_mla = c["num_hidden_layers"]
    rows = sum(r["steps"] for r in traced) * tr["rows"] * n_mla
    slots = sum(r["latent_slots_read"] for r in traced)
    return 100.0 * decode_bound(c, rows, slots)["seconds"] / sum(times)
