"""Device time under the ``flash_attention.backward`` profiler range (the
plain chunked backward under the flash ``autograd.Function``) over the
traced steps' device time, in %."""


def read(obs):
    t = obs.trace
    if t is None:
        return None
    total = sum(d for _, _, d in t.device)
    seconds, n = t.range_s("flash_attention.backward")
    return 100.0 * seconds / total if n and total else None
