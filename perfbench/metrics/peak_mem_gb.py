"""``torch.cuda.max_memory_allocated()`` over the window, reset at its
start, in GB (1e9 bytes)."""


def read(obs):
    return obs.peak_bytes / 1e9 if obs.peak_bytes else None
