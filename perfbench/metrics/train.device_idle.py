"""Share of the traced window in which no device activity ran, in %."""


def read(obs):
    t = obs.trace
    if t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
