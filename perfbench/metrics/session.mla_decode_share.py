"""Device time of the MLA decode kernel (``mla_decode_kernel``, read by
name, so its launches replayed in a CUDA graph count) over all device time
of the traced turns, in %."""


def read(obs):
    t = obs.trace
    if t is None:
        return None
    total = sum(d for _, _, d in t.device)
    mla = sum(t.kernels("mla_decode_kernel"))
    return 100.0 * mla / total if mla and total else None
