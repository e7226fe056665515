"""repro_torch.runtime — the shared batching machinery (admission queues,
latency stats) used by :mod:`repro_torch.search.service`, and the LM serving
loop, :class:`repro_torch.runtime.serve_loop.Server`."""

from .batching import AdmissionQueue, LatencyStats

__all__ = ["AdmissionQueue", "LatencyStats"]
