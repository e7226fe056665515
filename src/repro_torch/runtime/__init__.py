"""repro_torch.runtime — the shared batching machinery (admission queues,
latency stats) used by :mod:`repro_torch.search.service`."""

from .batching import AdmissionQueue, LatencyStats

__all__ = ["AdmissionQueue", "LatencyStats"]
