"""repro_torch.runtime — the shared batching machinery (admission queues,
latency stats) used by :mod:`repro_torch.search.service`, the LM serving
loop (:class:`repro_torch.runtime.serve_loop.Server`) and the train loop.

``batching`` is imported eagerly: it is dependency-free.  The trainer and
straggler symbols are resolved lazily (PEP 562), as in the reference, so
that importing the batching layer does not drag the model stack along.
"""

from .batching import AdmissionQueue, LatencyStats

__all__ = [
    "AdmissionQueue",
    "LatencyStats",
    "Trainer",
    "TrainerConfig",
    "StragglerDetector",
    "should_speculate",
]

_LAZY = {
    "Trainer": "train_loop",
    "TrainerConfig": "train_loop",
    "StragglerDetector": "stragglers",
    "should_speculate": "stragglers",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
