"""Bridge into PyTorch's own instrumentation: a ``torch.profiler`` capture.

The port of ``repro/obs/profile_hooks.py``.  :func:`profile_capture` wraps
a block in a ``torch.profiler`` capture *and* an obs span on the ambient
tracer, so the device-level profile lines up with the host-side trace.

The reference's second hook, ``install_compile_listener``, forwards
``jax.monitoring``'s backend-compile events to the ambient observability.
It has no counterpart here: the port compiles no graphs (it runs PyTorch
eagerly, and its CUDA kernels are built once by nvcc,
:mod:`repro_torch.kernels._build`), so there is no compile event to forward.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

__all__ = ["profile_capture"]


@contextlib.contextmanager
def profile_capture(logdir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block into ``logdir``.

    CPU activity always, CUDA activity when a card is visible.  The trace
    is written on exit as ``logdir/<worker>.<time>.pt.trace.json``
    (``torch.profiler.tensorboard_trace_handler``), which loads in
    TensorBoard or Perfetto, inside a ``torch.profiler.capture`` span of the
    ambient tracer.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    from repro_torch.obs import current

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    ob = current()
    with ob.tracer.span("torch.profiler.capture", logdir=logdir):
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(logdir)):
            yield
