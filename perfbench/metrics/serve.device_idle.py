"""`serve.device_idle`: see :func:`perfbench.serve_readers.device_idle`."""

from perfbench.serve_readers import device_idle as read  # noqa: F401
