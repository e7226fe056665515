"""`serve.mfu`: see :func:`perfbench.serve_readers.mfu`."""

from perfbench.serve_readers import mfu as read  # noqa: F401
