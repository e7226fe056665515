"""`long_prompt.capture_ms`: see :func:`perfbench.serve_readers.capture_ms`."""

from perfbench.serve_readers import capture_ms as read  # noqa: F401
