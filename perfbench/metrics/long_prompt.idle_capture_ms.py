"""`long_prompt.idle_capture_ms`: see :func:`perfbench.span_readers.idle_capture_ms`."""

from perfbench.span_readers import idle_capture_ms as read  # noqa: F401
