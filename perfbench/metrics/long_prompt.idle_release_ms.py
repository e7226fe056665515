"""`long_prompt.idle_release_ms`: see :func:`perfbench.span_readers.idle_release_ms`."""

from perfbench.span_readers import idle_release_ms as read  # noqa: F401
