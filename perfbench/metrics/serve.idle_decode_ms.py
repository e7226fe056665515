"""`serve.idle_decode_ms`: see :func:`perfbench.span_readers.idle_decode_ms`."""

from perfbench.span_readers import idle_decode_ms as read  # noqa: F401
