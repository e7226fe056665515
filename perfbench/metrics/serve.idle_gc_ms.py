"""`serve.idle_gc_ms`: see :func:`perfbench.span_readers.idle_gc_ms`."""

from perfbench.span_readers import idle_gc_ms as read  # noqa: F401
