"""`long_prompt.idle_prefill_ms`: see :func:`perfbench.span_readers.idle_prefill_ms`."""

from perfbench.span_readers import idle_prefill_ms as read  # noqa: F401
