"""`long_prompt.prefill_ms`: see :func:`perfbench.serve_readers.prefill_ms`."""

from perfbench.serve_readers import prefill_ms as read  # noqa: F401
