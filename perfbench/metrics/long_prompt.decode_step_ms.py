"""`long_prompt.decode_step_ms`: see :func:`perfbench.serve_readers.decode_step_ms`."""

from perfbench.serve_readers import decode_step_ms as read  # noqa: F401
