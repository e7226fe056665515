"""`long_prompt.batch_p90_s`: see :func:`perfbench.serve_readers.batch_p90_s`."""

from perfbench.serve_readers import batch_p90_s as read  # noqa: F401
