"""`long_prompt_tokens_per_s`: see :func:`perfbench.serve_readers.tokens_per_s`."""

from perfbench.serve_readers import tokens_per_s as read  # noqa: F401
