"""`long_prompt.decode_attn_roofline`: see :func:`perfbench.serve_readers.decode_attn_roofline`."""

from perfbench.serve_readers import decode_attn_roofline as read  # noqa: F401
