"""`long_prompt.moe_dispatch_share`: see :func:`perfbench.span_readers.moe_dispatch_share`."""

from perfbench.span_readers import moe_dispatch_share as read  # noqa: F401
