"""`train.optimizer_share`: see :func:`perfbench.span_readers.optimizer_share`."""

from perfbench.span_readers import optimizer_share as read  # noqa: F401
