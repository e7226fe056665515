"""`serve.flash_fwd_roofline`: see :func:`perfbench.serve_readers.flash_fwd_roofline`."""

from perfbench.serve_readers import flash_fwd_roofline as read  # noqa: F401
