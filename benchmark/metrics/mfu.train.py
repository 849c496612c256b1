"""Model flops of the untraced window's steps and validation evaluations
(counts/flops.py) over its wall time times the dense bf16 peak."""
from benchmark.readers import mfu_pct as read  # noqa: F401
