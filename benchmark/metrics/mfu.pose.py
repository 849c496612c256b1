"""Model flops of the untraced window's eval_image calls (counts/flops.py)
over its wall time times the dense bf16 peak."""
from benchmark.readers import mfu_pct as read  # noqa: F401
