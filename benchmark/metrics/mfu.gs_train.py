"""Counted flops of the untraced window's steps (counts/gs.py: a step's as
the traced steps' cameras average) over its wall time times the dense bf16
peak."""
from benchmark.readers_gs import SPANS, mfu_pct as read  # noqa: F401
