"""Shared arithmetic of the per-layer readers in ``metrics/``. A reader
returns None when the trace holds nothing it can read (no kernel, no call
of its span), and the harness then leaves its metric out of the line."""

from __future__ import annotations

from benchmark.counts import flops

FWD = "sixdgs_torch.ops.attention_kernel.attention_scores_fwd"
BWD = "sixdgs_torch.ops.attention_kernel.attention_scores_bwd"


def device_idle_pct(trace):
    if not len(trace.kernels) or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def model_flops(work, cfg):
    return (work.get("images", 0) * flops.image_flops(cfg)
            + work.get("evaluations", 0) * flops.image_flops(cfg)
            + work.get("steps", 0) * flops.step_flops(cfg))


def mfu_pct(trace):
    """Model flops of the untraced window's work over its wall time at the
    dense bf16 peak (the traced window runs slower by the profiler's cost)."""
    plain = trace.untraced
    if not len(trace.kernels) or not plain.get("seconds"):
        return None
    return 100.0 * model_flops(plain["work"], trace.config) / (plain["seconds"] * flops.BF16_FLOPS)


def launches_per(trace, unit):
    n = trace.work.get(unit, 0)
    if not trace.launches or not n:
        return None
    return trace.launches / n


def device_ms_per(trace, span, unit):
    n = trace.work.get(unit, 0)
    if not len(trace.kernels) or not n or not trace.span_calls(span):
        return None
    return 1e3 * trace.span_device_s(span) / n


def wall_ms_per_call(trace, span):
    calls = trace.span_calls(span)
    return 1e3 * trace.span_wall_s(span) / calls if calls else None


def roofline_pct(trace, span, count, nbytes):
    """The call's bound over the device time of the kernels its host code
    launched, per call."""
    calls = trace.span_calls(span)
    if not len(trace.kernels) or not calls:
        return None
    per_call = trace.span_device_s(span) / calls
    if per_call <= 0:
        return None
    shape = flops.scorer_shape(trace.config)
    bound = flops.bound_s(count(*shape), nbytes(*shape), trace.config["pose"]["scorer_products"])
    return 100.0 * bound / per_call
