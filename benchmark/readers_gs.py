"""Reader arithmetic of the 3DGS training cell. A call of ``run`` starts
with untimed steps (``traffic/gs_train.py``), and in a traced window they
come first: only what the timed steps launched counts, those after the
first ``work["prologue"]`` calls of ``train_step``. A reader returns None
when the trace holds nothing it can read."""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.counts.flops import BF16_FLOPS

STEP = "sixdgs_torch.train.gs_trainer.train_step"
SPANS = (STEP,)


def timed_from(trace):
    """Host time at which the timed steps begin, or None."""
    calls = sorted(trace.spans.get(STEP, ()))
    k = trace.work.get("prologue", 0)
    if not len(trace.kernels) or not trace.work.get("steps") or len(calls) < k:
        return None
    return calls[k - 1][1] if k else float(trace.kernels[:, 2].min())


def _timed_spans(trace, path, t0):
    spans = [iv for iv in trace.spans.get(path, ()) if iv[0] >= t0]
    return dataclasses.replace(trace, spans={path: spans}), len(spans)


def device_idle_pct(trace):
    """Share of the timed part of the window in which no kernel ran."""
    t0 = timed_from(trace)
    if t0 is None:
        return None
    busy, reach = 0.0, t0
    for s, e, _ in trace.kernels:
        if e > reach:
            busy += e - max(s, reach)
            reach = e
    return 100.0 * (1.0 - busy / (reach - t0)) if reach > t0 else None


def launches_per_step(trace):
    """Device operations (kernels, copies, sets) launched per timed step."""
    t0 = timed_from(trace)
    return None if t0 is None else float(np.sum(trace.kernels[:, 2] >= t0)) / trace.work["steps"]


def device_ms_per_step(trace, path):
    t0 = timed_from(trace)
    if t0 is None:
        return None
    sub, calls = _timed_spans(trace, path, t0)
    return 1e3 * sub.span_device_s(path) / trace.work["steps"] if calls else None


def roofline_pct(trace, path, bound):
    """``bound`` (per call, from the traced steps' cameras) over the device
    time of the kernels launched inside ``path``, per timed call."""
    t0 = timed_from(trace)
    work = trace.work.get("camera_work")
    if t0 is None or work is None:
        return None
    sub, calls = _timed_spans(trace, path, t0)
    if not calls or not work.fill():
        return None
    per_call = sub.span_device_s(path) / calls
    return 100.0 * work[bound] / per_call if per_call > 0 else None


def mfu_pct(trace):
    """Counted flops of the untraced window's steps (a step's as the traced
    steps' cameras average) over its wall time at the dense bf16 peak."""
    plain = trace.untraced
    work = trace.work.get("camera_work")
    if not len(trace.kernels) or not plain.get("seconds") or work is None or not work.fill():
        return None
    return 100.0 * work["step_flops"] * plain["work"]["steps"] / (plain["seconds"] * BF16_FLOPS)
