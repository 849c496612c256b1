"""Tracing and timing: the program's spans and counters, a profiler trace,
and timers (port of sixdgs_tpu/utils/profiling.py, which has the last two).

Spans name the program's stages where the work happens, and counters count
events the stages cause (kernel launches, kernel builds, device-to-host
reads)::

    with profiling.span("pose.loss"):
        ...

    @profiling.span("pose.solve")
    def solve_pose(...): ...

    profiling.count("host.reads", 4)

Spans are off until ``enable()``. Off, a span is one flag test on a shared
no-op context (one object per name): it opens no profiler range and records
nothing. On, a span reads ``time.perf_counter_ns()`` at entry and exit and
keeps a per-thread stack, so that each span knows its parent and its self
time (its duration less the time its child spans cover). While a
``torch.profiler`` is recording, an enabled span also opens
``record_function("sixdgs:" + name)``, which puts the stage on the
profiler's timeline beside the device work its host code launched. A span
measures host time and never synchronises the device; an exception closes
it. Counters count whether spans are on or off.

``snapshot(reset=False)`` returns ``{"spans": {name: {"calls", "total_ms",
"self_ms", "max_ms", "parents"}}, "counters": {name: n}}`` (``parents``:
the calls under each enclosing span); ``reset=True`` clears both after
reading them.

``trace`` stands where the JAX package starts an XLA trace (spans are on
inside it, so the trace carries the stages), and the timers synchronise
every CUDA device that holds a tensor they are given, where JAX blocks
until its arrays are ready.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
from typing import Dict, Optional

import torch

PREFIX = "sixdgs:"

_on = False
_generation = 0  # bumped by enable(): spans left open by disable() are dropped
_local = threading.local()
_spans: Dict[str, list] = {}  # name -> [calls, total_ns, self_ns, max_ns, {parent: calls}]
_counters: Dict[str, int] = {}
_named: Dict[str, "Span"] = {}


def enable() -> None:
    """Turn spans on (for every thread)."""
    global _on, _generation
    if not _on:
        _generation += 1
        _on = True


def disable() -> None:
    """Turn spans off; spans open now record nothing (they are dropped when
    spans next come on)."""
    global _on
    _on = False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    _counters[name] = _counters.get(name, 0) + n


def snapshot(reset: bool = False) -> dict:
    """The spans and counters recorded so far (see the module docstring)."""
    spans = {name: {"calls": calls, "total_ms": total * 1e-6, "self_ms": own * 1e-6,
                    "max_ms": longest * 1e-6, "parents": dict(parents)}
             for name, (calls, total, own, longest, parents) in _spans.items()}
    out = {"spans": spans, "counters": dict(_counters)}
    if reset:
        _spans.clear()
        _counters.clear()
    return out


def _stack() -> list:
    """This thread's open spans: [span, start ns, children's ns, profiler
    range or None] each, innermost last."""
    if getattr(_local, "generation", None) != _generation:
        for frame in reversed(getattr(_local, "stack", ())):  # left open by disable()
            if frame[3] is not None:
                frame[3].__exit__(None, None, None)
        _local.stack, _local.generation = [], _generation
    return _local.stack


def _open(span: "Span") -> None:
    rf = None
    if torch.autograd._profiler_enabled():
        rf = torch.profiler.record_function(span.label)
        rf.__enter__()
    _stack().append([span, time.perf_counter_ns(), 0, rf])


def _close(span: "Span") -> None:
    t1 = time.perf_counter_ns()
    stack = _stack()
    if not stack or stack[-1][0] is not span:
        return  # opened while spans were off
    _, t0, children, rf = stack.pop()
    if rf is not None:
        rf.__exit__(None, None, None)
    dur = t1 - t0
    rec = _spans.get(span.name)
    if rec is None:
        rec = _spans[span.name] = [0, 0, 0, 0, {}]
    rec[0] += 1
    rec[1] += dur
    rec[2] += dur - children
    rec[3] = max(rec[3], dur)
    if stack:
        stack[-1][2] += dur
        parent = stack[-1][0].name
        rec[4][parent] = rec[4].get(parent, 0) + 1


class Span:
    """One named stage: a context manager and a decorator. Get it with
    ``span(name)``; it holds no per-call state, so one object serves every
    call, nested and on every thread."""

    __slots__ = ("name", "label")

    def __init__(self, name: str):
        self.name, self.label = name, PREFIX + name

    def __enter__(self):
        if _on:
            _open(self)
        return self

    def __exit__(self, *exc):
        if _on:
            _close(self)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            _open(self)
            try:
                return fn(*args, **kwargs)
            finally:
                if _on:
                    _close(self)

        return wrapper


def span(name: str) -> Span:
    """The span of stage ``name``: ``with span(name):`` or ``@span(name)``."""
    s = _named.get(name)
    if s is None:
        s = _named[name] = Span(name)
    return s


def _sync(tree) -> None:
    """Wait for the CUDA devices of the tensors in ``tree`` (nested lists,
    tuples, dicts and dataclasses, as JAX walks a pytree)."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            walk(vars(x))
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    for dev in devices:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace: ``with trace("/tmp/trace"): step()``. It
    records CPU activity, and CUDA activity where a GPU is present, with
    spans on (so the program's stages appear as ``sixdgs:`` ranges), and
    writes a TensorBoard-readable trace under ``log_dir`` on exit."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    was_on = _on
    enable()
    try:
        with prof:
            yield
    finally:
        if not was_on:
            disable()


class StepTimer:
    """EMA wall-clock step timer (device-synchronizing)."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.value_ms: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, *sync_tensors) -> float:
        if sync_tensors:
            _sync(sync_tensors)
        dt = (time.perf_counter() - self._t0) * 1000.0
        self.value_ms = dt if self.value_ms is None else (
            self.ema * self.value_ms + (1 - self.ema) * dt
        )
        return dt


def time_fn(fn, *args, iters: int = 10, warmup: int = 1, **kwargs) -> Dict[str, float]:
    """First-call and steady-state timing of a callable: ``compile_s`` is
    the first call (kernel builds and caches included), ``steady_ms`` the
    mean of ``iters`` calls after ``warmup`` calls in all."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _sync(out)
    compile_s = time.perf_counter() - t0
    for _ in range(max(warmup - 1, 0)):
        out = fn(*args, **kwargs)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    _sync(out)
    return {
        "compile_s": compile_s,
        "steady_ms": (time.perf_counter() - t0) / iters * 1000.0,
    }
