"""Tracing and timing helpers: port of sixdgs_tpu/utils/profiling.py.

The reference times iterations with CUDA events and wall clock. Here a
``torch.profiler`` trace stands where the JAX package starts an XLA trace,
and the timers synchronise every CUDA device that holds a tensor they are
given, where JAX blocks until its arrays are ready.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional

import torch


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
    records CPU activity, and CUDA activity where a GPU is present, and
    writes a TensorBoard-readable trace under ``log_dir`` on exit."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    with prof:
        yield


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
