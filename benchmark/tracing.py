"""The traced window: the benchmark's own spans around the program's public
functions, ``torch.profiler`` over the window, and a ``Trace`` that the
per-layer readers in ``metrics/`` read.

Spans are named by the dotted path of the function they wrap
(``sixdgs_torch.pose.evaluate.solve_pose``, ``...trainer.Adafactor.step``):
the wrapper replaces the attribute where the caller looks it up, runs the
original inside ``record_function(<path>)`` and is removed when the window
closes. No span is added inside the program.

A kernel belongs to a span when the host call that launched it (its CUDA
runtime or driver event, matched by correlation id) lies inside the span.
So a span's device time counts the work its host code asked for, whatever
kernels implement it.
"""

from __future__ import annotations

import bisect
import functools
import importlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

LAUNCH_NAMES = ("LaunchKernel", "GraphLaunch", "cuLaunch", "LaunchCooperativeKernel")


def _resolve(path):
    """'pkg.mod.Class.attr' -> (owner object, attribute name)."""
    parts = path.split(".")
    for cut in range(len(parts) - 1, 0, -1):
        try:
            owner = importlib.import_module(".".join(parts[:cut]))
        except ModuleNotFoundError:
            continue
        for name in parts[cut:-1]:
            owner = getattr(owner, name)
        return owner, parts[-1]
    raise ValueError(f"cannot resolve {path}")


class Spans:
    """Install ``record_function`` wrappers around dotted names; undo on exit."""

    def __init__(self, paths):
        self.paths = sorted(set(paths))
        self._saved = []

    def __enter__(self):
        for path in self.paths:
            owner, name = _resolve(path)
            original = owner.__dict__[name] if isinstance(owner, type) else getattr(owner, name)
            fn = original.__func__ if isinstance(original, staticmethod) else original

            def wrapper(*a, _fn=fn, _path=path, **k):
                with torch.profiler.record_function(_path):
                    return _fn(*a, **k)

            functools.update_wrapper(wrapper, fn)
            setattr(owner, name, staticmethod(wrapper) if isinstance(original, staticmethod)
                    else wrapper)
            self._saved.append((owner, name, original))
        return self

    def __exit__(self, *exc):
        for owner, name, original in reversed(self._saved):
            setattr(owner, name, original)
        self._saved.clear()


@dataclass
class Trace:
    """What one traced window saw. Times in seconds on the host's clock.

    ``kernels``: [K, 3] array of (start, end, host launch time) per device
    kernel, sorted by start; ``kernel_names``; ``launches``: kernel launch
    API calls; ``spans``: {path: [(start, end), ...]}; ``work``: the
    window's counts from the traffic (images, steps, evaluations, ...);
    ``untraced``: the untraced window that ran before it (its ``seconds``
    and ``work``), free of the profiler's cost on the host."""

    window_s: float
    kernels: np.ndarray
    kernel_names: list
    launches: int
    spans: dict
    work: dict
    config: dict
    unlinked: int = 0
    untraced: dict = field(default_factory=dict)
    _launch_order: tuple = field(default=None, repr=False)

    @property
    def busy_s(self) -> float:
        """Length of the union of kernel intervals."""
        busy, reach = 0.0, -np.inf
        for s, e, _ in self.kernels:
            if e > reach:
                busy += e - max(s, reach)
                reach = e
        return busy

    def span_calls(self, path) -> int:
        return len(self.spans.get(path, ()))

    def span_wall_s(self, path) -> float:
        return float(sum(e - s for s, e in self.spans.get(path, ())))

    def span_device_s(self, path) -> float:
        """Device time of the kernels launched inside the span's calls."""
        if self._launch_order is None:
            order = np.argsort(self.kernels[:, 2], kind="stable")
            at = self.kernels[order, 2]
            dur = np.concatenate([[0.0], np.cumsum(self.kernels[order, 1] - self.kernels[order, 0])])
            self._launch_order = (at, dur)
        at, dur = self._launch_order
        total = 0.0
        for s, e in self.spans.get(path, ()):
            total += dur[bisect.bisect_right(at, e)] - dur[bisect.bisect_left(at, s)]
        return float(total)

    def top_kernels(self, n=10):
        acc = {}
        for (s, e, _), name in zip(self.kernels, self.kernel_names):
            acc[name] = acc.get(name, 0.0) + (e - s)
        return sorted(acc.items(), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n=10):
        """Idle time between kernels, summed by the innermost span the host
        was in at the middle of each gap ("host" outside every span)."""
        flat = sorted((s, e, p) for p, ivs in self.spans.items() for s, e in ivs)
        starts = [f[0] for f in flat]
        acc, reach = {}, None
        for s, e, _ in self.kernels:
            if reach is not None and s > reach:
                mid, label = 0.5 * (s + reach), "host"
                first = bisect.bisect_right(starts, mid) - 1
                for i in range(first, max(first - 5000, -1), -1):
                    if flat[i][1] >= mid:  # the latest-starting span still open
                        label = flat[i][2]
                        break
                acc[label] = acc.get(label, 0.0) + (s - reach)
            reach = e if reach is None else max(reach, e)
        return sorted(acc.items(), key=lambda kv: -kv[1])[:n]


def _annotation(ev, paths) -> bool:
    """A ``record_function`` range on the device's timeline, not device work
    (older kineto events lack ``is_user_annotation``)."""
    if hasattr(ev, "is_user_annotation"):
        return ev.is_user_annotation()
    name = ev.name()
    return name in paths or name.startswith("Optimizer.")


class Traced:
    """Context: spans installed and the profiler on for the window."""

    def __init__(self, paths, device):
        self.spans = Spans(paths)
        self.device = device
        acts = [torch.profiler.ProfilerActivity.CPU]
        if str(device).startswith("cuda"):
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.window_s = 0.0

    def __enter__(self):
        self.spans.__enter__()
        self.prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if str(self.device).startswith("cuda"):
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(*exc)
        self.spans.__exit__(*exc)

    def trace(self, work, config, untraced=None) -> Trace:
        """Reduce the profiler's events to a ``Trace`` (host clock, seconds)."""
        events = self.prof.profiler.kineto_results.events()
        base = min((ev.start_ns() for ev in events), default=0)
        launch_at, kernels, names, spans, launches = {}, [], [], {}, 0
        paths = set(self.spans.paths)
        cuda = torch.autograd.DeviceType.CUDA
        for ev in events:
            if ev.device_type() == cuda:  # kernels, copies and sets on the device
                if _annotation(ev, paths):
                    continue  # a span's range projected onto the device's timeline
                s = (ev.start_ns() - base) * 1e-9
                kernels.append((s, s + ev.duration_ns() * 1e-9, ev.correlation_id(),
                                ev.linked_correlation_id()))
                names.append(ev.name())
                continue
            name = ev.name()
            if name in paths:
                s = (ev.start_ns() - base) * 1e-9
                spans.setdefault(name, []).append((s, s + ev.duration_ns() * 1e-9))
            elif name.startswith("cu"):  # the runtime or driver call behind a device op
                launch_at[ev.correlation_id()] = (ev.start_ns() - base) * 1e-9
                launches += any(k in name for k in LAUNCH_NAMES)
        rows, unlinked = [], 0
        for s, e, corr, linked in kernels:
            at = launch_at.get(corr, launch_at.get(linked))
            if at is None:
                unlinked += 1
                at = s
            rows.append((s, e, at))
        arr = np.asarray(rows, dtype=np.float64).reshape(-1, 3)
        order = np.argsort(arr[:, 0], kind="stable")
        return Trace(window_s=self.window_s, kernels=arr[order],
                     kernel_names=[names[i] for i in order], launches=launches,
                     spans=spans, work=dict(work), config=config, unlinked=unlinked,
                     untraced=untraced or {})
