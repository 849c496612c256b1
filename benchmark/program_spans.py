"""One run of a cell with the program's own spans and counters on, and the
per-layer metrics that read them.

    python benchmark/program_spans.py --workload dinov2_s14.pose --seed 7 --seconds 20 --trace 1

The program (``sixdgs_torch.utils.profiling``) names its stages where the
work happens (``pose.backbone``, ``train.forward``, ...) and counts
device-to-host reads (``host.reads``) and kernel launches and builds. This
is ``run.py`` with its arguments and its result line, and with, in a traced
run (``--trace 1``) of a program that has ``profiling.enable``:

- spans on through set-up, whose snapshot is taken (and the registry reset)
  as set-up ends; the program's counters join the set-up stderr line;
- spans off through the untraced window, so that it and ``mfu.*`` read as in
  ``run.py``;
- then a spans-only window of ``trace_seconds`` with spans on and no
  profiler, whose snapshot is taken at its end; stderr gives its ms per
  image or per step beside the untraced window's (the cost of spans on);
- spans on through the traced window: each ``sixdgs:`` range the profiler
  records on the host joins ``Trace.spans`` under its name, so an idle gap
  goes to the innermost program stage, and its projection onto the device's
  timeline is dropped from the kernels;
- ``trace.program = {"setup": snapshot, "window": snapshot}``, and the
  metrics of ``METRICS`` (readers ``metrics/<name>.py``, as the harness finds
  any per-layer metric) are read beside the cell's own.

An untraced run, and any run of a program without ``profiling.enable``, is
``run.py``'s run as it is, and the readers of ``METRICS`` return None.
``run.py`` and ``tracing.py`` take these steps over, and ``BENCHMARK.json``
the entries of ``METRICS``, in the change that adds the metrics to the
benchmark.
"""

from __future__ import annotations

import bisect
import sys
import time
from dataclasses import replace
from pathlib import Path

START = time.perf_counter()

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark import harness, run, tracing  # noqa: E402

PREFIX = "sixdgs:"

METRICS = [
    {"name": "ray_mlp_ms.pose", "unit": "ms", "better": "lower", "source": "device_trace",
     "layer": "pose.id_module", "moves": "image_p95_ms", "workloads": ["dinov2_s14.pose"]},
    {"name": "backbone_host_ms.pose", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "pose.backbone", "moves": "image_p95_ms",
     "workloads": ["dinov2_s14.pose"]},
    {"name": "loss_ms.pose", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": "pose.loss", "moves": "image_p95_ms", "workloads": ["dinov2_s14.pose"]},
    {"name": "val_prepare_ms.train", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "pose.evaluate", "moves": "step_ms",
     "workloads": ["dinov2_s14.train"]},
    {"name": "forward_host_ms.train", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "pose.trainer", "moves": "step_ms",
     "workloads": ["dinov2_s14.train"]},
    {"name": "host_reads.train", "unit": "reads/step", "better": "lower",
     "source": "program_counter", "layer": "pose.trainer", "moves": "step_ms",
     "workloads": ["dinov2_s14.train"]},
    {"name": "setup_caches_s.train", "unit": "s", "better": "lower",
     "source": "program_span", "layer": "pose.trainer", "moves": "setup_s",
     "workloads": ["dinov2_s14.train"]},
]


# ---------------------------------------------------------------- readers


def snapshot(trace, which):
    """The program's snapshot ``which`` ("setup" or "window") of the run, or
    None (a program without spans, or a run without them)."""
    return (getattr(trace, "program", None) or {}).get(which)


def host_ms_per_call(trace, stage):
    """Host ms per call of program stage ``stage`` in the spans-only window."""
    snap = snapshot(trace, "window")
    s = snap and snap["spans"].get(stage)
    return s["total_ms"] / s["calls"] if s else None


# ---------------------------------------------------------------- the run


def program_tracing():
    """``sixdgs_torch.utils.profiling`` where it has spans, else None."""
    try:
        from sixdgs_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "enable") else None


def _innermost(flat, starts, t):
    """The name of the latest-starting of the sorted (start, end, name)
    intervals ``flat`` still open at ``t``, or None."""
    first = bisect.bisect_right(starts, t) - 1
    return next((flat[i][2] for i in range(first, max(first - 5000, -1), -1)
                 if flat[i][1] >= t), None)


class ProgramTrace(tracing.Trace):
    """A ``Trace`` whose idle gaps go to the program's stages first."""

    def idle_gaps(self, n=10):
        """Idle time between kernels, summed by the innermost program stage
        the host was in at the middle of each gap; where no stage was open,
        by the innermost benchmark wrapper; else "host"."""
        found = []
        for program in (True, False):
            flat = sorted((s, e, p) for p, ivs in self.spans.items() for s, e in ivs
                          if p.startswith(PREFIX) == program)
            found.append((flat, [f[0] for f in flat]))
        acc, reach = {}, None
        for s, e, _ in self.kernels:
            if reach is not None and s > reach:
                mid = 0.5 * (s + reach)
                label = _innermost(*found[0], mid) or _innermost(*found[1], mid) or "host"
                acc[label] = acc.get(label, 0.0) + (s - reach)
            reach = e if reach is None else max(reach, e)
        return sorted(acc.items(), key=lambda kv: -kv[1])[:n]


class ProgramTraced(tracing.Traced):
    """``tracing.Traced`` that keeps the program's ranges (see the module
    docstring); ``program`` is the dict the traced ``Trace`` carries."""

    program: dict = {}

    def trace(self, work, config, untraced=None) -> tracing.Trace:
        out = ProgramTrace(**vars(super().trace(work, config, untraced)))
        events = self.prof.profiler.kineto_results.events()
        base = min((ev.start_ns() for ev in events), default=0)
        cuda = torch.autograd.DeviceType.CUDA
        for ev in events:
            if ev.device_type() != cuda and ev.name().startswith(PREFIX):
                s = (ev.start_ns() - base) * 1e-9
                out.spans.setdefault(ev.name(), []).append((s, s + ev.duration_ns() * 1e-9))
        keep = [i for i, name in enumerate(out.kernel_names) if not name.startswith(PREFIX)]
        if len(keep) < len(out.kernel_names):  # projections an older profiler lists as kernels
            out.kernels = out.kernels[keep]
            out.kernel_names = [out.kernel_names[i] for i in keep]
        out.program = dict(self.program)
        gaps = out.idle_gaps(n=None)
        idle = sum(g for _, g in gaps)
        staged = sum(g for name, g in gaps if name.startswith(PREFIX))
        harness.log(f"idle {idle:.3f} s, of which {staged:.3f} s inside program stages")
        return out


def per_unit_ms(window):
    """(ms per image or per step, the unit) of a window's result."""
    work = window["work"]
    unit = "images" if "images" in work else "steps"
    return 1e3 * window["seconds"] / max(work.get(unit, 0), 1), unit


def spanned_kind(kind, profiling, program, trace_seconds):
    """A stand-in for the traffic kind whose ``Job`` turns spans on and off
    as the module docstring says and keeps the snapshots in ``program``."""

    class Job:
        def __init__(self, ctx):
            profiling.snapshot(reset=True)
            profiling.enable()
            self.job = kind.Job(ctx)
            ctx.sync()
            program["setup"] = profiling.snapshot(reset=True)
            profiling.disable()
            self.setup_counts = dict(self.job.setup_counts,
                                     program_counters=program["setup"]["counters"])
            self.windows = 0

        def window(self, seconds):
            self.windows += 1
            if self.windows > 1:  # the traced window: spans stay on
                out = self.job.window(seconds)
                profiling.disable()
                return out
            untraced = self.job.window(seconds)
            profiling.snapshot(reset=True)  # counters count with spans off too
            profiling.enable()
            spanned = self.job.window(trace_seconds)
            program["window"] = profiling.snapshot(reset=True)
            for key in ("attempted", "failed"):
                untraced[key] += spanned[key]
            (on, unit), (off, _) = per_unit_ms(spanned), per_unit_ms(untraced)
            harness.log(f"spans-only window: {on:.3f} ms per {unit[:-1]} over "
                        f"{spanned['work'].get(unit, 0)} {unit}; untraced {off:.3f} "
                        f"({100.0 * (on / off - 1.0):+.2f}%)")
            return untraced

        def __getattr__(self, name):  # outputs, judge, release, look, ...
            return getattr(self.job, name)

    return type("SpannedKind", (), {"Job": Job, "SPANS": kind.SPANS})


def main(argv=None, root=None, device=None, start=None) -> int:
    """``run.main`` with the program's spans (the module docstring)."""
    start = time.perf_counter() if start is None else start
    profiling = program_tracing()
    if profiling is None or not run.parse(argv).trace:
        return run.main(argv, root=root, device=device, start=start)
    program = {}
    load_cell, traced = harness.load_cell, tracing.Traced

    def spanned_cell(root_, name):
        cell = load_cell(root_, name)
        metrics = [m for m in METRICS if name in m["workloads"]]
        readers = dict(cell.readers)
        for m in metrics:
            readers[m["name"]] = harness.load_file_module(
                Path(root_) / "benchmark" / "metrics" / f"{m['name']}.py",
                "benchmark_program_metric_" + m["name"].replace(".", "_"))
        kind = spanned_kind(cell.kind, profiling, program, cell.traffic["trace_seconds"])
        return replace(cell, kind=kind, per_layer=cell.per_layer + metrics, readers=readers)

    harness.load_cell = spanned_cell
    tracing.Traced = type("Traced", (ProgramTraced,), {"program": program})
    try:
        return run.main(argv, root=root, device=device, start=start)
    finally:
        harness.load_cell, tracing.Traced = load_cell, traced
        profiling.disable()


if __name__ == "__main__":
    sys.exit(main(start=START))
