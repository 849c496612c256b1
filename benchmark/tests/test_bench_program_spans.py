"""The program's spans and counters as the benchmark reads them
(``program_spans.py``), on the tiny tree: a traced run of each cell reports
the new metrics beside every metric ``run.py``'s traced run reports; with
the program's ``profiling.enable`` taken away (the program before it had
spans) the run is ``run.py``'s; and, on a ``Trace`` reduced from a made-up
event list, a program range's projection onto the device's timeline is no
device work, whether the profiler marks it as an annotation or not, and an
idle gap goes to the program's stage before a benchmark wrapper."""

import json

import numpy as np
import pytest
import torch

from conftest import TINY_POSE, TINY_TRAFFIC, run_cell

from benchmark import program_spans

CELLS = ("dinov2_s14.pose", "dinov2_s14.train")


def run_spans(root, workload, capsys, seed=3000000019, seconds=0.05):
    """One traced run through ``program_spans.main`` on the CPU: (exit code,
    the result line, standard error)."""
    rc = program_spans.main(["--workload", workload, "--seed", str(seed), "--seconds",
                             str(seconds), "--trace", "1"], root=root, device="cpu")
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), out.err


def new_metrics(cell, host_side_only=True):
    """The cell's metrics of ``METRICS``; on the CPU no kernel runs, so the
    ones read from the device's timeline find nothing there."""
    return {m["name"] for m in program_spans.METRICS if cell in m["workloads"]
            and not (host_side_only and m["source"] == "device_trace")}


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_adds_the_program_metrics(tiny_root, capsys, cell):
    rc, plain = run_cell(tiny_root, cell, trace=1, capsys=capsys)
    assert rc == 0 and plain["correct"] is True
    rc, line, err = run_spans(tiny_root, cell, capsys)
    assert rc == 0 and line["correct"] is True, line and line["checks"]
    assert set(line["metrics"]) == set(plain["metrics"]) | new_metrics(cell)
    for name in new_metrics(cell):
        value = line["metrics"][name]["value"]
        assert np.isfinite(value) and value > 0, (name, value)
    assert "spans-only window:" in err and '"program_counters"' in err
    if cell == "dinov2_s14.train":
        # a step reads its loss and four logged values; a validation of every
        # view, once a period, reads eight numbers a view
        tr, pose = TINY_TRAFFIC["train_bicycle"], TINY_POSE
        want = 5 + 8 * tr["cameras"] / pose["val_every_n_iterations"]
        assert line["metrics"]["host_reads.train"]["value"] == want


@pytest.mark.parametrize("cell", CELLS)
def test_program_without_spans_runs_as_run_py(tiny_root, capsys, monkeypatch, cell):
    from sixdgs_torch.utils import profiling

    rc, plain = run_cell(tiny_root, cell, trace=1, capsys=capsys)
    monkeypatch.delattr(profiling, "enable")
    rc_spans, line, err = run_spans(tiny_root, cell, capsys)
    assert rc == rc_spans == 0 and line["correct"] is True
    assert set(line["metrics"]) == set(plain["metrics"])
    assert not new_metrics(cell, host_side_only=False) & set(line["metrics"])
    assert "spans-only window:" not in err


class Event:
    """A kineto event as ``Traced.trace`` reads it."""

    def __init__(self, name, device, start_us, dur_us, corr=0, annotation=None):
        self._v = (name, device, int(start_us * 1e3), int(dur_us * 1e3), corr)
        if annotation is not None:  # newer profilers say which ranges are annotations
            self.is_user_annotation = lambda: annotation

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return 0


@pytest.mark.parametrize("marked", (True, False), ids=("annotation_marked", "older_profiler"))
def test_program_range_projection_is_not_device_work(marked):
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    flag = (lambda v: v) if marked else (lambda v: None)
    wrapper = "sixdgs_torch.pose.id_module.backbone_features"
    events = [
        Event("sixdgs:pose.backbone", cpu, 0, 100, annotation=flag(False)),
        Event(wrapper, cpu, 25, 165, annotation=flag(False)),  # ends after the stage
        Event("cudaLaunchKernel", cpu, 10, 2, corr=1, annotation=flag(False)),
        Event("cudaLaunchKernel", cpu, 60, 2, corr=2, annotation=flag(False)),
        Event("cudaLaunchKernel", cpu, 140, 2, corr=3, annotation=flag(False)),
        Event("cudaLaunchKernel", cpu, 300, 2, corr=4, annotation=flag(False)),
        Event("k1", cuda, 20, 10, corr=1, annotation=flag(False)),
        Event("sixdgs:pose.backbone", cuda, 15, 70, annotation=flag(True)),  # the projection
        Event("k2", cuda, 70, 10, corr=2, annotation=flag(False)),
        Event("k3", cuda, 150, 10, corr=3, annotation=flag(False)),
        Event("k4", cuda, 310, 10, corr=4, annotation=flag(False)),
    ]
    traced = program_spans.ProgramTraced((wrapper,), "cpu")
    traced.prof = type("P", (), {"profiler": type("Q", (), {"kineto_results": type(
        "R", (), {"events": staticmethod(lambda: events)})})})
    trace = traced.trace({"images": 1}, {}, {})
    assert trace.kernel_names == ["k1", "k2", "k3", "k4"]
    assert trace.busy_s == pytest.approx(40e-6)
    assert trace.spans["sixdgs:pose.backbone"] == [(0.0, pytest.approx(100e-6))]
    assert trace.span_device_s("sixdgs:pose.backbone") == pytest.approx(20e-6)
    # the gap at 30-70 us lies in the stage and in the wrapper: the stage
    # takes it; 80-150 us in the wrapper alone; 160-310 us outside both
    got = dict(trace.idle_gaps())
    assert got == {"sixdgs:pose.backbone": pytest.approx(40e-6),
                   wrapper: pytest.approx(70e-6), "host": pytest.approx(150e-6)}
