"""Every cell rehearsed on the CPU at a tiny size through the program's
plain paths: set-up, window, (traced window,) the reference's judgement and
the result line."""

import json

import pytest

from conftest import CELLS, run_cell


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(tiny_root, capsys, cell):
    rc, line = run_cell(tiny_root, cell, capsys=capsys)
    assert rc == 0
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks"
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}
    assert set(line["metrics"]) == want
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("cell", ("dinov2_s14.pose", "dinov2_s14.train"))
def test_traced_run_reports_per_layer_only(tiny_root, capsys, cell):
    rc, line = run_cell(tiny_root, cell, trace=1, capsys=capsys)
    assert rc == 0 and line["correct"] is True
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    per_layer = {m["name"] for m in bench["per_layer"] if cell in m.get("workloads", [cell])}
    # no kernel runs on the CPU: only the host-side span metrics can read
    assert line["metrics"] and set(line["metrics"]) <= per_layer
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_same_seed_same_inputs(tiny_root, capsys):
    _, a = run_cell(tiny_root, "dinov2_s14.pose", seed=2 ** 31 + 5, capsys=capsys)
    _, b = run_cell(tiny_root, "dinov2_s14.pose", seed=2 ** 31 + 5, capsys=capsys)
    assert a["checks"] == b["checks"]
