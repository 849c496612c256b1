"""A cell, a configuration, a traffic mix and a per-layer metric are added
by adding files and entries alone: no file the benchmark already has is
edited, and the harness finds the new ones by name."""

import hashlib
import json

from conftest import run_cell

METRIC = '''"""Requests the traced window served (a count, for the test)."""


def read(trace):
    return float(trace.work.get("images", 0)) or None
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()}


def test_cell_added_from_files_alone(tiny_root, capsys):
    base = tiny_root / "benchmark"
    before = _digests(tiny_root)
    config = json.loads((base / "configs" / "dinov2_s14.json").read_text())
    config.update(name="dinov2_s14_dense")
    config["scene"]["gaussians"] = 8192
    (base / "configs" / "dinov2_s14_dense.json").write_text(json.dumps(config))
    traffic = json.loads((base / "traffic" / "pose_closed_loop.json").read_text())
    traffic.update(pool=2, mask_cover=0.3)
    (base / "traffic" / "pose_two_views.json").write_text(json.dumps(traffic))
    (base / "metrics" / "served.pose_dense.py").write_text(METRIC)
    limits = json.loads((base / "limits" / "dinov2_s14.pose.json").read_text())
    (base / "limits" / "dinov2_s14_dense.pose_two_views.json").write_text(json.dumps(limits))

    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    cell = "dinov2_s14_dense.pose_two_views"
    bench["configs"].append({"name": "dinov2_s14_dense", "source": "https://arxiv.org/abs/2304.07193",
                             "file": "benchmark/configs/dinov2_s14_dense.json", "reduced": [],
                             "why": "a denser scene"})
    bench["workloads"].append({"name": cell, "config": "dinov2_s14_dense",
                               "traffic": "pose_two_views", "chips": 1, "why": "two views"})
    for m in bench["end_to_end"]:
        if m["name"] == "image_p95_ms":
            m["workloads"].append(cell)
    bench["per_layer"].append({"name": "served.pose_dense", "unit": "images", "better": "higher",
                               "source": "program_counter", "layer": "pose.evaluate",
                               "moves": "image_p95_ms", "workloads": [cell]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digests(tiny_root)
    assert all(after[p] == d for p, d in before.items())
    # the new configuration's backbone reference is found by its type: no code added
    assert not [p for p in after if p.parts[1] == "reference" and p not in before]

    rc, line = run_cell(tiny_root, cell, capsys=capsys)
    assert rc == 0 and line["correct"] is True
    assert set(line["metrics"]) == {"image_p95_ms", "peak_gib", "setup_s"}
    rc, line = run_cell(tiny_root, cell, trace=1, capsys=capsys)
    assert rc == 0 and line["metrics"]["served.pose_dense"]["value"] >= 1
