"""Fixtures of the benchmark's own tests: a copy of the benchmark's files
with the two configurations and the two traffic mixes cut to a size the
CPU runs in seconds, so that every cell is rehearsed end to end through
the program's plain paths. The SuperPoint cells, whose files are in
``benchmark/`` but which ``BENCHMARK.json`` leaves out until they are
proved on the card, are added to the copy by entries alone (and the
training cell's limits file), as a later change would add them."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_POSE = {"ray_budget": 2048, "max_ellipsoids": 64, "knn_normals": 8,
             "rays_to_output": 16, "gradient_accumulation_steps": 6,
             "renewal_every_n_iterations": 2, "val_every_n_iterations": 2}
TINY_TRAFFIC = {
    "pose_closed_loop": {"pool": 3, "height": 40, "width": 60, "warmup_requests": 1,
                         "trace_seconds": 0.01},
    "train_bicycle": {"cameras": 6, "test_every": 3, "height": 40, "width": 60,
                      "check_steps": 3, "warmup_evals": 1, "check_views": 2},
}


LATER_CELLS = {"superpoint.train": "train_bicycle", "superpoint.pose": "pose_closed_loop"}
CELLS = ("dinov2_s14.pose", "dinov2_s14.train", "superpoint.train", "superpoint.pose")


def add_later_cells(root: Path) -> None:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "superpoint", "source": "https://arxiv.org/abs/1712.07629",
                             "file": "benchmark/configs/superpoint.json", "reduced": [],
                             "why": "the pose stack on SuperPoint"})
    for cell, traffic in LATER_CELLS.items():
        bench["workloads"].append({"name": cell, "config": "superpoint", "traffic": traffic,
                                   "chips": 1, "why": "the SuperPoint backbone"})
        kind = cell.split(".")[1]
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and any(w.endswith("." + kind) for w in m["workloads"]):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    limits = root / "benchmark" / "limits"
    if not (limits / "superpoint.train.json").exists():
        shutil.copy(limits / "dinov2_s14.train.json", limits / "superpoint.train.json")


def tiny_config(config: dict) -> dict:
    cfg = json.loads(json.dumps(config))
    cfg["pose"].update(TINY_POSE)
    cfg["scene"]["gaussians"] = 4096
    cfg["scene"]["log_scale"] = [-3.5, -2.5]
    if cfg["backbone"]["type"] == "dino":
        cfg["backbone"].update(hidden_size=64, num_hidden_layers=2, num_attention_heads=1,
                               intermediate_size=256)
        cfg["id_module"]["feature_dim"] = 64
    cfg["id_module"]["ray_hidden"] = 32
    cfg["id_module"]["cam_up_hidden"] = 16
    return cfg


def copy_tree(dst: Path) -> Path:
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark's files at the tiny size."""
    root = copy_tree(tmp_path)
    for path in (root / "benchmark" / "configs").glob("*.json"):
        path.write_text(json.dumps(tiny_config(json.loads(path.read_text()))))
    for name, update in TINY_TRAFFIC.items():
        path = root / "benchmark" / "traffic" / f"{name}.json"
        path.write_text(json.dumps(dict(json.loads(path.read_text()), **update)))
    add_later_cells(root)
    return root


def run_cell(root, workload, seed=12345678901, seconds=0.05, trace=0, capsys=None):
    """One run of ``workload`` on the CPU: (exit code, the result line)."""
    from benchmark import run

    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace)], root=root, device="cpu")
    out = capsys.readouterr().out.strip().splitlines() if capsys else []
    return rc, (json.loads(out[-1]) if out else None)
