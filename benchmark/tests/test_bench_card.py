"""Each cell of ``BENCHMARK.json`` once on the card, by its command line,
with a short window. Skips without a CUDA device (decided inside the
test)."""

import json
import subprocess
import sys

import pytest

from conftest import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          "3141592653", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, cwd=REPO, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
