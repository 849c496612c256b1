"""Run a cell that ``BENCHMARK.json`` leaves out, as ``run.py`` runs one
of its own:

    python benchmark/later/cells.py --workload gs_mip360.train --seed 7 --seconds 20 --trace 0

The cell's entries (configuration, workload, metrics) are read from
``later/entries.json`` and added to ``BENCHMARK.json``'s in memory; its
plain reference is the one its configuration names under ``reference``
(``harness.load_cell`` takes a pose backbone's ``type``). Everything else
is ``run.py``'s. Wiring such a cell in moves its entries into
``BENCHMARK.json``, its configuration into ``configs/`` and the
``reference`` key into ``harness.load_cell``, and deletes this module.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness  # noqa: E402

KEYS = ("configs", "workloads", "end_to_end", "per_layer")


def load_cell(root: Path, name: str, traffic=None) -> harness.Cell:
    """``harness.load_cell`` with the later entries added, the
    configuration's own ``reference``, and ``traffic`` (parameters over the
    traffic file's, for the limit readings) applied."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    later = json.loads((root / "benchmark" / "later" / "entries.json").read_text())
    for key in KEYS:
        bench[key] = bench[key] + later.get(key, [])
    w = {c["name"]: c for c in bench["workloads"]}[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    base = root / "benchmark"
    spec = json.loads((base / "traffic" / f"{w['traffic']}.json").read_text())
    spec.update(traffic or {})
    tag = name.replace(".", "_").replace("-", "_")
    per_layer = [m for m in bench["per_layer"] if harness._applies(m, name)]
    return harness.Cell(
        name=name, chips=w["chips"], config=config, traffic=spec,
        kind=harness.load_file_module(base / "traffic" / f"{spec['kind']}.py",
                                      f"benchmark_kind_{spec['kind']}"),
        reference=harness.load_file_module(base / "reference" / f"{config['reference']}.py",
                                           f"benchmark_reference_{config['reference']}"),
        limits=json.loads((base / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if harness._applies(m, name)],
        per_layer=per_layer,
        readers={m["name"]: harness.load_file_module(
            base / "metrics" / f"{m['name']}.py",
            f"benchmark_metric_{tag}_{m['name'].replace('.', '_')}") for m in per_layer})


def patched(fn, traffic=None):
    """``fn`` with ``harness.load_cell`` taking the later cells while it
    runs."""
    def call(*a, **k):
        saved = harness.load_cell
        harness.load_cell = lambda root, name: load_cell(root, name, traffic)
        try:
            return fn(*a, **k)
        finally:
            harness.load_cell = saved
    return call


def main(argv=None, root=None, device=None, start=None) -> int:
    from benchmark import run

    return patched(run.main)(argv, root=root, device=device, start=start)


if __name__ == "__main__":
    sys.exit(main(start=START))
