"""What every cell shares: finding the cell's files by name, the run's
environment, the device check, host facts, the forbidden-module check and
the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``. Its files are
found by name: ``configs/<config>.json`` (through the ``file`` of its
configuration entry), ``traffic/<traffic>.json`` (a data file whose
``kind`` names the generator ``traffic/<kind>.py``), ``reference/<type>.py``
(the plain reference of the configuration's backbone, by its ``backbone``
``type``, so a configuration that changes only numbers adds no code),
``limits/<cell>.json`` (the limit of each
number that decides ``correct``) and ``metrics/<metric>.py`` for each
per-layer metric. Adding a cell, a configuration, a traffic mix or a
per-layer metric is adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import os
import platform
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "sixdgs_tpu")


def load_file_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    kind: object
    reference: object
    limits: dict
    end_to_end: list
    per_layer: list
    readers: dict


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    base = root / "benchmark"
    traffic = json.loads((base / "traffic" / f"{w['traffic']}.json").read_text())
    tag = name.replace(".", "_").replace("-", "_")
    kind = load_file_module(base / "traffic" / f"{traffic['kind']}.py",
                            f"benchmark_kind_{traffic['kind']}")
    backbone = config["backbone"]["type"]
    reference = load_file_module(base / "reference" / f"{backbone}.py",
                                 f"benchmark_reference_{backbone}")
    per_layer = [m for m in bench["per_layer"] if _applies(m, name)]
    readers = {m["name"]: load_file_module(base / "metrics" / f"{m['name']}.py",
                                           f"benchmark_metric_{tag}_{m['name'].replace('.', '_')}")
               for m in per_layer}
    return Cell(name=name, chips=w["chips"],
                config=config, traffic=traffic,
                kind=kind, reference=reference,
                limits=json.loads((base / "limits" / f"{name}.json").read_text()),
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=per_layer, readers=readers)


def set_environment(root: Path) -> None:
    """Kernel caches at fixed paths inside the checkout, so that only the
    first run of a checkout builds; no library may pull JAX in; one CPU
    thread for PyTorch's and OpenMP's pools (set before torch is imported):
    the program's host path is one Python thread, and idle pool threads
    spinning beside it on a shared host doubled the spread of a training
    period (CV 0.10-0.12 against 0.045-0.071)."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"


def pin_to_one_cpu() -> int:
    """Pin every thread of the process to one CPU of those it may use (the
    last), so that the program's host path, which is one Python thread,
    does not migrate between cores; threads started later inherit it."""
    cpu = max(os.sched_getaffinity(0))
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), {cpu})
        except OSError:
            pass
    return cpu


def devices_ok(chips: int) -> bool:
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is false")
        return False
    if torch.cuda.device_count() < chips:
        log(f"the cell needs {chips} devices, {torch.cuda.device_count()} visible")
        return False
    return True


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def host_facts(device) -> dict:
    """Card, power limit, clocks, versions and CPU flags, for the early lines."""
    import numpy
    import torch

    facts = {"python": sys.version.split()[0], "torch": torch.__version__,
             "cuda": torch.version.cuda, "numpy": numpy.__version__,
             "machine": platform.machine()}
    if str(device).startswith("cuda"):
        facts["device"] = torch.cuda.get_device_name(0)
        try:
            q = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,"
                 "clocks.mem,temperature.gpu,driver_version", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=20)
            facts["nvidia_smi"] = q.stdout.strip().splitlines()
        except (OSError, subprocess.TimeoutExpired) as err:
            facts["nvidia_smi"] = f"unavailable: {err}"
    try:
        flags = set(Path("/proc/cpuinfo").read_text().split("flags")[1].split("\n")[0].split())
        facts["cpu_flags"] = sorted(f for f in flags if f.startswith(("avx", "amx", "fma", "sse4")))
        facts["cpus"] = os.cpu_count()
        facts["torch_threads"] = torch.get_num_threads()
        facts["affinity"] = sorted(os.sched_getaffinity(0))
    except (OSError, IndexError):
        facts["cpu_flags"] = "unavailable"
    return facts


def forbidden_loaded() -> list:
    """Top-level names of loaded modules that the run may not hold."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def judged(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number finite and at or
    under its limit, every limit read."""
    checks, ok = {}, set(numbers) == set(limits)
    for name in sorted(limits):
        value = numbers.get(name, float("nan"))
        checks[name] = {"value": value, "limit": limits[name]}
        ok = ok and value == value and value <= limits[name]
    return ok, checks
