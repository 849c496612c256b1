"""Run one cell of the benchmark of ``sixdgs_torch`` once.

    python benchmark/run.py --workload dinov2_s14.pose --seed 7 --seconds 20 --trace 0

Loads the cell's configuration and traffic by name (``BENCHMARK.json``),
makes every input from ``--seed`` on the device, sets the program up and
warms its shapes, measures for ``--seconds``, then judges what the window
produced against the plain reference in ``reference/``. Standard error
carries the host facts, the run's counts and, as its last lines, each
number compared beside its limit; the last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(with ``--trace 1`` the per-layer metrics, read from a traced window
that follows an untraced one of ``--seconds``, and ``breakdown``), then
``checks``. Exits non-zero without a result when no CUDA device is there
or when JAX or the JAX package was loaded (looked for once the window has
closed and again just before the result is printed). On the card every
thread of the run is pinned to one CPU.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class Context:
    """What a traffic kind's ``Job`` gets: the cell's files, the seed, the
    device and one generator on it from which every input is drawn."""

    def __init__(self, cell, seed, device):
        import torch

        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.reference = cell.reference
        self.seed, self.device = seed, device
        self.generator = torch.Generator(device=device).manual_seed(seed % 2 ** 63)

    def sync(self):
        import torch

        if str(self.device).startswith("cuda"):
            torch.cuda.synchronize()


def forbidden() -> bool:
    found = harness.forbidden_loaded()
    if found:
        harness.log("forbidden modules loaded in the measuring process: " + ", ".join(found))
    return bool(found)


def main(argv=None, root=None, device=None, start=None) -> int:
    """One run. ``root`` and ``device`` are for the benchmark's own tests:
    they point the harness at another tree of files or at the CPU (where it
    skips the look for a chip)."""
    start = time.perf_counter() if start is None else start
    args = parse(argv)
    root = Path(root) if root else harness.ROOT
    cell = harness.load_cell(root, args.workload)
    harness.set_environment(root)
    import torch

    if device is None:
        harness.pin_to_one_cpu()
        if not harness.devices_ok(cell.chips):
            return 2
        device = "cuda"
        torch.set_num_threads(1)
    harness.log("host " + json.dumps(harness.host_facts(device)))
    ctx = Context(cell, args.seed, device)
    job = cell.kind.Job(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - start
    harness.log(f"setup {setup_s:.3f} s; " + json.dumps(job.setup_counts))

    result = {}
    if args.trace:
        from benchmark import tracing

        paths = set(cell.kind.SPANS)
        for reader in cell.readers.values():
            paths.update(getattr(reader, "SPANS", ()))
        untraced = job.window(args.seconds)
        with tracing.Traced(paths, device) as traced:
            window = job.window(min(args.seconds, cell.traffic["trace_seconds"]))
        t0 = time.perf_counter()
        trace = traced.trace(window["work"], cell.config, untraced)
        harness.log(f"trace: {len(trace.kernel_names)} kernels, {trace.launches} launches, "
                    f"{trace.unlinked} kernels without a launch event, window "
                    f"{trace.window_s:.3f} s, read in {time.perf_counter() - t0:.1f} s")
    else:
        window = job.window(args.seconds)
    harness.log("window " + json.dumps({k: v for k, v in window.items() if k != "values"}))
    peak = torch.cuda.max_memory_allocated() if str(device).startswith("cuda") else 0

    if forbidden():
        return 3

    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if args.trace:
        for name, reader in cell.readers.items():
            value = reader.read(trace)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
        result["breakdown"] = {"device_ops": [list(x) for x in trace.top_kernels()],
                               "idle_gaps": [list(x) for x in trace.idle_gaps()]}
    else:
        values = dict(window["values"], peak_gib=peak / 2 ** 30, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    outputs = job.outputs()
    job.release()
    gc.collect()
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = job.judge(outputs)
    correct, checks = harness.judged(numbers, cell.limits)
    harness.log(f"reference {time.perf_counter() - t0:.1f} s")
    if getattr(job, "look", None):
        harness.log("look " + json.dumps(job.look, default=str))
    dev = {"platform": "gpu" if str(device).startswith("cuda") else "cpu",
           "kind": torch.cuda.get_device_name(0) if str(device).startswith("cuda") else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if args.trace:
        dev.update(busy_s=trace.busy_s, window_s=trace.window_s)
    windows = [untraced, window] if args.trace else [window]
    failed = sum(w["failed"] for w in windows)
    line = {"correct": bool(correct and failed == 0),
            "attempted": sum(w["attempted"] for w in windows), "failed": failed,
            "metrics": metrics, "device": dev}
    line.update(result)
    line["checks"] = checks
    if forbidden():
        return 3
    for name, c in checks.items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line, allow_nan=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(start=START))
