#!/usr/bin/env python3
"""The port's workflow tools (sixdgs_torch/tools/) on one NVIDIA GPU at their
default depth, each run in this process through its ``main``, with what a
long run costs in memory.

    python3 workflow_depth.py [--workdir DIR] [--out FILE]

Runs, in this order:
  quality         tools.quality_workflow at its defaults (3,000 iterations,
                  3,000 GT Gaussians, 28 + 6 views at 400x400);
  quality_cut     chip_smoke.py phase 12's configuration (TOOLS_QW_ARGS:
                  1,000 iterations from a sparse init, an opacity reset at
                  800), the reading its PSNR floor is set from;
  accuracy        tools.pose_accuracy_experiment --fused_attention, 600
                  iterations;
  accuracy_plain  the same at the tool's default, the plain scorer: the
                  same seeds without B1 and B2;
  stage           tools.pose_stage_artifact --fused_attention at its
                  defaults: both backbones at 1,500 iterations;
  stage_30        the same artifact again with --keep and 30 pose
                  iterations, on the scene the stage run trained, so that a
                  30- and a 1,500-iteration pose run are compared on one
                  scene.

For every run and for each pose-driver and 3DGS-training call inside it
(chip_smoke.ToolObserver): the wall, the peak host RSS (VmRSS sampled every
0.1 s) and the peak device memory (torch.cuda.max_memory_allocated, reset
at the call's start); for each pose-driver call, the id-module training's
ms per step, and host RSS and device memory allocated at every ray renewal
(first, last, max, count) with the renewals' mean ms, so that growth over
the run shows. Prints each tool's own output, then one JSON object per run
("[depth] {...}"), the card's name and power limit from nvidia-smi, and
writes all of it to ``--out`` (default build/workflow_depth.json).
Exits non-zero when no CUDA device is present or any run fails.

Parity at depth: every 3DGS training run inside a run is digested
(chip_smoke.GSDigests: every 25 iterations and after the last, the loss,
the active count, the sum and sum of squares of each parameter group and a
hash of the state's bytes) and timed (ms a step without the digests, the
densifications' seconds), and the record starts with the host's facts
(CPU model and flags, cores, torch, CUDA, cuDNN, numpy and driver
versions, a hash of the card's UUID). ``--repeat N`` runs the quality tool
N times (quality, quality_2, ...) and prints, for each repeat, the first
digest at which it leaves the first run's, or that none does. ``--runs``
picks runs by name; ``--deterministic`` runs under
torch.use_deterministic_algorithms(True) with
CUBLAS_WORKSPACE_CONFIG=:4096:8, so that an operation without a
deterministic implementation raises where it runs.

    python3 workflow_depth.py --runs quality --repeat 2
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import os
import resource
import shutil
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))


def host_facts() -> dict:
    """The facts that could make two hosts round differently: CPU, cores,
    library versions and SIMD dispatch, the driver and the card."""
    import numpy as np
    import torch

    cpu = {}
    with open("/proc/cpuinfo") as fh:
        for line in fh:
            key, _, val = line.partition(":")
            cpu.setdefault(key.strip(), val.strip())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,driver_version,uuid",
         "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60)
    name, limit, driver, uuid = [f.strip() for f in smi.stdout.splitlines()[0].split(",")]
    features = np._core._multiarray_umath.__cpu_features__
    return {"cpu_model": cpu.get("model name"), "cpu_flags": cpu.get("flags"),
            "cores": os.cpu_count(), "python": sys.version.split()[0],
            "torch": torch.__version__,
            "cuda": torch.version.cuda, "cudnn": torch.backends.cudnn.version(),
            "torch_cpu_capability": torch.backends.cpu.get_cpu_capability(),
            "torch_threads": torch.get_num_threads(), "numpy": np.__version__,
            "numpy_simd": [k for k, v in features.items() if v],
            "gpu": f"{name}, {limit}", "driver": driver,
            # the card itself, as a hash: two runs on one card share it
            "card": hashlib.sha256(uuid.encode()).hexdigest()[:12],
            "env": {k: os.environ.get(k) for k in (
                "ATEN_CPU_CAPABILITY", "NPY_DISABLE_CPU_FEATURES", "OPENBLAS_CORETYPE",
                "OMP_NUM_THREADS", "CUBLAS_WORKSPACE_CONFIG")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=os.path.join(HERE, "build", "workflow_depth"))
    ap.add_argument("--out", default=os.path.join(HERE, "build", "workflow_depth.json"))
    ap.add_argument("--runs", nargs="+", default=None,
                    help="the runs to make, by name (default: all)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="run the quality tool this many times")
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.use_deterministic_algorithms(True), "
                    "CUBLAS_WORKSPACE_CONFIG=:4096:8")
    args = ap.parse_args(argv)

    if args.deterministic:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch

    if not torch.cuda.is_available():
        print("workflow_depth: no CUDA device", file=sys.stderr)
        return 1
    if args.deterministic:
        torch.use_deterministic_algorithms(True)
    sys.path.insert(0, HERE)
    from chip_smoke import (TOOLS_QW_ARGS, GSDigests, Peaks, ToolObserver,
                            first_divergence, gib, gpu_line)

    facts = host_facts()
    print("[depth] host " + json.dumps({k: v for k, v in facts.items() if k != "cpu_flags"}),
          flush=True)

    accuracy = ["--iterations", "600"]
    runs = {
        "quality": ("quality_workflow", []),
        "quality_cut": ("quality_workflow", TOOLS_QW_ARGS),
        "accuracy": ("pose_accuracy_experiment", accuracy + ["--fused_attention"]),
        "accuracy_plain": ("pose_accuracy_experiment", accuracy),
        "stage": ("pose_stage_artifact", ["--fused_attention"]),
        "stage_30": ("pose_stage_artifact", ["--fused_attention", "--keep",
                                             "--n_iterations", "30"]),
    }
    wanted = set(args.runs or runs)
    if wanted - set(runs):
        print(f"workflow_depth: unknown runs {sorted(wanted - set(runs))}", file=sys.stderr)
        return 1
    repeats = [f"quality_{i}" for i in range(2, args.repeat + 1)] if "quality" in wanted else []
    runs = {k: v for k, v in runs.items() if k in wanted}
    runs.update({k: runs["quality"] for k in repeats})
    peaks = Peaks()
    results, failed = {"host": facts, "deterministic": args.deterministic}, []
    for name, (module, extra) in runs.items():
        tool = importlib.import_module(f"sixdgs_torch.tools.{module}")
        argv = list(extra)
        if module != "pose_accuracy_experiment":
            workdir = os.path.join(args.workdir, "stage" if module == "pose_stage_artifact"
                                   else name)
            argv = ["--workdir", workdir] + argv
        peaks.open(name)
        t0 = time.perf_counter()
        rec = {"tool": module, "argv": argv}
        with ToolObserver(peaks) as obs, GSDigests() as dig:
            try:
                out = tool.main(argv)
                if module == "pose_stage_artifact":
                    out = {k: ({kk: vv for kk, vv in v.items() if kk != "results"}
                               if isinstance(v, dict) else v) for k, v in out.items()}
                rec["result"] = out
            except Exception:
                rec["error"] = traceback.format_exc()
                failed.append(name)
                print(rec["error"], flush=True)
        rss, dev = peaks.close(name)
        rec.update({"wall_s": time.perf_counter() - t0, "peak_rss_gib": gib(rss),
                    "ru_maxrss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                    * 1024 / 2**30,
                    "peak_device_gib": gib(dev), **obs.train_summary(),
                    "calls": obs.calls, "gpu": gpu_line(),
                    "gs_runs": [dict(t, ms_per_step=1e3 * (t["run_s"] - t["digest_s"])
                                     / t["iterations"]) for t in dig.timing]})
        print(f"[depth] {name}: " + json.dumps(rec), flush=True)
        rec["digests"] = dig.runs
        if name in repeats:
            first = results["quality"]["digests"]
            rec["divergence"] = [first_divergence(a, b) for a, b in zip(first, dig.runs)]
            print(f"[depth] {name} against quality: first divergent digest "
                  f"{rec['divergence']} (None: all {len(dig.runs[0]) if dig.runs else 0} "
                  f"digests equal)", flush=True)
        results[name] = rec
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)
    peaks.stop()
    shutil.rmtree(args.workdir, ignore_errors=True)
    print(gpu_line())
    if failed:
        print(f"workflow_depth: failed runs {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
