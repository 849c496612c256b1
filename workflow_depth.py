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
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import resource
import shutil
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=os.path.join(HERE, "build", "workflow_depth"))
    ap.add_argument("--out", default=os.path.join(HERE, "build", "workflow_depth.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("workflow_depth: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from chip_smoke import TOOLS_QW_ARGS, Peaks, ToolObserver, gib, gpu_line

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
    peaks = Peaks()
    results, failed = {}, []
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
        with ToolObserver(peaks) as obs:
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
                    "calls": obs.calls, "gpu": gpu_line()})
        results[name] = rec
        print(f"[depth] {name}: " + json.dumps(rec), flush=True)
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
