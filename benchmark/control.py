"""Readings that set the limits of ``correct``: the program's numbers over
many seeds and the control's over a few, in one process per cell.

    python benchmark/control.py --workload dinov2_s14.pose --seeds 1,2,...,12 \
        --control-seeds 1,2,3 [--out control.jsonl]

The control is the plain reference computed with bfloat16 products (the
nearest precision below the configuration's float32), put in the program's
place and judged by the same comparison. A pose cell's program readings
come from a short closed-loop window that answers every pool image once;
a training cell's from the steps its set-up drives and from a window of
one period. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402
from benchmark.run import Context  # noqa: E402


def half_batch():
    """Plant a fault in the program: the batch loss over the first half of
    the batch only, its mean taken over that half."""
    from sixdgs_torch.pose import trainer

    original = trainer.batch_loss_cached

    def loss(id_module, fbatch, *a, **k):
        half = fbatch.c2w.shape[0] // 2
        return original(id_module, type(fbatch)(*(t[:half] for t in fbatch)), *a, **k)

    trainer.batch_loss_cached = loss
    return lambda: setattr(trainer, "batch_loss_cached", original)


FAULTS = {"half_batch": half_batch}


def readings(cell, seed, device, control: bool, fault=None) -> dict:
    """{"program": numbers, "control": numbers or None} of one seed; with
    ``fault`` the program runs with that fault planted."""
    import torch

    undo = FAULTS[fault]() if fault else None
    try:
        job = cell.kind.Job(Context(cell, seed, device))
        if hasattr(job, "answers"):  # a request stream: answer every pool image once
            while len(job.answers) < len(job.images):
                job.request()
        else:  # a training job: one period
            job.window(0.0)
    finally:
        if undo:
            undo()
    out = job.outputs()
    indices = sorted(out.get("answers", {}))
    job.release()
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()
    row = {"seed": seed, "fault": fault, "program": job.judge(out), "control": None}
    row["look"] = getattr(job, "look", None)
    if control:
        ctrl = job.control_outputs(indices) if indices else job.control_outputs()
        row["control"] = job.judge(ctrl)
        row["control_look"] = getattr(job, "look", None)
    return row


def main(argv=None, root=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="", help="seeds run with --fault planted")
    p.add_argument("--fault", choices=sorted(FAULTS), default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    root = Path(root) if root else harness.ROOT
    cell = harness.load_cell(root, args.workload)
    harness.set_environment(root)
    if device is None:
        if not harness.devices_ok(cell.chips):
            return 2
        device = "cuda"
        import torch

        torch.set_num_threads(1)
    harness.log("host " + json.dumps(harness.host_facts(device)))
    control = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []
    runs = [(s, None) for s in seeds + sorted(control - set(seeds))]
    runs += [(int(s), args.fault) for s in args.fault_seeds.split(",") if s]
    for seed, fault in runs:
        t0 = time.perf_counter()
        row = readings(cell, seed, device, seed in control and not fault, fault)
        row["seconds"] = time.perf_counter() - t0
        row["workload"] = args.workload
        rows.append(row)
        print(json.dumps(row, default=str), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row, default=str) + "\n")
    for name in cell.limits:
        prog = [r["program"][name] for r in rows if not r["fault"]]
        ctrl = [r["control"][name] for r in rows if r["control"]]
        bad = [r["program"][name] for r in rows if r["fault"]]
        harness.log(f"{name}: program max {max(prog)!r} over {len(prog)} seeds; "
                    f"control min {min(ctrl) if ctrl else None!r} over {len(ctrl)} seeds; "
                    f"{args.fault} min {min(bad) if bad else None!r} over {len(bad)} seeds; "
                    f"limit {cell.limits[name]!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
