"""``control.py`` for the 3DGS training cell: the program's readings over
many seeds, the control's (the reference with bfloat16 alpha and colour
products in the program's place) over a few, and a fault's
(``faults_gs.py``) over a few, planted from set-up through the checked
steps, since the cell checks the steps after its window; and, with
``--witness``, each sound seed's steps against the reference in float64.
``--traffic key=value`` sets a traffic parameter over the file's (for
readings on a path where the program keeps its gradients, such as
``adapt_every=1 prologue_max=8``). The cell is loaded as
``later/cells.py`` loads it.

    python benchmark/control_gs.py --workload gs_mip360.train --seeds 1,2,...,20 \
        --control-seeds 1,2,3 --fault tier_grads_zeroed --fault-seeds 1,2,3 \
        --traffic adapt_every=1 --traffic prologue_max=8
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark import control, faults_gs  # noqa: E402
from benchmark.later import cells  # noqa: E402
from benchmark.run import Context  # noqa: E402

WITNESS = {"on": False}


class _Params:
    """A reference step's parameters where a program state stood."""

    def __init__(self, params):
        self.scene = self
        self._params = params

    def params(self):
        return self._params


def control_outputs(job, dt=torch.bfloat16):
    """The reference at ``dt`` in the program's place, on the job's last
    judged checked steps."""
    out = job.last_outputs
    steps = []
    for step in out["steps"]:
        r = job._reference_step(step, dt)
        steps.append(dict(step, image=r["image"], grads=r["grads"], loss=r["loss"],
                          out=_Params(r["params"])))
    return dict(out, steps=steps)


def witness(job):
    """Per checked step of the job's last judged outputs, the program's and
    the float32 reference's image, loss and gradients against the
    reference in float64, and where the two float32 sides part most (the
    Gaussians of the largest opacity-gradient gap)."""
    rows = []
    for step in job.last_outputs["steps"]:
        r32 = job._reference_step(step, None)
        r64 = job._reference_step(step, None, torch.float64)
        row = {"iteration": step["iteration"], "camera": step["camera"]}
        for side, img, loss, grads in (("program", step["image"], step["loss"], step["grads"]),
                                       ("ref32", r32["image"], r32["loss"], r32["grads"])):
            row[side] = {
                "render_gap": float((img.double() - r64["image"]).abs().max()),
                "loss_gap": abs(loss - r64["loss"]) / abs(r64["loss"]),
                "grad_diff": {k: float((g.double() - r64["grads"][k]).norm()
                                       / r64["grads"][k].norm()) for k, g in grads.items()}}
        g_p, g_32 = step["grads"]["opacity"].flatten(), r32["grads"]["opacity"].flatten()
        g_64 = r64["grads"]["opacity"].flatten()
        top = torch.argsort((g_p - g_32).abs(), descending=True)[:4]
        row["opacity_top"] = [(int(i), float(g_p[i]), float(g_32[i]), float(g_64[i]))
                              for i in top]
        rows.append(row)
        del r32, r64
    return rows


def readings(cell, seed, device, with_control: bool, fault=None) -> dict:
    """One seed's row, as ``control.readings``; with ``--witness`` a sound
    run's row also holds the float64 witness. Each seed's states are freed
    before the next."""
    import gc

    undo = faults_gs.FAULTS[fault]() if fault else None
    try:
        job = cell.kind.Job(Context(cell, seed, device))
        job.window(0.0)
        out = job.outputs()
    finally:
        if undo:
            undo()
    job.release()
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()
    row = {"seed": seed, "fault": fault, "program": job.judge(out), "control": None,
           "look": job.look}
    if WITNESS["on"] and not fault:
        row["witness"] = witness(job)
    if with_control:
        row["control"] = job.judge(control_outputs(job))
        row["control_look"] = job.look
    del job, out
    gc.collect()
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()
    return row


def main(argv=None, root=None, device=None) -> int:
    """``control.main`` with this module's faults, ``readings`` and the
    later cells' loader in place, put back when it returns."""
    argv = list(sys.argv[1:] if argv is None else argv)
    traffic = {}
    while "--traffic" in argv:
        i = argv.index("--traffic")
        key, value = argv[i + 1].split("=", 1)
        traffic[key] = json.loads(value)
        del argv[i:i + 2]
    WITNESS["on"] = "--witness" in argv
    argv = [a for a in argv if a != "--witness"]
    saved = control.readings, dict(control.FAULTS)
    control.FAULTS.update(faults_gs.FAULTS)
    control.readings = readings
    try:
        return cells.patched(control.main, traffic)(argv, root=root, device=device)
    finally:
        control.readings = saved[0]
        control.FAULTS.clear()
        control.FAULTS.update(saved[1])


if __name__ == "__main__":
    sys.exit(main())
