"""The 3DGS training cell, which ``BENCHMARK.json`` leaves out until the
program keeps its gradients at the cell's cadence (PERF.md, section 7):
rehearsed through ``later/cells.py`` at a tiny size; the existing cells
load the same reference and readers as before; the plain reference holds
the port's training step (image, loss, every leaf's gradient, one Adam
step) and finite differences; the yardstick's binning counts what the
port's rasterizer keeps; and a run with the timed path broken underneath
comes out not correct, once for each fault the cell can have (its state
left unchanged, half of the image left out of the loss, the rendered
image altered). One camera a step on one chip: no exchange between
chips."""

import json
import math

import numpy as np
import pytest
import torch

from conftest import REPO, run_cell

from benchmark import faults_gs, harness
from benchmark.counts import gs as counts
from benchmark.later import cells
from benchmark.reference import gaussians as ref
from benchmark.traffic import gs_train

BEFORE = {
    "dinov2_s14.pose": ("dino.py", {
        "device_idle.pose", "mfu.pose", "host_launches.pose", "backbone_ms.pose",
        "b1_roofline.pose", "solver_ms.pose"}),
    "dinov2_s14.train": ("dino.py", {
        "device_idle.train", "mfu.train", "host_launches.train", "b1_roofline.train",
        "b2_roofline.train", "adafactor_ms.train", "validation_share.train",
        "renewal_ms.train"}),
    "superpoint.pose": ("superpoint.py", {
        "b1_roofline.sp_pose", "scorer_pad_ms.sp_pose", "backbone_ms.sp_pose",
        "host_launches.sp_pose", "device_idle.sp_pose"}),
}


TINY_GS = {"count": 3000}
TINY_DATASET = {"images": 6, "test_every": 3, "height": 40, "width": 60}
TINY_TRAFFIC = {"warmup_steps": 1, "check_steps": 2, "trace_seconds": 0.01}
CELL = "gs_mip360.train"


@pytest.fixture
def gs_root(tiny_root):
    """The tiny copy with the 3DGS configuration and traffic cut to size."""
    base = tiny_root / "benchmark"
    path = base / "later" / "gs_mip360.json"
    cfg = json.loads(path.read_text())
    cfg["gaussians"].update(TINY_GS)
    cfg["dataset"].update(TINY_DATASET)
    path.write_text(json.dumps(cfg))
    path = base / "traffic" / "gs_train_bicycle.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), **TINY_TRAFFIC)))
    return tiny_root


def run_gs(root, capsys, **k):
    return cells.patched(run_cell)(root, CELL, capsys=capsys, **k)


@pytest.mark.parametrize("trace", (0, 1))
def test_gs_cell_runs_and_is_correct(gs_root, capsys, trace):
    rc, line = run_gs(gs_root, capsys, trace=trace)
    assert rc == 0
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == set(json.loads(
        (gs_root / "benchmark" / "limits" / f"{CELL}.json").read_text()))
    later = json.loads((gs_root / "benchmark" / "later" / "entries.json").read_text())
    if trace:
        # no kernel runs on the CPU: the readers find nothing to read
        assert set(line["metrics"]) <= {m["name"] for m in later["per_layer"]}
        assert line["device"]["window_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"gs_step_ms", "peak_gib", "setup_s"}


def test_later_entries_wait_outside_the_benchmark():
    """The cell's entries are whole (configuration, readers, limits found
    by name; its metrics move its own step time) and none is in
    ``BENCHMARK.json`` yet."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    later = json.loads((REPO / "benchmark" / "later" / "entries.json").read_text())
    for key in cells.KEYS:
        assert not {m["name"] for m in later[key]} & {m["name"] for m in bench[key]}
    assert [w["name"] for w in later["workloads"]] == [CELL]
    assert all((REPO / c["file"]).is_file() for c in later["configs"])
    assert all((REPO / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
               for m in later["per_layer"])
    assert {m["moves"] for m in later["per_layer"]} == {"gs_step_ms"}
    assert [m["name"] for m in later["end_to_end"]] == ["gs_step_ms"]
    spec = cells.load_cell(REPO, CELL)
    assert spec.reference.__file__.endswith("/benchmark/reference/gaussians.py")
    assert len(spec.readers) == 8 and spec.limits["dropped_steps"] == 0


def test_gs_cadence_is_the_apps():
    """The traffic runs ``run`` as the ``train_gs`` app does: its log
    cadence, ``run``'s adaptation cadence, no untimed step."""
    import inspect

    from sixdgs_torch.apps import train_gs
    from sixdgs_torch.train.gs_trainer import GSTrainer

    traffic = json.loads((REPO / "benchmark" / "traffic" / "gs_train_bicycle.json").read_text())
    assert "default=50)" in inspect.getsource(train_gs).split('"--log_every"')[1].split("\n")[0]
    assert traffic["log_every"] == 50
    assert traffic["adapt_every"] == inspect.signature(
        GSTrainer.run).parameters["adapt_tiers_every"].default
    assert traffic["prologue_max"] == 0


@pytest.mark.parametrize("cell", sorted(BEFORE))
def test_existing_cells_load_as_before(cell):
    spec = harness.load_cell(REPO, cell)
    module, readers = BEFORE[cell]
    assert spec.reference.__file__.endswith("/benchmark/reference/" + module)
    assert set(spec.readers) == readers
    assert "step_ms" in {m["name"] for m in spec.end_to_end} or cell.endswith(".pose")


def _scene(n=400, seed=3):
    g = torch.Generator().manual_seed(seed)
    leaves = {"xyz": torch.randn(n, 3, generator=g),
              "features_dc": 0.5 * torch.randn(n, 1, 3, generator=g),
              "features_rest": 0.1 * torch.randn(n, 15, 3, generator=g),
              "opacity": torch.rand(n, 1, generator=g) * 5 - 2,
              "scaling": torch.rand(n, 3, generator=g) - 3.0,
              "rotation": torch.randn(n, 4, generator=g)}
    m = {k: 1e-3 * torch.randn(v.shape, generator=g) for k, v in leaves.items()}
    v = {k: 1e-5 * (0.5 + torch.rand(x.shape, generator=g)) for k, x in leaves.items()}
    return leaves, m, v


W, H, FOV_X = 60, 40, 1.15
FOV_Y = 2 * math.atan(math.tan(FOV_X / 2) * H / W)
TIERS = (4, 16, 16, 4, 64)  # small budgets, so that every tier holds Gaussians


def _camera(i=1):
    from benchmark import inputs

    return inputs.ring_c2w(8, 3.0, 0.8)[i]


def _program_step(leaves, m, v, image, c2w):
    from sixdgs_torch.scene.cameras import make_synthetic_camera
    from sixdgs_torch.scene.gaussians import GaussianScene
    from sixdgs_torch.train import gs_trainer as gt
    from sixdgs_torch.train.optim import AdamState

    n = leaves["xyz"].shape[0]
    R = c2w[:3, :3].astype(np.float64)
    cam = make_synthetic_camera(W, H, FOV_X, FOV_Y, R, -R.T @ c2w[:3, 3].astype(np.float64),
                                image=image)
    state = gt.GSTrainState(
        scene=GaussianScene(active=torch.ones(n, dtype=torch.bool), max_sh_degree=3, **leaves),
        adam=AdamState(m=m, v=v, step=torch.tensor(99, dtype=torch.int32)),
        xyz_grad_accum=torch.zeros(n), denom=torch.zeros(n),
        max_radii2d=torch.zeros(n, dtype=torch.int32))
    kept = {}
    render, update = gt._render_params, gt.adam_update

    def render_params(*a, **k):
        out = render(*a, **k)
        kept["image"] = out[0].detach()
        return out

    def adam_update(params, grads, st, lrs):
        kept["grads"] = grads
        return update(params, grads, st, lrs)

    gt._render_params, gt.adam_update = render_params, adam_update
    try:
        lrs = {k: float(np.float32(x)) for k, x in LRS.items()}
        new, metrics = gt.train_step(state, gt.camera_arrays(cam, "cpu", with_image=True),
                                     torch.zeros(3), lrs, width=W, height=H, sh_degree=3,
                                     tiers=TIERS)
    finally:
        gt._render_params, gt.adam_update = render, update
    return kept, float(metrics["loss"]), new.scene.params()


LRS = {"xyz": 5e-5, "features_dc": 0.0025, "features_rest": 0.000125, "opacity": 0.05,
       "scaling": 0.005, "rotation": 0.001}


def test_reference_holds_the_program_step():
    leaves, m, v = _scene()
    c2w = _camera()
    image = np.random.default_rng(0).random((3, H, W)).astype(np.float32)
    prog, loss, params = _program_step(leaves, m, v, image, c2w)
    lrs = {k: float(np.float32(x)) for k, x in LRS.items()}
    want = ref.train_step(leaves, m, v, 100, gs_train.reference_camera(c2w, FOV_X, FOV_Y, "cpu"),
                          torch.tensor(image), W, H, 3, TIERS, lrs, torch.zeros(3))
    assert float((prog["image"] - want["image"]).abs().max()) < 1e-5
    assert abs(loss - want["loss"]) <= 1e-6 * abs(want["loss"])
    for k in ref.PARAMS:
        g, w = prog["grads"][k], want["grads"][k]
        assert float(w.norm()) > 0, k
        assert float((g - w).norm()) <= 1e-4 * float(w.norm()), k
        assert float((params[k] - want["params"][k]).abs().max()) <= 1e-6 * max(
            1.0, float(leaves[k].abs().max())), k


def test_reference_gradients_match_finite_differences():
    leaves, _, _ = _scene(n=60, seed=5)
    leaves = {k: x.double() for k, x in leaves.items()}
    cam = {k: x.double() if torch.is_tensor(x) else x
           for k, x in gs_train.reference_camera(_camera(2), FOV_X, FOV_Y, "cpu").items()}
    gt_img = torch.rand(3, H, W, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    zero = {k: torch.zeros_like(x) for k, x in leaves.items()}
    out = ref.train_step(leaves, zero, zero, 1, cam, gt_img, W, H, 3, TIERS,
                         dict.fromkeys(ref.PARAMS, 0.0), torch.zeros(3, dtype=torch.float64))

    def loss(params):
        img, _ = ref.render(params, cam, W, H, 3, TIERS, torch.zeros(3, dtype=torch.float64))
        return float(ref.loss_fn(img, gt_img))

    checked = 0
    for k in ref.PARAMS:
        g = out["grads"][k].reshape(-1)
        for i in torch.argsort(g.abs(), descending=True)[:3].tolist():
            eps = 1e-6
            up = {kk: x.clone() for kk, x in leaves.items()}
            dn = {kk: x.clone() for kk, x in leaves.items()}
            up[k].view(-1)[i] += eps
            dn[k].view(-1)[i] -= eps
            fd = (loss(up) - loss(dn)) / (2 * eps)
            assert abs(fd - float(g[i])) <= 1e-4 * abs(float(g[i])) + 1e-9, (k, i, fd, float(g[i]))
            checked += 1
    assert checked == 3 * len(ref.PARAMS)


def test_counts_keep_what_the_program_keeps():
    from sixdgs_torch.ops.rasterizer import pallas_tiles
    from sixdgs_torch.train import gs_trainer as gt

    leaves, _, _ = _scene()
    c2w = _camera()
    from sixdgs_torch.scene.cameras import make_synthetic_camera

    R = c2w[:3, :3].astype(np.float64)
    cam = make_synthetic_camera(W, H, FOV_X, FOV_Y, R, -R.T @ c2w[:3, 3].astype(np.float64))
    proj = gt._project_params(leaves, torch.ones(leaves["xyz"].shape[0], dtype=torch.bool),
                              gt.camera_arrays(cam, "cpu"), W, H, 3)
    t_max, mid_k, t_max_mid, overflow_k, t_max_big = TIERS
    lay = pallas_tiles._compact_layout(proj, W, H, t_max, overflow_k, t_max_big, mid_k,
                                       t_max_mid, 0)
    work = counts.camera_work(leaves, gs_train.reference_camera(c2w, FOV_X, FOV_Y, "cpu"),
                              W, H, 3, TIERS)
    assert work["real"] == int(lay.starts[lay.n_tiles])
    assert work["demand"] == int(lay.al_total)
    assert lay.nc == counts.nc_budget(0, leaves["xyz"].shape[0], TIERS)
    records = pallas_tiles._gather_records(
        lay, pallas_tiles._align_compact(lay.gidx_c, lay.starts, lay.starts_al, lay.n_tiles,
                                         lay.P)).detach()
    _, plain = pallas_tiles.composite_fwd_plain(records, lay.starts_al, lay.counts_k, lay.nx,
                                                lay.ny, torch.zeros(3), return_work=True)
    assert (work["evals"], work["contribs"]) == plain
    bounds = counts.step_bounds([(work, TIERS, 0)], leaves["xyz"].shape[0], W, H)
    assert all(bounds[k] > 0 for k in ("b3_bound_s", "b4_bound_s", "b5_bound_s", "step_flops"))


@pytest.mark.parametrize("fault", ("state_unchanged", "half_image", "render_altered"))
def test_gs_faults(gs_root, capsys, fault):
    undo = faults_gs.FAULTS[fault]()
    try:
        rc, line = run_gs(gs_root, capsys)
    finally:
        undo()
    assert rc == 0
    assert line["correct"] is False, line["checks"]


def test_gs_tier_fault_zeroes_the_mid_tier():
    """The planted tier fault zeroes exactly the mid tier's gradients (the
    tiny cell has no Gaussian wide enough for a tier: this holds it at
    small budgets)."""
    leaves, m, v = _scene()
    image = np.random.default_rng(0).random((3, H, W)).astype(np.float32)
    good, _, _ = _program_step(leaves, m, v, image, _camera())
    undo = faults_gs.FAULTS["tier_grads_zeroed"]()
    try:
        bad, _, _ = _program_step(leaves, m, v, image, _camera())
    finally:
        undo()
    assert torch.equal(good["image"], bad["image"])
    moved = (good["grads"]["opacity"] != bad["grads"]["opacity"]).flatten()
    assert 0 < int(moved.sum()) <= TIERS[1]
    assert float(bad["grads"]["opacity"].flatten()[moved].abs().max()) == 0.0


def test_gs_config_keys():
    cfg = json.loads((REPO / "benchmark" / "later" / "gs_mip360.json").read_text())
    assert cfg["reference"] == "gaussians" and cfg["reduced"] == []
    assert cfg["dataset"]["width"] == 1237 and cfg["dataset"]["height"] == 822
    assert cfg["optimization"]["densify_until_iter"] == cfg["resume_iteration"] == 15000
    from sixdgs_torch.utils.config import OptimizationConfig

    assert OptimizationConfig(**cfg["optimization"]) == OptimizationConfig()


def test_control_and_a_fault_fail_where_the_program_passes(gs_root):
    """On the readings' path (a prologue of up to 8 untimed steps, the
    budget adapted every step) the program passes, the control and an
    unchanged state fail, and the float64 witness reads both float32
    sides."""
    from benchmark import control_gs

    spec = cells.load_cell(gs_root, CELL, {"adapt_every": 1, "prologue_max": 8})
    control_gs.WITNESS["on"] = True
    try:
        row = control_gs.readings(spec, 987654321987, "cpu", True)
    finally:
        control_gs.WITNESS["on"] = False
    assert harness.judged(row["program"], spec.limits)[0] is True, row["program"]
    assert harness.judged(row["control"], spec.limits)[0] is False, row["control"]
    assert row["look"]["prologue"] == 1  # the CPU's plain path computes no budget telemetry
    assert [set(w) >= {"program", "ref32", "opacity_top"} for w in row["witness"]] == [True] * 2
    row = control_gs.readings(spec, 987654321987, "cpu", False, "state_unchanged")
    assert harness.judged(row["program"], spec.limits)[0] is False, row["program"]


def test_readers_count_only_the_timed_steps():
    """A traced window of one untimed step and two timed ones: every
    reader counts what the timed steps launched."""
    from benchmark import readers_gs
    from benchmark.tracing import Trace

    adam = "sixdgs_torch.train.gs_trainer.adam_update"
    fwd = "sixdgs_torch.ops.rasterizer.pallas_tiles.pallas_composite_fwd"
    spans = {readers_gs.STEP: [(0.0, 1.0), (1.0, 2.0), (2.0, 3.0)],
             adam: [(0.5, 0.6), (1.5, 1.6), (2.5, 2.6)], fwd: [(0.2, 0.3), (1.2, 1.3), (2.2, 2.3)]}
    # (start, end, host launch time) per kernel: one per span call, and one more
    kernels = np.array([[0.25, 0.45, 0.25], [0.55, 0.7, 0.55], [1.25, 1.35, 1.25],
                        [1.55, 1.65, 1.55], [2.0, 2.2, 1.9], [2.25, 2.3, 2.25],
                        [2.55, 2.6, 2.55]])
    work = gs_train.CameraWork(None, [])
    work.update({"b3_bound_s": 0.03, "step_flops": 1e12})
    trace = Trace(window_s=3.0, kernels=kernels, kernel_names=["k"] * 7, launches=7,
                  spans=spans, work={"steps": 2, "prologue": 1, "camera_work": work},
                  config={}, untraced={"seconds": 2.0, "work": {"steps": 10}})
    assert readers_gs.timed_from(trace) == 1.0
    assert readers_gs.device_ms_per_step(trace, adam) == pytest.approx(1e3 * 0.15 / 2)
    assert readers_gs.launches_per_step(trace) == 2.5
    busy = 0.1 + 0.1 + 0.2 + 0.05 + 0.05
    assert readers_gs.device_idle_pct(trace) == pytest.approx(100 * (1 - busy / 1.6))
    assert readers_gs.roofline_pct(trace, fwd, "b3_bound_s") == pytest.approx(
        100 * 0.03 / ((0.1 + 0.05) / 2))
    assert readers_gs.mfu_pct(trace) == pytest.approx(100 * 1e13 / (2.0 * 989e12))
