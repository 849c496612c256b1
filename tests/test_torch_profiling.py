"""The port's spans and counters (``sixdgs_torch.utils.profiling``): the
mechanism on a patched clock and under a CPU ``torch.profiler``, and the
stages of one pose request, a three-step training run with one validation,
and a kernel build, at a tiny size. The program's outputs are the same bit
for bit with spans on and off. Torch runs on one CPU thread here
(``torch_threads.one_thread``): at these sizes its threads cost more than
they give, most of all beside other test workers."""

import os
import stat
import sys

import numpy as np
import pytest
import torch

from sixdgs_torch.ops import _build
from sixdgs_torch.pose import trainer as ttr
from sixdgs_torch.pose.dino import DinoViT
from sixdgs_torch.pose.evaluate import eval_image
from sixdgs_torch.pose.modules import init_id_module
from sixdgs_torch.rays.engine import generate_rays_from_scene
from sixdgs_torch.scene.gaussians import from_arrays
from sixdgs_torch.scene.structures import CameraInfo
from sixdgs_torch.utils import profiling
from sixdgs_torch.utils.config import PoseEstimationConfig
import per_image_loss as pil  # tests/per_image_loss.py
from torch_threads import one_thread, shared_cores  # noqa: F401 (fixtures)

SIZE = 64
CFG = dict(gradient_accumulation_steps=4, ray_budget=2048, max_ellipsoids=300,
           renewal_every_n_iterations=2, rays_to_output=16)
N_TRAIN, N_TEST, STEPS = 4, 2, 3


@pytest.fixture(autouse=True)
def fresh(one_thread):
    profiling.disable()
    profiling.snapshot(reset=True)
    yield
    profiling.disable()
    profiling.snapshot(reset=True)


def _calls(snap):
    return {name: s["calls"] for name, s in snap["spans"].items()}


def _profiled_ranges(fn):
    """{range name: count} of the ``sixdgs:`` ranges a CPU profiler records
    around ``fn()``."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    out = {}
    for ev in prof.events():
        if ev.name.startswith(profiling.PREFIX):
            name = ev.name[len(profiling.PREFIX):]
            out[name] = out.get(name, 0) + 1
    return out


# ------------------------------------------------------------------ mechanism


class TestMechanism:
    def test_off_records_nothing_and_opens_no_range(self):
        @profiling.span("t.decorated")
        def work():
            with profiling.span("t.block"):
                return torch.ones(4).sum()

        assert _profiled_ranges(work) == {}
        assert profiling.snapshot() == {"spans": {}, "counters": {}}
        assert profiling.span("t.block") is profiling.span("t.block")  # one shared object

    def test_times_self_times_and_parents_on_a_patched_clock(self, monkeypatch):
        ticks = iter([0, 10, 40, 50, 55, 100, 200, 230, 1000, 1300])
        monkeypatch.setattr(profiling.time, "perf_counter_ns", lambda: next(ticks) * 1_000_000)
        profiling.enable()
        with profiling.span("outer"):  # 0 .. 100
            with profiling.span("inner"):  # 10 .. 40
                pass
            with profiling.span("inner"):  # 50 .. 55
                pass
        with profiling.span("inner"):  # 200 .. 230, at the top
            pass
        with pytest.raises(ValueError):
            with profiling.span("failing"):  # 1000 .. 1300
                raise ValueError("closed all the same")
        spans = profiling.snapshot()["spans"]
        assert spans["outer"] == {"calls": 1, "total_ms": 100.0, "self_ms": 65.0,
                                  "max_ms": 100.0, "parents": {}}
        assert spans["inner"] == {"calls": 3, "total_ms": 65.0, "self_ms": 65.0,
                                  "max_ms": 30.0, "parents": {"outer": 2}}
        assert spans["failing"] == {"calls": 1, "total_ms": 300.0, "self_ms": 300.0,
                                    "max_ms": 300.0, "parents": {}}

    def test_span_open_across_disable_is_dropped(self):
        profiling.enable()
        with profiling.span("kept"):
            pass
        with profiling.span("dropped"):
            profiling.disable()
            profiling.enable()
        with profiling.span("after"):
            pass
        spans = profiling.snapshot()["spans"]
        assert set(spans) == {"kept", "after"} and spans["after"]["parents"] == {}

    def test_each_range_under_the_profiler_is_a_registered_call(self):
        @profiling.span("t.decorated")
        def work():
            for _ in range(3):
                with profiling.span("t.block"):
                    torch.ones(4).sum()

        profiling.enable()
        ranges = _profiled_ranges(work)
        assert ranges == _calls(profiling.snapshot()) == {"t.decorated": 1, "t.block": 3}

    def test_decorator_keeps_name_and_return(self):
        @profiling.span("t.add")
        def add(a, b=2):
            """Adds."""
            return a + b

        assert (add.__name__, add.__doc__, add(1), add(1, b=5)) == ("add", "Adds.", 3, 6)
        assert profiling.snapshot()["spans"] == {}
        profiling.enable()
        assert add(2) == 4
        assert _calls(profiling.snapshot()) == {"t.add": 1}

    def test_counters_and_snapshot_reset(self):
        profiling.count("t.a")
        profiling.count("t.a", 3)
        profiling.count("t.b", 0)
        profiling.enable()
        with profiling.span("t.s"):
            pass
        first = profiling.snapshot(reset=True)
        assert first["counters"] == {"t.a": 4, "t.b": 0} and _calls(first) == {"t.s": 1}
        assert profiling.snapshot() == {"spans": {}, "counters": {}}

    def test_trace_turns_spans_on_inside_only(self, tmp_path):
        with profiling.trace(str(tmp_path)):
            with profiling.span("t.traced"):
                torch.ones(2).sum()
        with profiling.span("t.after"):
            pass
        assert _calls(profiling.snapshot()) == {"t.traced": 1}
        text = "".join(open(os.path.join(d, f)).read() for d, _, fs in os.walk(tmp_path)
                       for f in fs if f.endswith(".json"))
        assert "sixdgs:t.traced" in text


# --------------------------------------------------------------- the program


def _look_at(pos):
    z = -pos / np.linalg.norm(pos)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=0)  # R_w2c


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(0)
    n = 300
    arrs = {
        "xyz": (rng.normal(size=(n, 3)) * 0.6).astype(np.float32),
        "features_dc": rng.normal(size=(n, 1, 3)).astype(np.float32),
        "features_rest": (rng.normal(size=(n, 15, 3)) * 0.1).astype(np.float32),
        "opacity": rng.uniform(1.0, 3.0, size=(n, 1)).astype(np.float32),
        "scaling": rng.uniform(-2.6, -2.0, size=(n, 3)).astype(np.float32),
        "rotation": rng.normal(size=(n, 4)).astype(np.float32),
    }
    cams = []
    for i in range(N_TRAIN + N_TEST):
        ang = 2 * np.pi * i / (N_TRAIN + N_TEST)
        pos = np.array([1.8 * np.cos(ang), 0.4, 1.8 * np.sin(ang)])
        R_w2c = _look_at(pos)
        img = (rng.uniform(size=(SIZE, SIZE, 4)) * 255).astype(np.uint8)
        img[..., 3] = 0
        img[10 + i:50, 8:56 - i, 3] = 255
        cams.append(CameraInfo(uid=i, R=R_w2c.T, T=-R_w2c @ pos, FovY=0.9, FovX=0.9,
                               image=img, image_path="", image_name=f"cam{i}",
                               width=SIZE, height=SIZE))
    torch.manual_seed(1)
    dino = DinoViT(64, 2).eval().requires_grad_(False)
    idm = init_id_module(torch.Generator().manual_seed(2), feature_dim=64, device="cpu")
    scene = from_arrays(arrs, 3, capacity=512, device="cpu")
    rays = generate_rays_from_scene(scene, torch.Generator().manual_seed(7),
                                    PoseEstimationConfig(**CFG))
    return dict(dino=dino, idm=idm, scene=scene, rays=rays, train=cams[:N_TRAIN],
                test=cams[N_TRAIN:], img=torch.tensor(rng.uniform(size=(SIZE, SIZE, 3)),
                                                      dtype=torch.float32),
                mask=torch.tensor(rng.uniform(size=(SIZE, SIZE)) > 0.3),
                c2w=torch.tensor(cams[0].c2w(), dtype=torch.float32))


def _request(t):
    return eval_image(t["dino"], t["idm"], t["img"], t["mask"], t["c2w"], t["rays"], k=16)


def _training(t):
    """A trainer set up from the tiny scene, three steps with a read of aux
    every step and one validation of every view after the third: (trainer,
    the logged aux, the validation's results)."""
    tr = ttr.PoseTrainer(t["dino"], t["idm"], t["scene"], t["train"],
                         PoseEstimationConfig(**CFG), seed=5, device="cpu")
    logged, validated = [], []
    validate = tr.validate
    tr.validate = lambda *a, **k: validated.append(validate(*a, **k))
    tr.run(n_iterations=STEPS, log_every=1, validate_every=STEPS, test_cam_infos=t["test"],
           callback=lambda it, aux, trainer: logged.append(aux))
    return tr, logged, validated


REQUEST_SPANS = {
    "pose.eval_image": (1, {}), "pose.backbone": (1, {"pose.eval_image": 1}),
    "pose.preprocess": (2, {"pose.backbone": 2}), "pose.ray_mlp": (1, {"pose.eval_image": 1}),
    "pose.scores": (1, {"pose.eval_image": 1}), "pose.cam_up": (1, {"pose.eval_image": 1}),
    "pose.loss": (1, {"pose.eval_image": 1}), "pose.solve": (1, {"pose.eval_image": 1}),
}
B, VIEWS = CFG["gradient_accumulation_steps"], N_TRAIN + N_TEST
TRAINING_SPANS = {
    "setup.image_cache": (1, {}), "setup.feature_cache": (1, {}),
    "train.step": (STEPS, {}), "train.renewal": (2, {"train.step": 2}),
    "rays.cast": (2, {"train.renewal": 2}), "train.batch": (STEPS, {"train.step": STEPS}),
    "train.forward": (STEPS, {"train.step": STEPS}),
    "train.backward": (STEPS, {"train.step": STEPS}),
    "train.optimizer": (STEPS, {"train.step": STEPS}),
    "train.read": (STEPS, {"train.step": STEPS}),
    "pose.ray_mlp": (STEPS + VIEWS, {"train.forward": STEPS, "pose.eval_image": VIEWS}),
    "pose.scores": (STEPS + VIEWS, {"train.forward": STEPS, "pose.eval_image": VIEWS}),
    "pose.cam_up": (STEPS + VIEWS, {"train.forward": STEPS, "pose.eval_image": VIEWS}),
    "pose.backbone": (N_TRAIN + VIEWS, {"setup.feature_cache": N_TRAIN,
                                        "pose.eval_image": VIEWS}),
    "pose.preprocess": (2 * (N_TRAIN + VIEWS), {"pose.backbone": 2 * (N_TRAIN + VIEWS)}),
    "train.validate": (1, {}), "val.view": (VIEWS, {"train.validate": VIEWS}),
    "val.prepare": (VIEWS, {"val.view": VIEWS}), "val.upload": (VIEWS, {"val.view": VIEWS}),
    "val.read": (VIEWS, {"val.view": VIEWS}), "pose.eval_image": (VIEWS, {"val.view": VIEWS}),
    "pose.loss": (VIEWS, {"pose.eval_image": VIEWS}),
    "pose.solve": (VIEWS, {"pose.eval_image": VIEWS}),
}


def _spans(snap):
    return {name: (s["calls"], s["parents"]) for name, s in snap["spans"].items()}


class TestProgramStages:
    def test_request_spans(self, tiny):
        profiling.enable()
        _request(tiny)
        snap = profiling.snapshot()
        assert _spans(snap) == REQUEST_SPANS
        assert snap["counters"] == {}  # eval_image reads nothing back itself
        s = snap["spans"]["pose.eval_image"]
        assert 0 < s["self_ms"] < s["total_ms"] == s["max_ms"]

    def test_training_spans_and_host_reads(self, tiny):
        profiling.enable()
        _training(tiny)
        snap = profiling.snapshot()
        assert _spans(snap) == TRAINING_SPANS
        # a step reads the loss and, logging every step, the four aux values;
        # a view reads eight numbers back; a step scores its B images as one;
        # the first validation serves the training views from the image
        # cache and prepares the held-out ones
        assert snap["counters"] == {"host.reads": STEPS * (1 + 4) + VIEWS * 8,
                                    "train.batched_images": STEPS * B,
                                    "val.cached_views": N_TRAIN}

    def test_batched_images_counted_with_spans_off(self):
        idm, fbatch, rays, up = pil.random_step(pil.SMALL["dino"], nan_image=False)
        ttr.batch_loss_cached(idm, fbatch, rays, up)
        assert profiling.snapshot() == {
            "spans": {}, "counters": {"train.batched_images": fbatch.c2w.shape[0]}}

    def test_off_opens_no_range_in_a_request_or_a_step(self, tiny):
        assert _profiled_ranges(lambda: _request(tiny)) == {}
        assert _profiled_ranges(lambda: _training(tiny)) == {}
        assert profiling.snapshot()["spans"] == {}

    def test_ranges_under_the_profiler_match_the_registry(self, tiny):
        profiling.enable()
        ranges = _profiled_ranges(lambda: (_request(tiny), _training(tiny)))
        assert ranges == _calls(profiling.snapshot())

    def test_outputs_bitwise_equal_on_and_off(self, tiny):
        runs = {}
        for on in (False, True):
            (profiling.enable if on else profiling.disable)()
            request = _request(tiny)
            tr, logged, val = _training(tiny)
            runs[on] = (request, logged, val, dict(tr.id_module.state_dict()), tr.running_loss)
        (req0, log0, val0, sd0, loss0), (req1, log1, val1, sd1, loss1) = runs[False], runs[True]
        assert set(req0) == set(req1)
        for k in req0:
            assert torch.equal(req0[k], req1[k]), k
        assert len(val0) == 1 and log0 == log1 and val0 == val1 and loss0 == loss1
        assert set(sd0) == set(sd1) and all(torch.equal(sd0[k], sd1[k]) for k in sd0)


class TestKernelBuild:
    def test_build_span_and_counters(self, tmp_path, monkeypatch):
        """A stand-in compiler (it writes its -o file) in place of nvcc."""
        nvcc = tmp_path / "nvcc"
        nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                        "open(sys.argv[sys.argv.index('-o') + 1], 'wb').write(b'lib')\n")
        nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
        monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
        profiling.enable()
        assert _build.build("align_compact") > 0
        assert _build.build("align_compact") == 0.0  # current: not built again
        snap = profiling.snapshot()
        assert _spans(snap) == {"setup.kernel_build": (1, {})}
        assert snap["counters"] == {"kernel.builds": 1}
