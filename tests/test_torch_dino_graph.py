"""``DinoViT.forward_features`` as a CUDA graph replay against its eager
forward: where the graph path engages (CUDA input, nothing for autograd to
record), what it counts (``graph.backbone_captures`` and
``graph.backbone_replays``), and that its answers are the eager ones.

Imports torch and sixdgs_torch only, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_dino_graph.py -q -s

The tests marked ``cuda`` skip without a CUDA device.
"""

import types

import numpy as np
import pytest
import torch
from torch import nn

from sixdgs_torch.pose import dino
from sixdgs_torch.pose.evaluate import eval_image
from sixdgs_torch.pose.modules import init_id_module
from sixdgs_torch.rays.engine import Rays
from sixdgs_torch.utils import profiling
from torch_threads import shared_cores  # noqa: F401 (an autouse fixture)


def _counts():
    counters = profiling.snapshot()["counters"]
    return (counters.get("graph.backbone_captures", 0),
            counters.get("graph.backbone_replays", 0))


def _model(device, embed_dim=384, depth=12, seed=0):
    return dino.init_params(torch.Generator().manual_seed(seed), embed_dim=embed_dim,
                            depth=depth, device=device).eval()


def _image(seed, device, size=224):
    return torch.randn(3, size, size, generator=torch.Generator().manual_seed(seed)).to(device)


def _eager(model, img):
    """The eager forward, split as forward_features splits it."""
    x = model._tokens(img)
    return {"x_norm_clstoken": x[0], "x_norm_patchtokens": x[1:]}


def _close(a, b, rel=1e-6):
    """At most ``rel`` of the largest magnitude apart."""
    return (a - b).abs().max().item() <= rel * b.abs().max().item()


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


def test_cpu_input_takes_eager_path():
    model = _model("cpu", embed_dim=64, depth=2)
    img = _image(1, "cpu")
    before = _counts()
    with torch.no_grad():
        out = model.forward_features(img)
    assert _counts() == before
    assert not model._graphs
    ref = _eager(model, img)
    for name in ("x_norm_patchtokens", "x_norm_clstoken"):
        assert torch.equal(out[name], ref[name])


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_grad_keeps_eager_path(device):
    """With grad on and a parameter requiring grad, autograd records the
    eager forward on any device; no graph is captured or replayed."""
    if device == "cuda":
        _cuda()
    model = _model(device, embed_dim=64, depth=2)
    before = _counts()
    out = model.forward_features(_image(2, device))["x_norm_patchtokens"]
    assert out.grad_fn is not None
    out.sum().backward()
    assert model.blocks[0].qkv.weight.grad is not None
    assert _counts() == before
    assert not model._graphs


def test_grad_decides_before_the_device():
    """The grad rule alone turns a CUDA input away: with grad on, a
    parameter or the input requiring grad keeps the eager path."""
    model = _model("cpu", embed_dim=64, depth=1)
    cuda_like = types.SimpleNamespace(is_cuda=True, requires_grad=False)
    assert not model._replayable(cuda_like)
    model.requires_grad_(False)
    assert not model._replayable(types.SimpleNamespace(is_cuda=True, requires_grad=True))


def test_state_dict_keys_unchanged_by_graph_cache():
    model = _model("cpu", embed_dim=64, depth=2)
    keys = list(model.state_dict())
    assert keys == [name for name, _ in model.named_parameters()]
    model._graphs[("weights", (3, 224, 224))] = object()  # a filled cache
    assert list(model.state_dict()) == keys
    fresh = dino.DinoViT(64, 2)
    fresh.load_state_dict(model.state_dict())  # strict: same keys both ways
    assert not fresh._graphs


@pytest.mark.cuda
class TestGraphReplay:
    def test_matches_eager(self):
        _cuda()
        model = _model("cuda")
        img = _image(3, "cuda")
        with torch.no_grad():
            out = model.forward_features(img)
            ref = _eager(model, img)
        for name in ("x_norm_patchtokens", "x_norm_clstoken"):
            print(f"{name}: bitwise {torch.equal(out[name], ref[name])}, largest gap "
                  f"{(out[name] - ref[name]).abs().max().item():.3e} of "
                  f"{ref[name].abs().max().item():.3e}")
            assert _close(out[name], ref[name])

    def test_one_capture_n_replays(self):
        _cuda()
        model = _model("cuda")
        before = _counts()
        with torch.no_grad():
            for i in range(5):
                model.forward_features(_image(10 + i, "cuda"))
        assert _counts() == (before[0] + 1, before[1] + 5)

    def test_second_shape_second_capture(self):
        _cuda()
        model = _model("cuda")
        small = _image(4, "cuda", size=112)
        before = _counts()
        with torch.no_grad():
            model.forward_features(_image(5, "cuda"))
            out = model.forward_features(small)
            model.forward_features(_image(6, "cuda"))
            ref = _eager(model, small)
        assert _counts() == (before[0] + 2, before[1] + 3)
        assert len(model._graphs) == 2
        assert out["x_norm_patchtokens"].shape == (64, 384)
        assert _close(out["x_norm_patchtokens"], ref["x_norm_patchtokens"])

    def test_result_survives_next_call(self):
        _cuda()
        model = _model("cuda")
        with torch.no_grad():
            first = model.forward_features(_image(7, "cuda"))
            kept = {k: v.clone() for k, v in first.items()}
            second = model.forward_features(_image(8, "cuda"))
        for name in kept:
            assert torch.equal(first[name], kept[name])
            assert not torch.equal(second[name], kept[name])
        assert first["x_norm_patchtokens"].data_ptr() != second["x_norm_patchtokens"].data_ptr()

    def test_new_weights_give_eager_answer(self):
        """In-place loads keep the graph; moved or replaced weights capture
        anew and drop the stale graph."""
        _cuda()
        model = _model("cuda")
        img = _image(9, "cuda")
        with torch.no_grad():
            model.forward_features(img)
            captures = _counts()[0]

            model.load_state_dict(_model("cuda", seed=1).state_dict())  # copies in place
            out = model.forward_features(img)
            assert _counts()[0] == captures
            assert _close(out["x_norm_patchtokens"], _eager(model, img)["x_norm_patchtokens"])

            held = [p.data for p in model.parameters()]  # so the new storage lies elsewhere
            model.to(torch.float64).to(torch.float32)
            del held
            out = model.forward_features(img)
            assert _counts()[0] == captures + 1
            assert _close(out["x_norm_patchtokens"], _eager(model, img)["x_norm_patchtokens"])

            fc1 = model.blocks[5].fc1
            fc1.weight = nn.Parameter(torch.randn_like(fc1.weight) * 0.05,
                                      requires_grad=False)
            out = model.forward_features(img)
            assert _counts()[0] == captures + 2
            assert len(model._graphs) == 1
            assert _close(out["x_norm_patchtokens"], _eager(model, img)["x_norm_patchtokens"])

    def test_eval_image_matches_eager(self):
        """eval_image through the graph and through the eager forward (the
        graph path turned off on the instance) give the same scores,
        camera-up and pose."""
        _cuda()
        rng = np.random.default_rng(11)
        n = 4096
        dirs = rng.normal(size=(n, 3))
        rays = Rays(*(torch.tensor(a, dtype=torch.float32, device="cuda") for a in (
            rng.normal(size=(n, 3)), dirs / np.linalg.norm(dirs, axis=1, keepdims=True),
            rng.uniform(size=(n, 3)))),
            valid=torch.tensor(rng.uniform(size=n) > 0.1, device="cuda"),
            gaussian_idx=torch.arange(n, dtype=torch.int32, device="cuda"))
        gen = torch.Generator().manual_seed(12)
        model = _model("cuda")
        idm = init_id_module(gen, device="cuda").eval()
        img = torch.tensor(rng.uniform(size=(300, 400, 3)), dtype=torch.float32, device="cuda")
        mask = torch.tensor(rng.uniform(size=(300, 400)) > 0.3, device="cuda")
        gt = torch.eye(4, device="cuda")
        gt[:3, 3] = torch.tensor([0.0, 0.5, 3.0])
        before = _counts()
        graphed = eval_image(model, idm, img, mask, gt, rays)
        assert _counts() == (before[0] + 1, before[1] + 1)
        model._replayable = lambda img: False
        eager = eval_image(model, idm, img, mask, gt, rays)
        assert _counts() == (before[0] + 1, before[1] + 1)
        for name in ("scores", "cam_up", "c2w"):
            gap = (graphed[name] - eager[name]).abs().max().item()
            print(f"eval_image {name}: largest gap {gap:.3e}")
            assert _close(graphed[name], eager[name])
