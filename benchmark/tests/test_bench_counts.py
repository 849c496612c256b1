"""The operation counts against the figures the port's records give:
B1 6.52 / 13.26 GFLOP and B2 19.55 / 39.77 GFLOP a call at (P, d) =
(256, 384) / (784, 256), N = 32,768 (PERF.md rounds B2 at the DINO shape
to 19.56: 2 (3 P N d + 3 P d^2) = 19,553,845,248)."""

import json

import pytest

from conftest import REPO

from benchmark.counts import flops


@pytest.mark.parametrize("config,p,d,b1,b2,bound1_ms,bound2_ms", [
    ("dinov2_s14", 256, 384, 6.52, 19.55, 0.0198, 0.0593),
    ("superpoint", 784, 256, 13.26, 39.77, 0.0402, 0.1206),
])
def test_scorer_counts(config, p, d, b1, b2, bound1_ms, bound2_ms):
    cfg = json.loads((REPO / "benchmark" / "configs" / f"{config}.json").read_text())
    shape = flops.scorer_shape(cfg)
    assert shape == (p, 32768, d)
    assert flops.b1_flops(*shape) / 1e9 == pytest.approx(b1, abs=0.006)
    assert flops.b2_flops(*shape) / 1e9 == pytest.approx(b2, abs=0.006)
    assert 1e3 * flops.bound_s(flops.b1_flops(*shape), flops.b1_bytes(*shape), 3) \
        == pytest.approx(bound1_ms, abs=6e-5)
    assert 1e3 * flops.bound_s(flops.b2_flops(*shape), flops.b2_bytes(*shape), 3) \
        == pytest.approx(bound2_ms, abs=6e-5)


def test_model_counts():
    cfg = json.loads((REPO / "benchmark" / "configs" / "dinov2_s14.json").read_text())
    # the ray MLP over 32,768 rays and DINOv2-S/14 at 257 tokens
    assert flops.ray_mlp_flops(cfg) / 1e9 == pytest.approx(56.71, abs=0.01)
    assert flops.backbone_flops(cfg) / 1e9 == pytest.approx(12.25, abs=0.01)
    assert flops.image_flops(cfg) > flops.ray_mlp_flops(cfg) + flops.backbone_flops(cfg)
