"""The port's SuperPoint pose stack against the benchmark's plain reference
(``benchmark/reference/superpoint.py`` and ``pose_common.py``), on the CPU,
as the ``superpoint.*`` cells hold it on the card at full size: seeded
random weights in their published layouts (``benchmark/inputs.py``), the
SuperPoint v1 encoder and descriptor head at its published widths on a
224 crop (784 patches x 256), and the id module 256 wide on the 28 x 28
grid over a few hundred rays. Beside them, the scorer wrapper's span
``scorer.pad`` and counter ``scorer.chunks``: taken on a padded call and
not at the kernels' own shape (256 x 384). Imports no JAX.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import inputs, program
from benchmark.reference import pose_common as ref
from benchmark.reference import superpoint as ref_sp
from sixdgs_torch.ops import attention_kernel as tak
from sixdgs_torch.pose.backbone import backbone_features
from sixdgs_torch.pose.id_module import score_image_cached
from sixdgs_torch.rays.engine import Rays
from sixdgs_torch.utils import profiling
from torch_threads import shared_cores  # noqa: F401 (an autouse fixture)

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "benchmark" / "configs"
                     / "superpoint.json").read_text())
N_RAYS = 320

# descriptors are unit vectors through ten float32 convolutions and the
# same antialiased resizes, summed in other orders
DESC_ATOL = 1e-5
# a score sums 784 softmax rows over the rays; float32 products summed in
# other orders (and, fused, the bf16 hi/lo split, ~2^-18 relative) move it by
# ~1e-6 of the largest score; the benchmark's own limit on the card is 2e-5
SCORE_RTOL = 2e-5
# a unit vector from four float32 convolutions over 256 channels and an MLP
UP_ATOL = 2e-5


@pytest.fixture(scope="module")
def stack():
    """Weights, one masked image, random rays, and the reference's
    features, scores and camera-up for them."""
    gen = torch.Generator().manual_seed(20)
    bweights, iweights = inputs.weights(CONFIG, gen, "cpu")
    img = torch.rand((180, 244, 3), generator=gen)
    yy, xx = torch.meshgrid(torch.linspace(-1, 1, 180), torch.linspace(-1, 1, 244),
                            indexing="ij")
    mask = yy ** 2 + (xx / 0.8) ** 2 < 0.6
    rays = {"ori": torch.randn((N_RAYS, 3), generator=gen),
            "dir": torch.nn.functional.normalize(torch.randn((N_RAYS, 3), generator=gen), dim=-1),
            "rgb": torch.rand((N_RAYS, 3), generator=gen),
            "valid": torch.arange(N_RAYS) < N_RAYS - 40}
    tree = inputs.nest(iweights)
    with torch.no_grad():
        x, pmask = ref.preprocess(img, mask, ref_sp.GRID)
        feats = ref_sp.features(bweights, x)
        scores, up, n = ref.score_image(ref_sp, bweights, tree, img, mask, rays)
    return {"bweights": bweights, "iweights": iweights, "img": img, "mask": mask,
            "rays": rays, "feats": feats, "pmask": pmask, "scores": scores, "up": up, "n": n}


def _port_features(stack):
    model = program.backbone(CONFIG, stack["bweights"], "cpu")
    with torch.no_grad():
        return backbone_features(model, stack["img"], stack["mask"], backbone="superpoint")


def test_features_match_reference(stack):
    feats_pe, pmask, fmap = _port_features(stack)
    assert feats_pe.shape == (784, 256 + 14) and fmap.shape == (256, 28, 28)
    assert torch.equal(pmask, stack["pmask"]) and 0 < int(pmask.sum()) < 784
    np.testing.assert_allclose(feats_pe[:, :256].numpy(), stack["feats"].numpy(),
                               atol=DESC_ATOL, rtol=0)


@pytest.mark.parametrize("fused_attention", [False, True])
def test_scores_and_cam_up_match_reference(stack, fused_attention):
    """The plain scorer and, on CPU tensors, the fused scorer's plain
    version (bf16_split3), each with the ray MLP and the camera-up head."""
    feats_pe, pmask, fmap = _port_features(stack)
    idm = program.id_module(stack["iweights"], "cpu")
    r = stack["rays"]
    rays = Rays(ori=r["ori"], dir=r["dir"], rgb=r["rgb"], valid=r["valid"],
                gaussian_idx=torch.zeros(N_RAYS, dtype=torch.int32))
    with torch.no_grad():
        out = score_image_cached(idm, feats_pe, pmask, fmap, rays,
                                 fused_attention=fused_attention)
    want = stack["scores"]
    valid = r["valid"]
    scale = float(want[valid].abs().max())
    assert float((out.scores[valid] - want[valid]).abs().max()) <= SCORE_RTOL * scale
    assert float(out.scores[~valid].abs().max()) <= 1e-6 * scale
    np.testing.assert_allclose(out.cam_up.numpy(), stack["up"].numpy(), atol=UP_ATOL, rtol=0)
    assert int(out.n_patches) == int(stack["n"])


def _call(direction, P, d):
    """One call of the wrapper in ``direction`` at [P, d] over the plain
    versions at the kernels' shape."""
    g = torch.Generator().manual_seed(P + d)
    q, feats = torch.randn((P, d), generator=g), torch.randn((64, d), generator=g)
    wk, bk = 0.05 * torch.randn((d, d), generator=g), 0.1 * torch.randn(d, generator=g)
    pmask, valid = torch.ones(P), torch.ones(64)
    ins = (q, feats, wk, bk, pmask, valid)
    if direction == "fwd":
        return tak.chunked_fwd(*ins, "f32", lambda *a: tak.attention_scores_plain(
            *a[:7], sqrt_d=a[7]))
    _, m, s = tak.attention_scores_plain(*ins, "f32")
    return tak.chunked_bwd(*ins, m, s, torch.randn(64, generator=g), "f32",
                           lambda *a: tak.attention_scores_bwd_plain(*a[:10], sqrt_d=a[10]))


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("P,d,chunks", [(784, 256, 4), (256, 384, 0)])
def test_scorer_pad_span_and_chunk_count(direction, P, d, chunks):
    """A padded call records its wrapper's span (the padding, at least one
    sum, the joins) and counts its chunks; the kernels' own shape records
    neither."""
    profiling.enable()
    try:
        before = profiling.snapshot()
        _call(direction, P, d)
        after = profiling.snapshot()
    finally:
        profiling.disable()

    def grew(snap_key, name, field=None):
        a, b = after[snap_key].get(name, 0), before[snap_key].get(name, 0)
        return (a[field] if a else 0) - (b[field] if b else 0) if field else a - b

    assert grew("counters", "scorer.chunks") == chunks
    # the padding, a sum for each chunk after the first, the joins
    assert grew("spans", "scorer.pad", "calls") == (chunks + 1 if chunks else 0)
