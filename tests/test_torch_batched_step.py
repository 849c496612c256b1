"""The id-module training step scored as one batch, on the card, against the
per-image loop of ``per_image_loss.py``: at the published widths (DINOv2-S:
256 patches x 384; SuperPoint: 784 patches x 256, through the scorer's
chunk-and-pad wrapper), 32 images and 32,768 rays, through the fused scorer
(B1/B2) and the plain one, with and without a NaN image; what one batched
forward launches and counts; and the pose request's one-image path, bit for
bit and launch for launch as it was.

Imports torch and sixdgs_torch only, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_batched_step.py -q -s

Every test is marked ``cuda`` and skips without a CUDA device.
"""

import functools

import pytest
import torch

from sixdgs_torch.pose import dino
from sixdgs_torch.pose import loss as tloss
from sixdgs_torch.pose import trainer as ttr
from sixdgs_torch.pose.evaluate import eval_image
from sixdgs_torch.utils import profiling
import per_image_loss as pil  # tests/per_image_loss.py
from torch_threads import shared_cores  # noqa: F401 (an autouse fixture)

pytestmark = pytest.mark.cuda

# launch API calls, as benchmark/tracing.py counts them
LAUNCH_NAMES = ("LaunchKernel", "GraphLaunch", "cuLaunch", "LaunchCooperativeKernel")
# float32 on both sides, summed in other orders: cuBLAS splits reductions of
# up to 18,432 terms (the camera-up convs' weight gradients over 32 images)
# otherwise for the batch's shapes than for one image's, and a sum of K
# float32 terms rounds by about sqrt(K) 2^-24 ~ 8e-6 of its terms
CARD_RTOL = 1e-5


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


def _counters():
    return dict(profiling.snapshot()["counters"])


def _launches(fn) -> int:
    """Kernel launch calls the host makes in ``fn()``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(any(k in ev.name for k in LAUNCH_NAMES) for ev in prof.events())


@pytest.mark.parametrize("nan_image", [False, True])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("shape", ["dino", "superpoint"])
def test_matches_per_image_loop(shape, fused, nan_image):
    """Loss, aux and every gradient of the batched step within CARD_RTOL of
    the per-image loop's, NaN where the loop has NaN; one batched forward
    counts its 32 images and launches B1 and B2 once an image (four times
    an image at 784 patches).

    At these widths a few of the camera-up head's millions of ReLU inputs
    lie within rounding of 0, and the two orders of summation can put them
    on either side: a gradient with a kink there is no rounding apart. So
    the loop gates each image's ReLUs as the batch does, and each ReLU the
    two forwards gate otherwise must have its input within CARD_RTOL of the
    layer's largest."""
    _cuda()
    idm, fbatch, rays, up = pil.random_step(pil.FULL[shape], nan_image, device="cuda")
    batched = pil.head_preactivations(idm.cam_up, fbatch.fmap)
    one = [torch.cat(p) for p in zip(*(pil.head_preactivations(idm.cam_up, fbatch.fmap[b:b + 1])
                                       for b in range(fbatch.fmap.shape[0])))]
    for layer, (pb, po) in enumerate(zip(batched, one)):
        flips = (pb > 0) != (po > 0)
        print(f"\n{shape} ReLU {layer}: {int(flips.sum())} gated otherwise, largest gap "
              f"{(pb - po).abs().max().item():.3e} of {po.abs().max().item():.3e}")
        assert (po[flips].abs() <= CARD_RTOL * po.abs().max()).all()
    masks = [p > 0 for p in batched]
    loop = functools.partial(pil.batch_loss_per_image, relu_masks=masks)
    want = pil.loss_and_grads(loop, idm, fbatch, rays, up, fused)
    before = _counters()
    got = pil.loss_and_grads(ttr.batch_loss_cached, idm, fbatch, rays, up, fused)
    after = _counters()
    worst = pil.gaps(got, want)
    print(f"\n{shape} fused={fused} nan={nan_image}: largest gap "
          f"{max(worst.values()):.3e} ({max(worst, key=worst.get)})")
    b = fbatch.c2w.shape[0]
    per_call = 4 if shape == "superpoint" else 1
    moved = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("train.batched_images", "kernel.b1", "kernel.b2")}
    assert moved == {"train.batched_images": b, "kernel.b1": b * per_call * fused,
                     "kernel.b2": b * per_call * fused}
    assert got[0]["n_nan"] == want[0]["n_nan"] == int(nan_image)
    assert pil.nan_entries_match(got, want)
    assert max(worst.values()) <= CARD_RTOL, worst


@pytest.mark.parametrize("shape", ["dino", "superpoint"])
def test_one_image_forms_bitwise_as_before(shape):
    """At the published widths, one image's target, score loss, camera-up
    head and camera-up loss as they were; the batch's loss rows within
    CARD_RTOL of the one-image calls."""
    _cuda()
    idm, fbatch, rays, up = pil.random_step(pil.FULL[shape], nan_image=False, device="cuda")
    n = fbatch.patch_mask.sum(-1, dtype=torch.int32)
    scores = torch.rand(fbatch.c2w.shape[0], rays.valid.shape[0], device="cuda")
    losses, targets = tloss.distance_score_loss(scores, fbatch.c2w, rays.ori, rays.dir,
                                                rays.valid, n)
    with torch.no_grad():
        for b in range(4):
            args = (fbatch.c2w[b], rays.ori, rays.dir, rays.valid, n[b])
            for new, old in zip(tloss.target_ray_scores(*args), pil.target_ray_scores(*args)):
                assert torch.equal(new, old)
            loss, target = tloss.distance_score_loss(scores[b], *args)
            old_loss, old_target = pil.distance_score_loss_one(scores[b], *args)
            assert torch.equal(loss, old_loss) and torch.equal(target, old_target)
            # a row of the batch's sums over rays against one image's sum
            torch.testing.assert_close(losses[b], loss, rtol=CARD_RTOL, atol=0.0)
            torch.testing.assert_close(targets[b], target, rtol=CARD_RTOL, atol=0.0)
            head = idm.cam_up(fbatch.fmap[b])
            assert torch.equal(head, pil.cam_up_head_one(idm.cam_up, fbatch.fmap[b]))
            assert torch.equal(tloss.cam_up_loss(up, head), pil.cam_up_loss_one(up, head))


def test_eval_image_bitwise_and_launches_as_before(monkeypatch):
    """The pose request (ViT-S/14 graph, fused B1, solve) at full width:
    the same outputs, bit for bit, and the same kernel launches as with the
    one-image forms the request ran before."""
    _cuda()
    idm, fbatch, rays, up = pil.random_step(pil.FULL["dino"], nan_image=False, device="cuda")
    model = dino.init_params(torch.Generator().manual_seed(0), embed_dim=384, depth=12,
                             device="cuda").eval()
    g = torch.Generator().manual_seed(1)
    img = torch.rand(308, 462, 3, generator=g).cuda()
    mask = (torch.rand(308, 462, generator=g) > 0.4).cuda()

    def request():
        return eval_image(model, idm, img, mask, fbatch.c2w[0], rays, k=100,
                          fused_attention=True)

    request()  # captures the ViT's graph
    now, n_now = request(), _launches(request)
    pil.as_before(monkeypatch)
    before, n_before = request(), _launches(request)
    print(f"\neval_image: {n_now} launches now, {n_before} before")
    assert n_now == n_before
    assert now.keys() == before.keys()
    for k in now:
        assert torch.equal(now[k], before[k]), k
