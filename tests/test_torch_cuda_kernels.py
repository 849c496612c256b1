"""The port's CUDA kernels against their plain PyTorch versions, on a card:
B1 and B2 (attention scores, at DINO's shape and, chunked and padded, at
SuperPoint's), B5 (aligned-layout gather), B3 (tile compositor, with and
without the transmittance store) and B4 (its backward, replaying and
stored), a training step on the card against the same step on the CPU,
and ``rasterize_tiled`` (plain PyTorch) on the card against the CPU.

Imports torch and sixdgs_torch only, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Each test carries the ``cuda`` marker (registered in pyproject.toml) and
skips without a CUDA device; nvcc builds the kernels at first use. The
JAX parity of the plain versions is in tests/test_torch_*.py.
"""

import numpy as np
import pytest
import torch

from sixdgs_torch.ops import attention_kernel as tak
from sixdgs_torch.ops.rasterizer import pallas_tiles as tpt
from sixdgs_torch.utils import profiling
from align_layouts import ALIGN_LAYOUTS, align_layout  # tests/align_layouts.py
from torch_threads import shared_cores  # noqa: F401 (an autouse fixture)


def _launches(kernel):
    """Launches of ``kernel`` (b1-b5, b3_store) counted so far on CUDA tensors."""
    return profiling.snapshot()["counters"].get("kernel." + kernel, 0)


def _b1_inputs(seed, P=256, d=384, N=5000, n_invalid=700):
    rng = np.random.default_rng(seed)
    arrs = (
        rng.normal(size=(P, d)),
        rng.normal(size=(N, d)),
        rng.normal(size=(d, d)) * 0.05,
        rng.normal(size=(d,)) * 0.1,
        (rng.uniform(size=P) > 0.3),
        np.r_[np.ones(N - n_invalid), np.zeros(n_invalid)],
    )
    return [torch.tensor(a, dtype=torch.float32, device="cuda") for a in arrs]


@pytest.mark.cuda
class TestAttentionScoresKernel:
    # both take the reassociated order and round at the same points; the
    # kernel sums the logits over 16-wide mma k-steps of bf16 pieces (split3
    # drops the lo.lo products, ~2^-18 relative) and the softmax over its
    # CTAs' partials, cuBLAS in its own order; in bf16 a q'' computed in
    # another order can round apart
    @staticmethod
    def _check(ins, mode, tol, launches=1):
        before = _launches("b1")
        s, m, ss = tak.attention_scores_fwd(*ins, mode=mode)
        torch.cuda.synchronize()
        assert _launches("b1") == before + launches
        rs, rm, rss = tak.attention_scores_plain(*ins, mode=mode)
        scale = rs.abs().max().item()
        assert (s - rs).abs().max().item() <= tol * scale
        assert (m - rm).abs().max().item() <= 100 * tol * rm.abs().max().item()
        assert ((ss - rss).abs() / rss).max().item() <= 100 * tol
        assert (s[-700:] == 0).all()  # the invalid tail scores exactly zero
        return s, m, ss

    @pytest.mark.parametrize("mode,tol", [("f32", 1e-5), ("bf16_split3", 1e-5),
                                          ("bf16", 1e-3)])
    @pytest.mark.parametrize("N", [5000, 32768])
    def test_kernel_matches_plain(self, mode, tol, N):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA GPU and nvcc")
        # N=5000 is ragged (not a multiple of the kernel's 64-ray block);
        # N=32768 is the default ray budget. Partial patch mask, padded tail
        # of invalid rays
        self._check(_b1_inputs(seed=3, N=N), mode, tol)

    def test_largest_ray_count_split3(self):
        """N = 131,072 (four times the default budget) in the default mode:
        the longest per-CTA runs of ray blocks."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA GPU and nvcc")
        self._check(_b1_inputs(seed=12, N=131072), "bf16_split3", 1e-5)

    @pytest.mark.parametrize("mode", ["f32", "bf16", "bf16_split3"])
    def test_second_launch_is_bitwise_equal(self, mode):
        """No float atomics: every cross-CTA and cross-warp sum runs in a
        fixed order."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA GPU and nvcc")
        ins = _b1_inputs(seed=13, N=5000)
        first = tak.attention_scores_fwd(*ins, mode=mode)
        again = tak.attention_scores_fwd(*ins, mode=mode)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))

    def test_all_invalid_rays_keep_the_neg_sentinel(self):
        """With every ray invalid each patch spreads uniformly over the rays
        (NEG = -9e15, not -inf), as in the plain version."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA GPU and nvcc")
        q, feats, wk, bk, pmask, valid = _b1_inputs(seed=5, N=1000, n_invalid=1000)
        s, m, _ = tak.attention_scores_fwd(q, feats, wk, bk, pmask, valid, mode="f32")
        torch.cuda.synchronize()
        torch.testing.assert_close(s, torch.full_like(s, pmask.sum().item() / 1000),
                                   rtol=1e-5, atol=0.0)
        assert (m == tak.NEG).all()

    def test_refuses_shapes_it_does_not_take(self):
        """Any patch count and any width up to the compiled 384 are taken
        (the wrapper pads and chunks); a wider one is refused."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA GPU and nvcc")
        q, feats, wk, bk, pmask, valid = _b1_inputs(seed=4, N=64, n_invalid=0, d=400)
        with pytest.raises(ValueError, match="d <= 384"):
            tak.attention_scores_fused(q, feats, wk, bk, pmask, valid)

    @pytest.mark.parametrize("mode,tol", [("f32", 1e-5), ("bf16_split3", 1e-5),
                                          ("bf16", 1e-3)])
    def test_superpoint_shape(self, mode, tol):
        """P = 784 patches of width 256 (SuperPoint's 28 x 28 grid): four
        launches of 256 patches on the width zero-padded to 384, against
        the plain version at the true shape, under the DINO shape's limits;
        a second call bitwise equal."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA GPU and nvcc")
        ins = _b1_inputs(seed=14, P=784, d=256, N=32768)
        first = self._check(ins, mode, tol, launches=4)
        again = tak.attention_scores_fwd(*ins, mode=mode)
        assert first[1].shape == (784, 1)
        assert all(torch.equal(a, b) for a, b in zip(first, again))

    @pytest.mark.parametrize("mode", ["f32", "bf16", "bf16_split3"])
    def test_dino_shape_is_one_launch(self, mode):
        """At the compiled shape the wrapper launches once, on the inputs
        themselves: its outputs are bitwise those of one direct launch."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA GPU and nvcc")
        ins = _b1_inputs(seed=15, N=32768)
        pmask, valid = ins[4].float(), ins[5]
        before = _launches("b1")
        got = tak.attention_scores_fwd(*ins, mode=mode)
        assert _launches("b1") == before + 1
        direct = tak._launch_fwd(*ins[:4], pmask, valid, mode, 384 ** 0.5)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, direct))
        g = torch.randn(32768, device="cuda")
        before = _launches("b2")
        got = tak.attention_scores_bwd(*ins, got[1], got[2], g, mode=mode)
        assert _launches("b2") == before + 1
        direct = tak._launch_bwd(*ins[:4], pmask, valid, direct[1], direct[2], g, mode,
                                 384 ** 0.5)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, direct))


def _dbk_scale(ins, m, s, g):
    """max_col sum_j |dk_j|: dbk = sum_j dk_j is zero in exact arithmetic
    (a shift of every logit of a patch by q_p . bk leaves its softmax
    unchanged), so its rounding error is held against the size of the
    terms it sums."""
    q, feats, wk, bk, pmask, valid = ins
    d = q.shape[1]
    logits = q @ (feats @ wk + bk).T / d ** 0.5
    logits = torch.where(valid[None] > 0, logits, torch.full_like(logits, tak.NEG))
    probs = torch.exp(logits - m) / s
    c = (probs * g).sum(1, keepdim=True)
    dlog = pmask.float()[:, None] * probs * (g - c) / d ** 0.5
    return (dlog.T @ q).abs().sum(0).max().item()


def _b2_check(ins, mode, tol, seed, launches=1):
    """B2 against its plain version on the forward's residuals, each
    gradient within ``tol`` of its max |plain| (dbk: of _dbk_scale)."""
    g = torch.tensor(np.random.default_rng(seed).normal(size=ins[1].shape[0]),
                     dtype=torch.float32, device="cuda")
    _, m, s = tak.attention_scores_fwd(*ins, mode=mode)
    before = _launches("b2")
    out = tak.attention_scores_bwd(*ins, m, s, g, mode=mode)
    torch.cuda.synchronize()
    assert _launches("b2") == before + launches
    ref = tak.attention_scores_bwd_plain(*ins[:4], ins[4].float(), ins[5], m, s, g,
                                         mode=mode)
    for name, a, b in zip(("dq", "dfeats", "dwk", "dbk"), out, ref):
        assert a.shape == b.shape, name
        scale = _dbk_scale(ins, m, s, g) if name == "dbk" else b.abs().max().item()
        assert scale > 0, name
        assert (a - b).abs().max().item() <= tol * scale, name
    return out


@pytest.mark.cuda
class TestAttentionScoresBackwardKernel:
    # sums over up to 32k rays in another order than cuBLAS: f32-class modes
    # agree to ~1e-5 of the largest gradient; in bf16 a dlog or dk that
    # lands on a rounding boundary can round apart
    @pytest.mark.parametrize("mode,tol", [("f32", 1e-4), ("bf16_split3", 1e-4),
                                          ("bf16", 1e-2)])
    @pytest.mark.parametrize("N", [5000, 32768])
    def test_kernel_matches_plain(self, mode, tol, N):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA GPU and nvcc")
        # N=5000 is ragged; partial patch mask and a padded invalid tail,
        # whose rays get no dfeats
        ins = _b1_inputs(seed=6, N=N)
        dq, dfeats, dwk, dbk = _b2_check(ins, mode, tol, seed=7)
        assert (dfeats[-700:] == 0).all()

    def test_largest_ray_count_split3(self):
        """N = 131,072 (four times the default budget) in the default mode:
        the longest per-CTA runs of ray blocks and A partials."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA GPU and nvcc")
        ins = _b1_inputs(seed=10, N=131072, n_invalid=700)
        dq, dfeats, dwk, dbk = _b2_check(ins, "bf16_split3", 1e-4, seed=11)
        assert (dfeats[-700:] == 0).all()

    @pytest.mark.parametrize("mode", ["f32", "bf16_split3", "bf16"])
    def test_two_launches_are_bitwise_equal(self, mode):
        """Every cross-CTA sum is taken in a fixed order (no float atomics)."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA GPU and nvcc")
        ins = _b1_inputs(seed=12, N=32768)
        g = torch.tensor(np.random.default_rng(13).normal(size=32768), dtype=torch.float32,
                         device="cuda")
        _, m, s = tak.attention_scores_fwd(*ins, mode=mode)
        first = tak.attention_scores_bwd(*ins, m, s, g, mode=mode)
        second = tak.attention_scores_bwd(*ins, m, s, g, mode=mode)
        torch.cuda.synchronize()
        for name, a, b in zip(("dq", "dfeats", "dwk", "dbk"), first, second):
            assert torch.equal(a, b), name

    @pytest.mark.parametrize("mode,tol", [("f32", 1e-4), ("bf16_split3", 1e-4),
                                          ("bf16", 1e-2)])
    def test_superpoint_shape(self, mode, tol):
        """P = 784, d = 256: four launches, dq concatenated and dfeats, dWk,
        dbk summed over them, against the plain version at the true shape,
        under the DINO shape's limits; a second call bitwise equal."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA GPU and nvcc")
        ins = _b1_inputs(seed=16, P=784, d=256, N=32768)
        before = _launches("b2")
        first = _b2_check(ins, mode, tol, seed=17, launches=4)
        assert _launches("b2") == before + 4
        assert [tuple(t.shape) for t in first] == [(784, 256), (32768, 256), (256, 256),
                                                   (256,)]
        assert (first[1][-700:] == 0).all()
        _, m, s = tak.attention_scores_fwd(*ins, mode=mode)
        g = torch.tensor(np.random.default_rng(17).normal(size=32768), dtype=torch.float32,
                         device="cuda")
        again = tak.attention_scores_bwd(*ins, m, s, g, mode=mode)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))

    def test_all_invalid_rays_get_the_unmasked_gradient(self):
        """The TPU kernel does not mask dlog by validity: with every ray
        invalid each patch spreads 1/N over them, and dfeats is nonzero."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA GPU and nvcc")
        ins = _b1_inputs(seed=8, N=1000, n_invalid=1000)
        dq, dfeats, dwk, dbk = _b2_check(ins, "f32", 1e-4, seed=9)
        assert dfeats.abs().max().item() > 0


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")


def _layout(counts, nc=None, seed=0, P=100_000):
    """A sorted compact layout with per-tile ``counts`` on the card: gidx
    [nc], starts, starts_al (clamped to nc) as int32."""
    counts = np.asarray(counts, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)])
    if nc is None:
        nc = int(-(-(-(-counts // 128) * 128).sum() // 1024) * 1024) or 1024
    gidx = np.full(nc, P, np.int64)
    gidx[:min(starts[-1], nc)] = np.random.default_rng(seed).integers(
        0, P, min(starts[-1], nc))
    dev = torch.device("cuda")
    starts_t = torch.tensor(starts, dtype=torch.int32, device=dev)
    starts_al, _ = tpt._aligned_starts(starts_t, nc)
    return torch.tensor(gidx, dtype=torch.int32, device=dev), starts_t, starts_al


@pytest.mark.cuda
class TestAlignCompactKernel:
    """B5 equals its plain version exactly (int32 data movement), a second
    launch is bitwise equal, and the tail past the aligned total is all
    sentinel."""

    @pytest.mark.parametrize("case", ["ragged", "empty_tiles", "all_empty", "truncated",
                                      "full_1232x816", *ALIGN_LAYOUTS])
    def test_kernel_equals_plain(self, case):
        _need_card()
        rng = np.random.default_rng(1)
        if case in ALIGN_LAYOUTS:  # the layouts of the CPU parity test
            counts, nc = ALIGN_LAYOUTS[case]
            gidx, starts, starts_al = (torch.tensor(a, device="cuda")
                                       for a in align_layout(counts, nc, P=100_000))
        else:
            counts, nc = {
                "ragged": ([5, 0, 128, 129, 300, 0, 1, 127, 1000], None),
                "empty_tiles": (np.where(rng.uniform(size=300) < 0.5, 0,
                                         rng.integers(1, 400, 300)), None),
                "all_empty": ([0] * 64, 1024),
                # aligned demand 1408 > nc: trailing tiles are cut
                "truncated": ([100, 200, 300, 150, 90, 130], 1024),
                # the render path's layout: 77 x 51 tiles, ~119 pairs per tile
                "full_1232x816": (rng.poisson(119, 77 * 51), 1 << 20),
            }[case]
            gidx, starts, starts_al = _layout(counts, nc)
        n_tiles = len(counts)
        before = _launches("b5")
        got = tpt._align_compact(gidx, starts, starts_al, n_tiles, 100_000)
        again = tpt._align_compact(gidx, starts, starts_al, n_tiles, 100_000)
        torch.cuda.synchronize()
        assert _launches("b5") == before + 2
        want = tpt.align_compact_plain(gidx, starts, starts_al, n_tiles, 100_000)
        assert got.dtype == torch.int32 and got.shape == want.shape
        assert torch.equal(got, want)
        assert torch.equal(again, got)
        assert (got[int(starts_al[-1]):] == 100_000).all()

    def test_rejects_what_the_kernel_does_not_take(self):
        _need_card()
        gidx, starts, starts_al = _layout([5, 300], 1024)
        with pytest.raises(ValueError, match="multiple of 128"):
            tpt._align_compact(gidx[:1000], starts, starts_al, 2, 7)
        with pytest.raises(ValueError, match="16-byte aligned"):
            tpt._align_compact(torch.empty(1025, dtype=torch.int32, device="cuda")[1:],
                               starts, starts_al, 2, 7)


def _records(counts, nx, ny, seed=0, opacity=(0.1, 0.99)):
    """Aligned synthetic records [16, NC] on the card: per tile, pair means
    around the tile, conics 0.05-0.3, colors in [0, 1]."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts, np.int64)
    spans = -(-counts // 128) * 128
    starts = np.concatenate([[0], np.cumsum(spans)])
    nc = int(starts[-1]) + 128
    rec = np.zeros((16, nc), np.float32)
    t = np.repeat(np.arange(nx * ny), counts)
    idx = np.concatenate([np.arange(s, s + c) for s, c in zip(starts[:-1], counts)])
    n = idx.size
    rec[0, idx] = (t % nx) * 16 + rng.uniform(-4, 20, n)
    rec[1, idx] = (t // nx) * 16 + rng.uniform(-4, 20, n)
    rec[2, idx] = rng.uniform(0.05, 0.3, n)
    rec[3, idx] = rng.uniform(-0.05, 0.05, n)
    rec[4, idx] = rng.uniform(0.05, 0.3, n)
    rec[5:8, idx] = rng.uniform(0, 1, (3, n))
    rec[8, idx] = rng.uniform(*opacity, n)
    dev = torch.device("cuda")
    return (torch.tensor(rec, device=dev), torch.tensor(starts, dtype=torch.int32, device=dev),
            torch.tensor(counts, dtype=torch.int32, device=dev))


def _b3_close(got, want):
    """B3 against its plain version: both float32 on the card, but the kernel
    multiplies the transmittance serially where the
    plain version takes a cumulative product, so a pixel whose T (1 - alpha)
    lands within rounding of T_EPS = 1e-4 can stop one pair apart. Such a
    flip moves a channel by at most T_EPS alpha / (1 - alpha) |c - bg|
    <= 9.9e-3 here; everywhere else the two agree to ~1e-6. Flips are rare
    (about one pixel in a million), and a faulty tile moves 768 values, so
    at most one pixel's three values, or a share of 1e-5, may be off by
    more than 1e-4."""
    err = (got - want).abs()
    assert err.max().item() <= 2e-2
    assert (err > 1e-4).sum().item() <= max(3, 1e-5 * err.numel())


@pytest.mark.cuda
class TestCompositeKernel:
    @pytest.mark.parametrize("case", ["ragged", "empty_tiles", "deep_opaque",
                                      "deep_translucent", "full_1232x816"])
    def test_kernel_matches_plain(self, case):
        _need_card()
        rng = np.random.default_rng(2)
        nx, ny, counts, opacity = {
            "ragged": (5, 3, [1, 127, 128, 129, 300, 0, 7, 50, 260, 511, 2, 3, 900, 64, 65],
                       (0.1, 0.99)),
            "empty_tiles": (9, 7, np.where(rng.uniform(size=63) < 0.4, 0,
                                           rng.integers(1, 300, 63)), (0.1, 0.99)),
            # >= 2000 pairs per tile; opaque enough that tiles exit early
            "deep_opaque": (4, 4, rng.integers(2000, 2600, 16), (0.3, 0.99)),
            # translucent: every pixel walks most of its segment
            "deep_translucent": (4, 4, rng.integers(2000, 2600, 16), (0.001, 0.02)),
            "full_1232x816": (77, 51, rng.poisson(119, 77 * 51), (0.1, 0.99)),
        }[case]
        rec, starts, counts_t = _records(counts, nx, ny, opacity=opacity)
        bg = torch.tensor([0.1, 0.5, 0.9], device="cuda")
        before = _launches("b3")
        got = tpt.pallas_composite_fwd(rec, starts, counts_t, nx, ny, bg)
        torch.cuda.synchronize()
        assert _launches("b3") == before + 1
        want = tpt.composite_fwd_plain(rec, starts, counts_t, nx, ny, bg)
        assert got.shape == (nx * ny, 256, 3) and torch.isfinite(got).all()
        _b3_close(got, want)
        empty = counts_t == 0
        if empty.any():  # empty tiles are pure background
            assert torch.equal(got[empty], bg.expand(int(empty.sum()), 256, 3))

    def test_render_on_card_matches_cpu_and_refuses_grad(self):
        """rasterize_pallas through B5 and B3 on the card against the same
        call on the CPU (plain versions), a ragged 50x35 image."""
        _need_card()
        from sixdgs_torch.ops.rasterizer.projection import ProjectedGaussians

        rng = np.random.default_rng(3)
        n, W, H = 400, 50, 35
        fields = dict(
            means2d=rng.uniform([-5, -5], [W + 5, H + 5], size=(n, 2)),
            depths=rng.uniform(1, 5, n),
            conics=np.stack([rng.uniform(0.05, 0.4, n), rng.uniform(-0.02, 0.02, n),
                             rng.uniform(0.05, 0.4, n)], 1),
            radii=np.full(n, 12),
            colors=rng.uniform(0, 1, (n, 3)),
            opacities=rng.uniform(0.05, 0.9, n))
        proj = {d: ProjectedGaussians(**{
            k: torch.tensor(v, dtype=torch.int32 if k == "radii" else torch.float32,
                            device=d) for k, v in fields.items()}) for d in ("cpu", "cuda")}
        bg = torch.tensor([0.2, 0.3, 0.4])
        b3, b5 = _launches("b3"), _launches("b5")
        got = tpt.rasterize_pallas(proj["cuda"], W, H, bg.cuda(), t_max=64)
        torch.cuda.synchronize()
        assert (_launches("b3"), _launches("b5")) == (b3 + 1,
                                                                                    b5 + 1)
        want = tpt.rasterize_pallas(proj["cpu"], W, H, bg, t_max=64)
        assert got.shape == (3, H, W)
        _b3_close(got.cpu(), want)
        # gradients through B3 (store) and B4 against the plain versions
        grads = {}
        b3s, b4 = _launches("b3_store"), _launches("b4")
        for d in ("cpu", "cuda"):
            leaves = [getattr(proj[d], f).clone().requires_grad_()
                      for f in ("means2d", "conics", "colors", "opacities")]
            p = proj[d]._replace(means2d=leaves[0], conics=leaves[1], colors=leaves[2],
                                 opacities=leaves[3])
            img = tpt.rasterize_pallas(p, W, H, bg.to(d), t_max=64)
            grads[d] = torch.autograd.grad(img.square().sum(), leaves)
        torch.cuda.synchronize()
        assert (_launches("b3_store"), _launches("b4")) == (
            b3s + 1, b4 + 1)
        for g, w in zip(grads["cuda"], grads["cpu"]):
            assert torch.isfinite(g).all()
            # float32 sums in another order; a stop that flips moves one pair
            assert (g.cpu() - w).abs().max() <= 1e-3 * w.abs().max()


@pytest.mark.cuda
class TestCompositeBackwardKernel:
    CASES = {
        "ragged": (5, 3, [1, 127, 128, 129, 300, 0, 7, 50, 260, 511, 2, 3, 900, 64, 65],
                   (0.1, 0.99)),
        "deep_opaque": (4, 4, "deep", (0.3, 0.99)),
        "deep_translucent": (4, 4, "deep", (0.001, 0.02)),
        "full_1232x816": (77, 51, "full", (0.1, 0.99)),
    }

    @staticmethod
    def _inputs(case):
        rng = np.random.default_rng(4)
        nx, ny, counts, opacity = TestCompositeBackwardKernel.CASES[case]
        if counts == "deep":
            counts = rng.integers(2000, 2600, nx * ny)
        elif counts == "full":
            counts = rng.poisson(119, nx * ny)
        rec, starts, counts_t = _records(counts, nx, ny, opacity=opacity)
        bg = torch.tensor([0.1, 0.5, 0.9], device="cuda")
        return rec, starts, counts_t, nx, ny, bg

    @pytest.mark.parametrize("case", list(CASES))
    def test_store_keeps_out_and_matches_plain(self, case):
        """B3 with the store: ``out`` bitwise equal to the call without it,
        and the stored transmittance equal to the plain version's on every
        lane a pixel reaches (1e-5 relative: a serial product against a
        cumulative one)."""
        _need_card()
        rec, starts, counts, nx, ny, bg = self._inputs(case)
        before = _launches("b3_store")
        out, tex = tpt.pallas_composite_fwd(rec, starts, counts, nx, ny, bg, store_t=True)
        torch.cuda.synchronize()
        assert _launches("b3_store") == before + 1
        assert torch.equal(out, tpt.pallas_composite_fwd(rec, starts, counts, nx, ny, bg))
        assert tex.shape == (rec.shape[1] // 128, 256, 128)
        walk = tpt._SegmentWalk(rec, starts, counts, nx, ny)
        for k, c in enumerate(walk):
            got = tex[walk.starts[c.act] // 128 + k]
            err = torch.where(c.reached, (got - c.texcl).abs() / c.texcl.clamp_min(1e-4),
                              torch.zeros((), device="cuda"))
            assert err.max().item() <= 1e-5

    @pytest.mark.parametrize("case", list(CASES))
    def test_kernel_matches_plain_and_is_deterministic(self, case):
        """B4 replay against its plain version on the kernel's own forward
        output: each gradient row within 1e-4 of the row's largest
        magnitude, with at most a 1e-5 share of the real lanes off by more
        than 1e-5 of it (float32 sums in another order; a stop that flips at
        T_EPS moves one pair's gradient, one faulty tile moves hundreds).
        Stored against replay and a second launch: bitwise."""
        _need_card()
        rec, starts, counts, nx, ny, bg = self._inputs(case)
        out, tex = tpt.pallas_composite_fwd(rec, starts, counts, nx, ny, bg, store_t=True)
        dout = torch.randn(out.shape, generator=torch.Generator("cuda").manual_seed(0),
                           device="cuda")
        before = _launches("b4")
        replay = tpt.pallas_composite_bwd(rec, starts, counts, nx, ny, out, dout)
        stored = tpt.pallas_composite_bwd(rec, starts, counts, nx, ny, out, dout,
                                          aligned=True, texcl=tex)
        again = tpt.pallas_composite_bwd(rec, starts, counts, nx, ny, out, dout)
        torch.cuda.synchronize()
        assert _launches("b4") == before + 3
        assert torch.equal(replay, stored) and torch.equal(replay, again)
        want = tpt.composite_bwd_plain(rec, starts, counts, nx, ny, out, dout)
        assert torch.isfinite(replay).all() and not replay[9:].any()
        scale = want.abs().amax(dim=1, keepdim=True).clamp_min(1e-12)
        err = (replay - want).abs() / scale
        assert err[:9].max().item() <= 1e-4
        assert (err[:9] > 1e-5).float().mean().item() <= 1e-5

    def test_train_step_on_card_matches_cpu(self):
        """One ``train_step`` through B5, B3 (store) and B4 on the card
        against the same step on the CPU (plain versions): losses to 1e-5
        relative, Adam's first moments (0.1 of the gradient) to 1e-3 of
        their largest magnitude."""
        _need_card()
        from sixdgs_torch.scene.cameras import make_synthetic_camera
        from sixdgs_torch.scene.gaussians import from_arrays
        from sixdgs_torch.train import gs_trainer as gs
        from sixdgs_torch.utils.config import OptimizationConfig

        rng = np.random.default_rng(5)
        n, W, H = 300, 50, 35
        arrays = {
            "xyz": (rng.normal(size=(n, 3)) * [1.0, 0.8, 0.6] + [0, 0, 4]).astype(np.float32),
            "features_dc": (rng.normal(size=(n, 1, 3)) * 0.5).astype(np.float32),
            "features_rest": (rng.normal(size=(n, 15, 3)) * 0.1).astype(np.float32),
            "opacity": rng.uniform(-2.0, 3.0, size=(n, 1)).astype(np.float32),
            "scaling": rng.uniform(-3.5, -2.0, size=(n, 3)).astype(np.float32),
            "rotation": rng.normal(size=(n, 4)).astype(np.float32),
        }
        cam = make_synthetic_camera(W, H, 0.9, 0.7, np.eye(3), np.zeros(3),
                                    image=rng.uniform(size=(3, H, W)).astype(np.float32))
        lrs = gs.lr_dict(OptimizationConfig(), 4.0, 1)
        res = {}
        kernels = ("b5", "b4", "b3_store")
        before = [_launches(k) for k in kernels]
        for d in ("cpu", "cuda"):
            state = gs.init_train_state(from_arrays(arrays, 3, capacity=512, device=d))
            res[d] = gs.train_step(state, gs.camera_arrays(cam, d, with_image=True),
                                   torch.full((3,), 0.2, device=d), lrs, width=W, height=H,
                                   sh_degree=3)
        torch.cuda.synchronize()
        after = [_launches(k) for k in kernels]
        assert after == [b + 1 for b in before]
        (cs, cm), (gs_state, gm) = res["cpu"], res["cuda"]
        assert set(cm) == set(gm) and int(gm["binning_grad_dropped"]) == 0
        for k in ("loss", "l1", "psnr"):
            assert abs(float(gm[k]) - float(cm[k])) <= 1e-5 * abs(float(cm[k]))
        for k in cs.adam.m:
            w = cs.adam.m[k]
            assert (gs_state.adam.m[k].cpu() - w).abs().max() <= 1e-3 * w.abs().max(), k
        assert torch.equal(gs_state.denom.cpu(), cs.denom)
        assert torch.equal(gs_state.max_radii2d.cpu(), cs.max_radii2d)


def _design_case(case, seed=6, dev="cuda"):
    """The compositor's design cases on the card: (records [16, NC], starts,
    counts, nx, ny).

    far_means: means up to 40 px from the tile origin, wide footprints;
    all_contribute: translucent splats over the whole tile, every pixel
    contributing to every pair (the backward's reduce at full load);
    half_stopped: two passes of opaque one-row splats over the tile's top
    half first, so its pixels stop early and the bottom half walks on;
    packed: segments starting anywhere (not at multiples of 4) in an odd
    NC, the unaligned layout."""
    rng = np.random.default_rng(seed)
    nx = ny = 3 if case == "packed" else 4
    n_tiles = nx * ny
    counts = rng.integers(150, 400, n_tiles)
    if case == "packed":
        counts[[1, 4]] = [0, 3]
        gaps = rng.integers(1, 6, n_tiles)
        starts = 3 + np.concatenate([[0], np.cumsum(counts + gaps)])
        nc = int(starts[-1]) | 1
    else:
        starts = np.concatenate([[0], np.cumsum(-(-counts // 128) * 128)])
        nc = int(starts[-1]) + 128
    rec = np.zeros((16, nc), np.float32)
    t = np.repeat(np.arange(n_tiles), counts)
    idx = np.concatenate([np.arange(s, s + c) for s, c in zip(starts[:-1], counts)])
    n = idx.size
    ox, oy = (t % nx) * 16.0, (t // nx) * 16.0
    A, C = rng.uniform(0.05, 0.3, n), rng.uniform(0.05, 0.3, n)
    x, y = ox + rng.uniform(-4, 20, n), oy + rng.uniform(-4, 20, n)
    opac = rng.uniform(0.1, 0.99, n)
    if case == "far_means":
        x, y = ox + rng.uniform(-40, 40, n), oy + rng.uniform(-40, 40, n)
        A, C = rng.uniform(0.002, 0.02, n), rng.uniform(0.002, 0.02, n)
        opac = rng.uniform(0.05, 0.6, n)
    elif case == "all_contribute":
        x, y = ox + 8 + rng.uniform(-2, 2, n), oy + 8 + rng.uniform(-2, 2, n)
        A, C = rng.uniform(0.001, 0.003, n), rng.uniform(0.001, 0.003, n)
        opac = rng.uniform(0.008, 0.02, n)
    B = rng.uniform(-0.5, 0.5, n) * np.sqrt(A * C)
    if case == "half_stopped":
        # the first 16 pairs of each segment: rows 0-7, twice, opaque; the
        # rest translucent
        opac = rng.uniform(0.02, 0.1, n)
        k = np.concatenate([np.arange(c) for c in counts])
        row = k < 16
        x[row], y[row] = ox[row] + 8, oy[row] + k[row] % 8
        A[row], B[row], C[row], opac[row] = 1e-4, 0.0, 2.0, 1.0
    rec[0, idx], rec[1, idx] = x, y
    rec[2, idx], rec[3, idx], rec[4, idx] = A, B, C
    rec[5:8, idx] = rng.uniform(0, 1, (3, n))
    rec[8, idx] = opac
    return (torch.tensor(rec, device=dev), torch.tensor(starts, dtype=torch.int32, device=dev),
            torch.tensor(counts, dtype=torch.int32, device=dev), nx, ny)


def _b4_close(got, want):
    """B4 against its plain version, as in TestCompositeBackwardKernel: each
    gradient row within 1e-4 of its largest magnitude, at most a 1e-5 share
    of the lanes off by more than 1e-5 of it."""
    assert torch.isfinite(got).all() and not got[9:].any()
    scale = want.abs().amax(dim=1, keepdim=True).clamp_min(1e-12)
    err = (got - want).abs() / scale
    assert err[:9].max().item() <= 1e-4
    assert (err[:9] > 1e-5).float().mean().item() <= 1e-5


@pytest.mark.cuda
class TestCompositeDesignCases:
    """B3 (both store modes) and B4 (both modes) on the cases that the
    staged, several-pixels-per-thread walk and B4's two-phase reduce must
    get right, at the tolerances of the tests above."""

    @pytest.mark.parametrize("case", ["far_means", "all_contribute", "half_stopped"])
    def test_forward_both_modes(self, case):
        _need_card()
        rec, starts, counts, nx, ny = _design_case(case)
        bg = torch.tensor([0.1, 0.5, 0.9], device="cuda")
        got = tpt.pallas_composite_fwd(rec, starts, counts, nx, ny, bg)
        out, tex = tpt.pallas_composite_fwd(rec, starts, counts, nx, ny, bg, store_t=True)
        torch.cuda.synchronize()
        assert torch.equal(out, got)
        want, (evals, contribs) = tpt.composite_fwd_plain(rec, starts, counts, nx, ny, bg,
                                                          return_work=True)
        _b3_close(got, want)
        if case == "all_contribute":  # no pixel stops, every pixel takes every pair
            assert evals == contribs == 256 * int(counts.sum())
        walk = tpt._SegmentWalk(rec, starts, counts, nx, ny)
        for k, c in enumerate(walk):
            g = tex[walk.starts[c.act] // 128 + k]
            err = torch.where(c.reached, (g - c.texcl).abs() / c.texcl.clamp_min(1e-4),
                              torch.zeros((), device="cuda"))
            assert err.max().item() <= 1e-5
        if case == "half_stopped":  # the top half stopped, the bottom half did not
            assert bool(walk.done[:, :128].all()) and not walk.done[:, 128:].any()

    @pytest.mark.parametrize("case", ["far_means", "all_contribute", "half_stopped"])
    def test_backward_both_modes(self, case):
        _need_card()
        rec, starts, counts, nx, ny = _design_case(case)
        bg = torch.tensor([0.1, 0.5, 0.9], device="cuda")
        out, tex = tpt.pallas_composite_fwd(rec, starts, counts, nx, ny, bg, store_t=True)
        dout = torch.randn(out.shape, generator=torch.Generator("cuda").manual_seed(1),
                           device="cuda")
        replay = tpt.pallas_composite_bwd(rec, starts, counts, nx, ny, out, dout)
        stored = tpt.pallas_composite_bwd(rec, starts, counts, nx, ny, out, dout,
                                          aligned=True, texcl=tex)
        again = tpt.pallas_composite_bwd(rec, starts, counts, nx, ny, out, dout, aligned=True,
                                         texcl=tex)
        torch.cuda.synchronize()
        assert torch.equal(replay, stored) and torch.equal(stored, again)
        _b4_close(replay, tpt.composite_bwd_plain(rec, starts, counts, nx, ny, out, dout))

    def test_packed_layout(self):
        """Segments that start anywhere in an odd NC: B3 without the store
        and B4 replaying against their plain versions, a second launch
        bitwise equal; the stored modes refuse the layout."""
        _need_card()
        rec, starts, counts, nx, ny = _design_case("packed")
        assert rec.shape[1] % 2 == 1 and bool((starts[:-1] % 4 != 0).any())
        bg = torch.tensor([0.1, 0.5, 0.9], device="cuda")
        out = tpt.pallas_composite_fwd(rec, starts, counts, nx, ny, bg)
        torch.cuda.synchronize()
        _b3_close(out, tpt.composite_fwd_plain(rec, starts, counts, nx, ny, bg))
        dout = torch.randn(out.shape, generator=torch.Generator("cuda").manual_seed(2),
                           device="cuda")
        got = tpt.pallas_composite_bwd(rec, starts, counts, nx, ny, out, dout)
        again = tpt.pallas_composite_bwd(rec, starts, counts, nx, ny, out, dout)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        want = tpt.composite_bwd_plain(rec, starts, counts, nx, ny, out, dout)
        _b4_close(got, want)
        lane = torch.arange(rec.shape[1], device="cuda")
        walked = ((lane[None] >= starts[:-1, None].long())
                  & (lane[None] < (starts[:-1] + counts).long()[:, None])).any(0)
        assert not got[:, ~walked].any()  # lanes between segments stay zero
        with pytest.raises(ValueError):
            tpt.pallas_composite_fwd(rec, starts, counts, nx, ny, bg, store_t=True)
        with pytest.raises(ValueError):
            tpt.pallas_composite_bwd(rec, starts, counts, nx, ny, out, dout,
                                     texcl=torch.zeros(rec.shape[1] // 128, 256, 128,
                                                       device="cuda"))


@pytest.mark.cuda
class TestTiledOnCard:
    def test_rasterize_tiled_matches_cpu(self):
        """rasterize_tiled (plain PyTorch, no kernel) on the card against
        the same call on the CPU, forward and the gradients of every
        differentiable field, with every tier and the k_max cap in use:
        the same float32 arithmetic in the same slot order, so the image to
        1e-5 and each gradient to 1e-4 of its largest magnitude (the
        backward's sums run in other orders)."""
        _need_card()
        from sixdgs_torch.ops.rasterizer import projection as tproj
        from sixdgs_torch.ops.rasterizer import tiles as ttiles

        rng = np.random.default_rng(20)
        n, W, H = 600, 150, 100
        fields = dict(
            means2d=rng.uniform([-10, -10], [W + 10, H + 10], size=(n, 2)),
            depths=rng.uniform(1, 5, n),
            conics=np.stack([rng.uniform(0.002, 0.05, n), rng.uniform(-0.001, 0.001, n),
                             rng.uniform(0.002, 0.05, n)], 1),
            radii=rng.integers(3, 80, n), colors=rng.uniform(0, 1, (n, 3)),
            opacities=rng.uniform(0.1, 0.9, n))
        kw = dict(t_max=4, mid_k=32, t_max_mid=16, overflow_k=8, t_max_big=64, k_max=96)
        grads, imgs = {}, {}
        for d in ("cpu", "cuda"):
            leaves = {k: torch.tensor(v, dtype=torch.int32 if k == "radii" else torch.float32,
                                      device=d) for k, v in fields.items()}
            for k in ("means2d", "conics", "colors", "opacities"):
                leaves[k].requires_grad_()
            img = ttiles.rasterize_tiled(tproj.ProjectedGaussians(**leaves), W, H,
                                         torch.full((3,), 0.3, device=d), **kw)
            w = torch.tensor(np.random.default_rng(21).normal(size=(3, H, W)),
                             dtype=torch.float32, device=d)
            torch.sum(img * w).backward()
            imgs[d] = img.detach().cpu()
            grads[d] = {k: leaves[k].grad.cpu() for k in
                        ("means2d", "conics", "colors", "opacities")}
        assert (imgs["cpu"] - imgs["cuda"]).abs().max() <= 1e-5
        for k, want in grads["cpu"].items():
            scale = want.abs().max()
            assert scale > 0 and (grads["cuda"][k] - want).abs().max() <= 1e-4 * scale, k
