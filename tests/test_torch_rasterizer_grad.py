"""The gradient path of sixdgs_torch's tile rasterizer against sixdgs_tpu's,
on the CPU.

The same numpy inputs go through the JAX function and its port: the
transmittance store of the compositor's forward (B3, store_t), the
compositor's backward (B4) in its replay and stored modes against the
Pallas kernel in interpret mode, the pair-gather and permute backwards, and
the gradients of ``rasterize_pallas`` end to end. On CPU tensors the port's
wrappers run their plain versions; the CUDA kernels are held against those
on a card in tests/test_torch_cuda_kernels.py.

Tolerances: the Pallas backward takes its transmittance, its gradient
prefixes and its pixel moments through bf16-split products on the matrix
unit (~2^-16 = 1.5e-5 relative to the terms summed), the port's plain
version through float32 cumulative products and sums. End-to-end gradients
of a mean loss are held at rtol 2e-3 / atol 5e-5, the JAX package's own
bound for its kernels against autograd through the golden model. The raw
per-pair gradients under a unit-normal cotangent are sums of 256 pixel
terms that largely cancel, so their absolute error follows the size of the
terms, not of the sum: they are held at rtol 2e-3 plus 1e-4 of the row's
largest magnitude (measured: up to 8e-5 of it against the Pallas kernel,
1e-6 against autograd through the port's forward).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sixdgs_tpu.ops.rasterizer import pallas_tiles as jpt
from sixdgs_tpu.ops.rasterizer import projection as jproj
from sixdgs_tpu.ops.rasterizer import tiles as jtiles
from sixdgs_tpu.ops.transforms import build_covariance as jbuild_covariance
from sixdgs_tpu.scene.cameras import make_synthetic_camera
from sixdgs_torch.ops.rasterizer import compositing as tcomp
from sixdgs_torch.ops.rasterizer import pallas_tiles as tpt
from sixdgs_torch.ops.rasterizer import projection as tproj
from sixdgs_torch.ops.rasterizer import tiles as ttiles
from sixdgs_torch.ops.transforms import build_covariance as tbuild_covariance
from sixdgs_torch.utils import profiling
from torch_threads import shared_cores  # noqa: F401 (an autouse fixture)


def _launches(kernel):
    """Launches of ``kernel`` (b1-b5, b3_store) counted so far on CUDA tensors."""
    return profiling.snapshot()["counters"].get("kernel." + kernel, 0)


GRAD_TOL = dict(rtol=2e-3, atol=5e-5)
NX, NY = 3, 2


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _records_case(counts, seed=0, aligned=True, opaque=None):
    """Synthetic records [16, NC] over a 3x2 tile grid (the case of
    tests/test_pallas_rasterizer.py::TestStoredTransmittanceBackward): per
    tile, pair means around the tile, conics 0.05-0.3, colors and opacities
    uniform. ``opaque``: (start, length) of a near-opaque run that makes a
    tile exit early. Returns (records, starts, counts, real-lane mask)."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts, np.int32)
    spans = [-(-int(c) // 128) * 128 if aligned else int(c) for c in counts]
    starts = np.zeros(NX * NY + 1, np.int32)
    starts[1:] = np.cumsum(spans)
    nc = -(-int(starts[-1]) // 128) * 128 + 128
    rec = np.zeros((16, nc), np.float32)
    mask = np.zeros(nc, bool)
    for t in range(NX * NY):
        s, c = starts[t], int(counts[t])
        ox, oy = (t % NX) * 16, (t // NX) * 16
        rec[0, s:s + c] = rng.uniform(ox - 4, ox + 20, c)
        rec[1, s:s + c] = rng.uniform(oy - 4, oy + 20, c)
        rec[2, s:s + c] = rng.uniform(0.05, 0.3, c)
        rec[3, s:s + c] = rng.uniform(-0.05, 0.05, c)
        rec[4, s:s + c] = rng.uniform(0.05, 0.3, c)
        rec[5:8, s:s + c] = rng.uniform(0, 1, (3, c))
        rec[8, s:s + c] = rng.uniform(0.1, 0.99, c)
        mask[s:s + c] = True
    if opaque is not None:
        rec[8, opaque[0]:opaque[0] + opaque[1]] = 0.999
    return rec, starts, counts, mask


CASES = {
    # name: (counts, aligned, opaque run)
    "mixed": ([50, 0, 130, 128, 300, 7], True, None),
    # every pixel of the deep tile stops before its last chunk: the store
    # leaves later blocks unwritten and the stored backward exits with it
    "early_exit": ([50, 0, 130, 128, 300, 7], True, (512, 140)),
    "unaligned": ([50, 0, 130, 128, 300, 7], False, None),
    "all_empty": ([0, 0, 0, 0, 0, 0], True, None),
}
BG = np.array([0.1, 0.2, 0.3], np.float32)


def _case(name):
    counts, aligned, opaque = CASES[name]
    return _records_case(counts, seed=0, aligned=aligned, opaque=opaque)


@pytest.fixture(scope="module")
def jax_fwd():
    """{case: (out, Texcl)} of the Pallas forward (interpret) on each
    case's records, with the transmittance store where the layout is
    aligned (Texcl None where it is not)."""
    out = {}
    for case, (_, aligned, _) in CASES.items():
        rec, starts, counts, _ = _case(case)
        j = [jnp.asarray(x) for x in (rec, starts, counts)]
        out[case] = (jpt.pallas_composite_fwd(*j, NX, NY, jnp.asarray(BG), interpret=True,
                                              store_t=True) if aligned else (
            jpt.pallas_composite_fwd(*j, NX, NY, jnp.asarray(BG), interpret=True), None))
    return out


class TestTransmittanceStore:
    @pytest.mark.parametrize("case", ["mixed", "early_exit"])
    def test_store_matches_pallas_and_leaves_out_alone(self, jax_fwd, case):
        """``out`` with the store is bitwise ``out`` without it, and Texcl
        equals the Pallas kernel's on every lane a pixel reaches (a real
        pair up to and with the pixel's stop; past the stop the JAX kernel
        keeps multiplying where the port freezes, and neither is read)."""
        rec, starts, counts, _ = _case(case)
        out_j, tex_j = jax_fwd[case]
        args = (_t(rec), _t(starts), _t(counts), NX, NY, _t(BG))
        out, tex = tpt.pallas_composite_fwd(*args, store_t=True)
        assert torch.equal(out, tpt.pallas_composite_fwd(*args))
        assert tex.shape == (rec.shape[1] // 128, 256, 128) and tex.dtype == torch.float32
        np.testing.assert_allclose(_np(out), np.asarray(out_j), atol=3e-5, rtol=0)
        walk = tpt._SegmentWalk(args[0], args[1], args[2], NX, NY)
        n_reached = 0
        for k, c in enumerate(walk):
            blocks = (walk.starts[c.act] // 128 + k).numpy()
            reached = c.reached.numpy()
            got, want = tex[blocks].numpy()[reached], np.asarray(tex_j)[blocks][reached]
            # a float32 cumulative product against exp of a bf16-split log sum
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
            n_reached += int(reached.sum())
        assert n_reached > 256 * 100
        if case == "early_exit":
            # tile 4 (300 pairs, 3 blocks) stopped inside its second block
            assert int(tex[starts[4] // 128 + 2].abs().max()) == 0


class TestCompositeBackward:
    """B4's plain version against the Pallas kernel (interpret) on
    identical records, outputs and cotangents."""

    @staticmethod
    def _run(jax_fwd, case, stored):
        rec, starts, counts, mask = _case(case)
        aligned = CASES[case][1]
        j = [jnp.asarray(x) for x in (rec, starts, counts)]
        out_j, tex_j = jax_fwd[case]
        dout = np.random.default_rng(99).normal(size=out_j.shape).astype(np.float32)
        want = jpt.pallas_composite_bwd(*j, NX, NY, out_j, jnp.asarray(dout), interpret=True,
                                        aligned=aligned, texcl=tex_j if stored else None)
        t = [_t(x) for x in (rec, starts, counts)]
        if stored:
            out, tex = tpt.pallas_composite_fwd(*t, NX, NY, _t(BG), store_t=True)
        else:
            out, tex = tpt.pallas_composite_fwd(*t, NX, NY, _t(BG)), None
        before = _launches("b4")
        got = tpt.pallas_composite_bwd(*t, NX, NY, out, _t(dout), aligned=aligned, texcl=tex)
        assert _launches("b4") == before  # CPU: the plain version
        return got, np.asarray(want), mask

    @pytest.mark.parametrize("case,stored", [
        ("mixed", False), ("mixed", True), ("early_exit", False), ("early_exit", True),
        ("unaligned", False), ("all_empty", False), ("all_empty", True)])
    def test_matches_pallas(self, jax_fwd, case, stored):
        got, want, mask = self._run(jax_fwd, case, stored)
        assert got.shape == want.shape and got.dtype == torch.float32
        for r in range(9):
            np.testing.assert_allclose(
                _np(got)[r, mask], want[r, mask], rtol=2e-3,
                atol=1e-4 * max(np.abs(want[r, mask]).max(initial=0.0), 1e-6),
                err_msg=f"row {r}")
        # rows 9-15, padding lanes and lanes past a tile's exit are zero
        assert not _np(got)[9:].any() and not _np(got)[:, ~mask].any()
        if case != "all_empty":
            assert np.abs(_np(got)[:9, mask]).max(axis=1).min() > 1e-3
        if case == "early_exit":
            assert not _np(got)[:, 512 + 256:512 + 300].any()

    @pytest.mark.parametrize("case", ["mixed", "early_exit"])
    def test_stored_equals_replay_bitwise(self, case):
        rec, starts, counts, _ = _case(case)
        t = [_t(x) for x in (rec, starts, counts)]
        out, tex = tpt.composite_fwd_plain(*t, NX, NY, _t(BG), store_t=True)
        dout = torch.tensor(np.random.default_rng(5).normal(size=out.shape), dtype=torch.float32)
        replay = tpt.composite_bwd_plain(*t, NX, NY, out, dout)
        stored = tpt.composite_bwd_plain(*t, NX, NY, out, dout, texcl=tex)
        assert torch.equal(replay, stored)
        assert torch.equal(replay, tpt.composite_bwd_plain(*t, NX, NY, out, dout))

    def test_refusals(self):
        rec, starts, counts, _ = _case("mixed")
        t = [_t(x) for x in (rec, starts, counts)]
        out, tex = tpt.pallas_composite_fwd(*t, NX, NY, _t(BG), store_t=True)
        with pytest.raises(ValueError, match="aligned"):
            tpt.pallas_composite_bwd(*t, NX, NY, out, out, aligned=False, texcl=tex)
        with pytest.raises(ValueError, match="dout"):
            tpt.pallas_composite_bwd(*t, NX, NY, out, out[:-1])
        with pytest.raises(ValueError, match="texcl"):
            tpt.pallas_composite_bwd(*t, NX, NY, out, out, aligned=True, texcl=tex[:-1])

    def test_composite_function_masks_and_skips_the_store(self):
        """``_composite``: its backward equals the wrapper's with lanes past
        starts[-1] zeroed, bg gets no gradient, and without grad the forward
        is the plain no-store call."""
        rec, starts, counts, _ = _case("mixed")
        r = _t(rec).requires_grad_()
        bg = _t(BG).requires_grad_()
        out = tpt._composite(r, _t(starts), _t(counts), bg, NX, NY, True)
        dout = torch.tensor(np.random.default_rng(6).normal(size=out.shape), dtype=torch.float32)
        g, g_bg = torch.autograd.grad(out, [r, bg], dout, allow_unused=True)
        assert g_bg is None
        want = tpt.composite_bwd_plain(_t(rec), _t(starts), _t(counts), NX, NY, out.detach(),
                                       dout)
        assert torch.equal(g, want) and not g[:, int(starts[-1]):].any()
        with torch.no_grad():
            again = tpt._composite(r, _t(starts), _t(counts), bg, NX, NY, True)
        assert torch.equal(again, out) and not again.requires_grad


class TestGatherAndPermute:
    @staticmethod
    def _layout(seed, P=37, nc=1024, cut=False):
        """A sorted aligned layout: gaussian g appears counts_g[g] times,
        spread over tiles; lanes in between carry the sentinel P."""
        rng = np.random.default_rng(seed)
        counts_g = rng.integers(0, 12, P).astype(np.int32)
        real = np.repeat(np.arange(P, dtype=np.int32), counts_g)
        rng.shuffle(real)
        gidx = np.full(nc, P, np.int32)
        gidx[np.sort(rng.choice(nc, real.size, replace=False))] = real
        ends_g = np.cumsum(counts_g).astype(np.int32)
        if cut:
            ends_g = np.full(P, nc + 1, np.int32)
        return gidx, ends_g, counts_g

    @pytest.mark.parametrize("case", ["sentinels", "dense", "truncated"])
    def test_gather_pairs_backward_matches(self, case):
        """The float64 running sum leaves each segment's sum rounded once;
        the JAX package differences a float32 running sum over all NC lanes,
        whose error grows with the prefix it cancels: about 6e-8 (float32
        eps) times the largest prefix magnitude, here < 1e-3 of the column's
        sum of |d|. Hence atol = 1e-6 * sum |d| per column."""
        P, nc = 37, 1024
        if case == "dense":  # no sentinel lane at all
            counts_g = np.full(P, nc // P, np.int32)
            counts_g[: nc - counts_g.sum()] += 1
            gidx = np.random.default_rng(1).permutation(
                np.repeat(np.arange(P, dtype=np.int32), counts_g))
            ends_g = np.cumsum(counts_g).astype(np.int32)
        else:
            gidx, ends_g, counts_g = self._layout(2, P, nc, cut=case == "truncated")
        rng = np.random.default_rng(3)
        records = rng.normal(size=(P, 9)).astype(np.float32)
        d = rng.normal(size=(9, nc)).astype(np.float32)
        fwd_j, vjp = jax.vjp(
            lambda r: jpt._gather_pairs(r, jnp.asarray(gidx), jnp.int32(nc),
                                        jnp.asarray(ends_g), jnp.asarray(counts_g)),
            jnp.asarray(records))
        (want,) = vjp(jnp.asarray(d))
        r = _t(records).requires_grad_()
        fwd = tpt._GatherPairs.apply(r, _t(gidx), _t(ends_g), _t(counts_g))
        np.testing.assert_array_equal(_np(fwd), np.asarray(fwd_j))
        (got,) = torch.autograd.grad(fwd, r, _t(d))
        atol = 1e-6 * np.abs(d).sum(axis=1).max()
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=atol)
        if case == "truncated":
            assert not _np(got).any()
        else:
            # the exact per-gaussian sums, in float64
            exact = np.zeros((P, 9))
            np.add.at(exact, gidx[gidx < P], d.T.astype(np.float64)[gidx < P])
            np.testing.assert_allclose(_np(got), exact, rtol=1e-6, atol=1e-6)
        (again,) = torch.autograd.grad(
            tpt._GatherPairs.apply(r, _t(gidx), _t(ends_g), _t(counts_g)), r, _t(d))
        assert torch.equal(got, again)  # deterministic

    def test_permute_backward_matches(self):
        rng = np.random.default_rng(4)
        x = rng.normal(size=(50, 9)).astype(np.float32)
        perm = rng.permutation(50).astype(np.int32)
        inv = np.argsort(perm).astype(np.int32)
        g = rng.normal(size=(50, 9)).astype(np.float32)
        y_j, vjp = jax.vjp(lambda a: jtiles._permute(a, jnp.asarray(perm), jnp.asarray(inv)),
                           jnp.asarray(x))
        xt = _t(x).requires_grad_()
        y = ttiles._permute(xt, _t(perm).long())
        np.testing.assert_array_equal(_np(y), np.asarray(y_j))
        (got,) = torch.autograd.grad(y, xt, _t(g))
        np.testing.assert_array_equal(_np(got), np.asarray(vjp(jnp.asarray(g))[0]))


# ---------------------------------------------------------- end to end


def _grad_scene(name):
    """The three scenes of tests/test_pallas_rasterizer.py::TestPallasBackward:
    (size, means, scales, quats, opacities, colors, target or None, bg, t_max)."""
    if name == "spread":
        rng = np.random.default_rng(3)
        n, size = 25, 32
        means = (rng.normal(size=(n, 3)) * 0.5 + [0, 0, 4]).astype(np.float32)
        scales = np.full((n, 3), 0.2, np.float32)
        quats = np.tile(np.array([[1, 0, 0, 0]], np.float32), (n, 1))
        opac = rng.uniform(0.3, 0.9, size=n).astype(np.float32)
        colors = rng.uniform(size=(n, 3)).astype(np.float32)
        target = rng.uniform(size=(3, size, size)).astype(np.float32)
        return size, means, scales, quats, opac, colors, target, 0.3, 64
    if name == "deep":
        rng = np.random.default_rng(8)
        n, size = 900, 32
        means = (rng.normal(size=(n, 3)) * 0.12 + [0, 0, 5]).astype(np.float32)
        scales = np.exp(rng.normal(size=(n, 3)) * 0.4 - 1.8).astype(np.float32)
        quats = rng.normal(size=(n, 4)).astype(np.float32)
        opac = rng.uniform(0.02, 0.12, size=n).astype(np.float32)
        colors = rng.uniform(size=(n, 3)).astype(np.float32)
        target = rng.uniform(size=(3, size, size)).astype(np.float32)
        return size, means, scales, quats, opac, colors, target, 0.0, 16
    rng = np.random.default_rng(4)  # "early_stop": near-opaque stacked gaussians
    n, size = 40, 16
    means = (rng.normal(size=(n, 3)) * 0.05 + [0, 0, 3]).astype(np.float32)
    scales = np.full((n, 3), 0.3, np.float32)
    quats = np.tile(np.array([[1, 0, 0, 0]], np.float32), (n, 1))
    opac = np.full(n, 0.95, np.float32)
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    return size, means, scales, quats, opac, colors, None, 0.0, 64


class TestRasterizePallasGradients:
    @pytest.mark.parametrize("scene", ["spread", "deep", "early_stop"])
    def test_gradients_match_jax_and_golden(self, scene):
        """Gradients of means, opacities and colours through projection and
        ``rasterize_pallas``: against jax.grad through the JAX package's
        (Pallas kernels in interpret mode), and against autograd through the
        port's golden compositor."""
        size, means, scales, quats, opac, colors, target, bgv, t_max = _grad_scene(scene)
        cam = make_synthetic_camera(size, size, 0.9, 0.9, np.eye(3), np.zeros(3))
        tan = math.tan(0.45)

        def loss_j(params):
            proj = jproj.project_gaussians(
                params[0], jbuild_covariance(jnp.asarray(scales), jnp.asarray(quats)),
                params[1], jnp.asarray(cam.view), jnp.asarray(cam.full_proj),
                jnp.asarray(cam.camera_center), size, size, tan, tan,
                colors_precomp=params[2])
            img = jpt.rasterize_pallas(proj, size, size, jnp.full(3, bgv), t_max=t_max,
                                       interpret=True)
            if target is None:
                return jnp.mean(img)
            return jnp.mean(jnp.square(img - jnp.asarray(target)))

        want = jax.grad(loss_j)((jnp.asarray(means), jnp.asarray(opac), jnp.asarray(colors)))

        def grads_t(renderer):
            params = [_t(means).requires_grad_(), _t(opac).requires_grad_(),
                      _t(colors).requires_grad_()]
            proj = tproj.project_gaussians(
                params[0], tbuild_covariance(_t(scales), _t(quats)), params[1],
                _t(cam.view), _t(cam.full_proj), _t(cam.camera_center), size, size, tan,
                tan, colors_precomp=params[2])
            img = renderer(proj)
            loss = img.mean() if target is None else torch.mean(torch.square(img - _t(target)))
            return torch.autograd.grad(loss, params)

        got = grads_t(lambda p: tpt.rasterize_pallas(p, size, size, torch.full((3,), bgv),
                                                     t_max=t_max))
        gold = grads_t(lambda p: tcomp.rasterize_brute(p, size, size, torch.full((3,), bgv)))
        tol = dict(rtol=2e-3, atol=5e-6) if scene == "early_stop" else GRAD_TOL
        for g, w, b, name in zip(got, want, gold, ["means", "opac", "colors"]):
            np.testing.assert_allclose(_np(g), np.asarray(w), err_msg=f"{name} vs jax", **tol)
            np.testing.assert_allclose(_np(g), _np(b), err_msg=f"{name} vs golden", **tol)
            assert np.abs(_np(g)).max() > 0

    def test_truncated_step_drops_gradients(self):
        """An aligned demand over the nc budget zeroes the step's raster
        gradients, as the JAX package does through the same guard of its
        pair gather (held against it in ``test_gather_pairs_backward_matches``),
        and ``grad_dropped`` says so."""
        rng = np.random.default_rng(0)
        n, W, H = 150, 64, 48
        fields = dict(
            means2d=rng.uniform([0, 0], [W, H], size=(n, 2)).astype(np.float32),
            depths=rng.uniform(1, 5, n).astype(np.float32),
            conics=np.tile(np.array([[0.05, 0.0, 0.05]], np.float32), (n, 1)),
            radii=np.full(n, 12, np.int32),
            colors=rng.uniform(size=(n, 3)).astype(np.float32),
            opacities=rng.uniform(0.2, 0.9, n).astype(np.float32))
        colors = _t(fields["colors"]).requires_grad_()
        proj = tproj.ProjectedGaussians(**{k: _t(v) for k, v in fields.items()})
        img, stats = tpt.rasterize_pallas(proj._replace(colors=colors), W, H, torch.zeros(3),
                                          nc_pairs=1024, return_stats=True)
        assert int(stats["grad_dropped"]) == 1 and int(stats["nc_demand"]) > 1024
        (g,) = torch.autograd.grad(img.sum(), colors)
        assert not g.any()
