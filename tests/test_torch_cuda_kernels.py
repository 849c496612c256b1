"""The port's CUDA kernels against their plain PyTorch versions, on a card.

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
    # f32-class modes differ from the plain version only in summation order;
    # in bf16 an f32 K on a rounding boundary can round apart
    @pytest.mark.parametrize("mode,tol", [("f32", 1e-5), ("bf16_split3", 1e-5),
                                          ("bf16", 1e-3)])
    @pytest.mark.parametrize("N", [5000, 32768])
    def test_kernel_matches_plain(self, mode, tol, N):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA GPU and nvcc")
        # N=5000 is ragged (not a multiple of the kernel's 32-ray block);
        # N=32768 is the default ray budget. Partial patch mask, padded tail
        # of invalid rays
        ins = _b1_inputs(seed=3, N=N)
        before = tak.attention_scores_fused.launches
        s, m, ss = tak.attention_scores_fwd(*ins, mode=mode)
        torch.cuda.synchronize()
        assert tak.attention_scores_fused.launches == before + 1
        rs, rm, rss = tak.attention_scores_plain(*ins, mode=mode)
        scale = rs.abs().max().item()
        assert (s - rs).abs().max().item() <= tol * scale
        assert (m - rm).abs().max().item() <= 100 * tol * rm.abs().max().item()
        assert ((ss - rss).abs() / rss).max().item() <= 100 * tol
        assert (s[-700:].abs() < 1e-12).all()

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
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA GPU and nvcc")
        q, feats, wk, bk, pmask, valid = _b1_inputs(seed=4, N=64, n_invalid=0)
        with pytest.raises(ValueError, match="kernel takes"):
            tak.attention_scores_fused(q[:128], feats, wk, bk, pmask[:128], valid)


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


def _b2_check(ins, mode, tol, seed):
    """B2 against its plain version on the forward's residuals, each
    gradient within ``tol`` of its max |plain| (dbk: of _dbk_scale)."""
    g = torch.tensor(np.random.default_rng(seed).normal(size=ins[1].shape[0]),
                     dtype=torch.float32, device="cuda")
    _, m, s = tak.attention_scores_fwd(*ins, mode=mode)
    before = tak.attention_scores_bwd.launches
    out = tak.attention_scores_bwd(*ins, m, s, g, mode=mode)
    torch.cuda.synchronize()
    assert tak.attention_scores_bwd.launches == before + 1
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

    def test_all_invalid_rays_get_the_unmasked_gradient(self):
        """The TPU kernel does not mask dlog by validity: with every ray
        invalid each patch spreads 1/N over them, and dfeats is nonzero."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA GPU and nvcc")
        ins = _b1_inputs(seed=8, N=1000, n_invalid=1000)
        dq, dfeats, dwk, dbk = _b2_check(ins, "f32", 1e-4, seed=9)
        assert dfeats.abs().max().item() > 0
