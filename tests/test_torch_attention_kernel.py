"""The port's fused attention scores (B1) against sixdgs_tpu's Pallas kernel.

On the CPU the wrapper runs its plain versions, held here against the JAX
kernel in interpret mode in all three precision modes (the tolerance of
tests/test_attention_kernel.py): the forward (B1) and, through
jax.grad, the backward (B2). The CUDA kernel itself is held against the
plain version in tests/test_torch_cuda_kernels.py, which imports no JAX so
that it also runs on a machine with a card and no JAX.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sixdgs_tpu.ops import attention_kernel as jak
from sixdgs_tpu.pose import modules as jmod
from sixdgs_torch import weights
from sixdgs_torch.ops import attention_kernel as tak
from sixdgs_torch.utils import profiling
from torch_threads import shared_cores  # noqa: F401 (an autouse fixture)


def _launches(kernel):
    """Launches of ``kernel`` (b1-b5, b3_store) counted so far on CUDA tensors."""
    return profiling.snapshot()["counters"].get("kernel." + kernel, 0)


def _t(x):
    return torch.tensor(np.asarray(x))


def _problem(seed=0, P=256, d=128, N=1024, n_invalid=100):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(P, d)).astype(np.float32)
    feats = rng.normal(size=(N, d)).astype(np.float32)
    wk = (rng.normal(size=(d, d)) * 0.05).astype(np.float32)
    bk = (rng.normal(size=(d,)) * 0.1).astype(np.float32)
    pmask = (rng.uniform(size=P) > 0.3).astype(np.float32)
    valid = np.ones(N, np.float32)
    valid[N - n_invalid:] = 0.0
    return q, feats, wk, bk, pmask, valid


class TestPlainVersusPallas:
    @pytest.mark.parametrize("mode", ["f32", "bf16", "bf16_split3"])
    def test_scores_and_residuals_match(self, mode):
        q, feats, wk, bk, pmask, valid = _problem()
        P, N = q.shape[0], feats.shape[0]
        out, m, s = jak._fused_fwd_call_train(
            *map(jnp.asarray, (q, feats, wk, bk)), jnp.asarray(pmask).reshape(P, 1),
            jnp.asarray(valid).reshape(1, N), 256, True, mode)
        ref = np.asarray(jak.attention_scores_fused(
            *map(jnp.asarray, (q, feats, wk, bk, pmask, valid)), block=256,
            interpret=True, mode=mode))
        np.testing.assert_array_equal(ref, np.asarray(out)[0])

        scores, tm, ts = tak.attention_scores_fwd(*map(_t, (q, feats, wk, bk, pmask, valid)),
                                                  mode=mode)
        if mode == "bf16":
            # the port rounds q'' = q Wk^T and feats (its reassociated
            # order, the one B2 takes), the Pallas kernel feats, Wk, q and
            # K. Each rounding is off by up to 2^-9 relative, so a logit
            # l_pj = sum_k t_k, t_k = q''_pk f_jk / sqrt(d), differs by
            # a few 2^-9 of its terms' root-sum-square size R (read: up
            # to 3.5 x 2^-9 R over the 262,144 logits): delta = 8 x 2^-9 R.
            # Carried into the softmax: |dm_p| <= delta, |ds_p| / s_p <=
            # 2 delta and |dscore_j| <= 2 delta score_j (read: 6.9e-3,
            # 6.5e-3 and 7.5e-4 against 1.6e-2, 3.1e-2 and 3.1e-2)
            qpp = q.astype(np.float64) @ wk.T.astype(np.float64)
            R = np.sqrt((qpp ** 2 @ feats.T.astype(np.float64) ** 2).max() / q.shape[1])
            delta = 8 * 2.0 ** -9 * R
            tols = {"scores": (1e-5, 2 * delta), "m": (delta, 0.0), "s": (0.0, 2 * delta)}
        else:
            tols = dict.fromkeys(("scores", "m", "s"), (1e-5, 1e-4))
        for name, a, b in (("scores", scores, ref), ("m", tm, m), ("s", ts, s)):
            atol, rtol = tols[name]
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol, rtol=rtol,
                                       err_msg=name)
        out_only = tak.attention_scores_fused(*map(_t, (q, feats, wk, bk, pmask, valid)),
                                              mode=mode)
        np.testing.assert_array_equal(out_only.numpy(), scores.numpy())
        np.testing.assert_allclose(scores[N - 100:].numpy(), 0.0, atol=1e-12)
        np.testing.assert_allclose(scores.sum().item(), pmask.sum(), rtol=1e-4)

    def test_all_invalid_rows_keep_the_neg_sentinel(self):
        """NEG = -9e15 (not -inf): with every ray invalid each patch spreads
        uniformly, as in the Pallas kernel."""
        q, feats, wk, bk, pmask, _ = _problem(seed=1, N=512)
        valid = np.zeros(512, np.float32)
        ref = np.asarray(jak.attention_scores_fused(
            *map(jnp.asarray, (q, feats, wk, bk, pmask, valid)), block=256,
            interpret=True, mode="f32"))
        out = tak.attention_scores_fused(*map(_t, (q, feats, wk, bk, pmask, valid)),
                                         mode="f32").numpy()
        np.testing.assert_allclose(out, ref, atol=1e-7)
        np.testing.assert_allclose(out, pmask.sum() / 512, rtol=1e-5)

    def test_fused_ray_scores_matches(self):
        rng = np.random.default_rng(2)
        P, N, d = 256, 512, 64
        jp = jmod.init_id_module(jax.random.key(0), feature_dim=d)
        tm = weights.id_module_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        img = rng.normal(size=(P, d + 14)).astype(np.float32)
        rays = rng.normal(size=(N, d)).astype(np.float32)
        pmask = rng.uniform(size=P) > 0.5
        valid = np.ones(N, bool)
        ref = np.asarray(jak.fused_ray_scores(jp, *map(jnp.asarray, (img, rays, pmask, valid)),
                                              block=128, interpret=True))
        with torch.no_grad():
            out = tak.fused_ray_scores(tm, *map(_t, (img, rays, pmask, valid))).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-4)


class TestForwardReassociationIdentity:
    """The plain forward in its reassociated order (logits = (q'' feats^T +
    q bk) / sqrt(d), q'' = q Wk^T) against the K-path formula of the TPU
    kernel's _fwd_kernel_train (K = feats Wk + bk, logits = q K^T /
    sqrt(d)), both in float64: exact in real arithmetic, so they agree to
    float64 rounding."""

    @pytest.mark.parametrize("case", ["partial", "all_invalid"])
    def test_reassociated_equals_k_path(self, case):
        q, feats, wk, bk, pmask, valid = (torch.tensor(x, dtype=torch.float64) for x in
                                          _problem(seed=13, d=64, N=300, n_invalid=40))
        if case == "all_invalid":
            valid = torch.zeros_like(valid)
        got = tak.attention_scores_plain(q, feats, wk, bk, pmask, valid, mode="f32")
        d = q.shape[1]
        logits = torch.where(valid[None] > 0, q @ (feats @ wk + bk).T / d ** 0.5,
                             torch.full((q.shape[0], 300), tak.NEG, dtype=torch.float64))
        m = logits.amax(1, keepdim=True)
        e = torch.exp(logits - m)
        s = e.sum(1, keepdim=True)
        want = ((e / s * pmask[:, None]).sum(0), m, s)
        for name, a, b in zip(("scores", "m", "s"), got, want):
            assert a.dtype == torch.float64, name
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-10 * max(b.abs().max().item(), 1e-3),
                                       err_msg=name)
        if case == "all_invalid":
            # NEG, not -inf: each patch spreads 1/N over the rays
            assert (got[1] == tak.NEG).all()
            np.testing.assert_allclose(got[0].numpy(), pmask.sum().item() / 300, rtol=1e-12)
        else:
            assert (got[0][-40:] == 0).all()  # the invalid tail: exactly zero


class TestSharedPlainLogits:
    """Both plain versions take their logits from one helper, so the
    forward's m and s normalise the backward's probabilities: sum_j P_pj =
    1 per patch up to float32 rounding of the exponentials and sums."""

    @pytest.mark.parametrize("mode", ["f32", "bf16", "bf16_split3"])
    def test_backward_probabilities_sum_to_one(self, mode, monkeypatch):
        q, feats, wk, bk, pmask, valid, g = map(_t, (*_problem(seed=14), np.ones(1024, np.float32)))
        seen = []
        helper = tak._plain_logits

        def spy(*args):
            out = helper(*args)
            seen.append(out[1])
            return out

        monkeypatch.setattr(tak, "_plain_logits", spy)
        _, m, s = tak.attention_scores_plain(q, feats, wk, bk, pmask, valid, mode=mode)
        tak.attention_scores_bwd_plain(q, feats, wk, bk, pmask, valid, m, s, g, mode=mode)
        assert len(seen) == 2 and torch.equal(seen[0], seen[1])
        # the backward's probabilities, as it forms them
        probs = torch.exp(seen[1] - m) / s
        mass = probs.double().sum(1)
        assert (mass - 1).abs().max().item() <= 1e-6


class TestPlainBackwardVersusPallas:
    """B2's plain version, and autograd through the port's Function,
    against jax.grad through the Pallas kernel (interpret mode) for all four
    inputs, at the tolerance of tests/test_attention_kernel.py in the
    f32-class modes (bf16's is restated below: the rounding points moved)."""

    @staticmethod
    def _jax_grads(q, feats, wk, bk, pmask, valid, g, mode):
        def loss(q, feats, wk, bk):
            s = jak.attention_scores_fused(q, feats, wk, bk, jnp.asarray(pmask),
                                           jnp.asarray(valid), block=256,
                                           interpret=True, mode=mode)
            return jnp.sum(s * jnp.asarray(g))

        return [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2, 3))(
            *map(jnp.asarray, (q, feats, wk, bk)))]

    @staticmethod
    def _dk_scale(q, feats, wk, bk, pmask, valid, g):
        """max_col sum_j |dk_j|, dk = dlog^T q, in float64 (K path)."""
        q, feats, wk, bk, pmask, valid, g = (np.asarray(x, np.float64) for x in
                                             (q, feats, wk, bk, pmask, valid, g))
        logits = q @ (feats @ wk + bk).T / np.sqrt(q.shape[1])
        logits = np.where(valid[None] > 0, logits, jak.NEG)
        e = np.exp(logits - logits.max(1, keepdims=True))
        probs = e / e.sum(1, keepdims=True)
        c = (probs * g).sum(1, keepdims=True)
        dlog = pmask[:, None] * probs * (g - c) / np.sqrt(q.shape[1])
        return np.abs(dlog.T @ q).sum(0).max()

    @pytest.mark.parametrize("mode", ["f32", "bf16", "bf16_split3"])
    @pytest.mark.parametrize("all_invalid", [False, True])
    def test_gradients_match(self, mode, all_invalid):
        q, feats, wk, bk, pmask, valid = _problem(seed=7)
        if all_invalid:
            # the TPU kernel does not mask dlog by validity: each patch
            # spreads 1/N over the invalid rays, which get a nonzero dfeats
            valid = np.zeros_like(valid)
        g = np.random.default_rng(8).normal(size=feats.shape[0]).astype(np.float32)
        ref = self._jax_grads(q, feats, wk, bk, pmask, valid, g, mode)

        tq, tf, twk, tbk, tpm, tv, tg = map(_t, (q, feats, wk, bk, pmask, valid, g))
        _, m, s = tak.attention_scores_fwd(tq, tf, twk, tbk, tpm, tv, mode=mode)
        plain = tak.attention_scores_bwd_plain(tq, tf, twk, tbk, tpm, tv, m, s, tg,
                                               mode=mode)
        leaves = [x.clone().requires_grad_(True) for x in (tq, tf, twk, tbk)]
        scores = tak.attention_scores_fused(*leaves, tpm, tv, mode=mode)
        auto = torch.autograd.grad(torch.sum(scores * tg), leaves)
        # bf16: the port rounds q'' = q Wk^T, feats and dlog (its
        # reassociated order), the Pallas kernel feats, Wk, K, q, dlog and
        # dk. Each rounding is off by up to 2^-9 relative, so the two
        # logits, and from them every gradient, differ by a few 2^-9 of
        # their terms' size (read: 4.4e-3 of max |dq|): 4 x 2^-9 of the
        # largest gradient entry. dbk is zero in exact arithmetic (its value
        # is rounding noise in both), so it is held against the size of the
        # terms it sums, max_col sum_j |dk_j|
        bf16_tol = 4 * 2.0 ** -9
        dk_scale = self._dk_scale(q, feats, wk, bk, pmask, valid, g)
        for name, r, a, b in zip(("dq", "dfeats", "dwk", "dbk"), ref, plain, auto):
            scale = dk_scale if name == "dbk" else np.abs(r).max()
            atol = 2e-5 + (bf16_tol * scale if mode == "bf16" else 0.0)
            np.testing.assert_allclose(a.numpy(), r, atol=atol, rtol=1e-3, err_msg=name)
            np.testing.assert_allclose(b.numpy(), r, atol=atol, rtol=1e-3, err_msg=name)
        if all_invalid:
            assert np.abs(ref[1]).max() > 1e-3  # the pinned quirk
        else:
            np.testing.assert_array_equal(plain[1][-100:].numpy(), 0.0)


class TestReassociationIdentity:
    """The plain backward in its reassociated order (q'' = q Wk^T, A =
    dlog feats: dq = A Wk + r bk^T, dWk = A^T q, dbk = q^T r, dfeats =
    dlog^T q'') against the K-path formula of the TPU kernel's _bwd_kernel
    (dk = dlog^T q, dfeats = dk Wk^T, dq = dlog K, dWk = feats^T dk, dbk =
    sum_j dk_j), both in float64: exact in real arithmetic, so they agree to
    float64 rounding."""

    @pytest.mark.parametrize("case", ["partial", "all_invalid"])
    def test_reassociated_equals_k_path(self, case):
        q, feats, wk, bk, pmask, valid = (torch.tensor(x, dtype=torch.float64) for x in
                                          _problem(seed=11, d=64, N=300, n_invalid=40))
        if case == "all_invalid":
            valid = torch.zeros_like(valid)
        g = torch.tensor(np.random.default_rng(12).normal(size=300))
        _, m, s = tak.attention_scores_plain(q, feats, wk, bk, pmask, valid, mode="f32")
        got = tak.attention_scores_bwd_plain(q, feats, wk, bk, pmask, valid, m, s, g,
                                             mode="f32")
        d = q.shape[1]
        k = feats @ wk + bk
        logits = torch.where(valid[None] > 0, q @ k.T / d ** 0.5,
                             torch.full((q.shape[0], 300), tak.NEG, dtype=torch.float64))
        probs = torch.exp(logits - m) / s
        c = (probs * g).sum(1, keepdim=True)
        dlog = pmask[:, None] * probs * (g - c) / d ** 0.5
        dk = dlog.T @ q
        want = (dlog @ k, dk @ wk.T, feats.T @ dk, dk.sum(0))
        for name, a, b in zip(("dq", "dfeats", "dwk", "dbk"), got, want):
            assert a.dtype == torch.float64, name
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-10 * max(b.abs().max().item(), 1e-3),
                                       err_msg=name)
        if case == "all_invalid":
            assert got[1].abs().max().item() > 1e-3  # invalid rays keep a dfeats
        else:
            assert (got[1][-40:] == 0).all()  # the invalid tail: exactly zero


class TestWrapperContract:
    def test_forward_only_and_modes(self):
        """Gradients are accepted now (B2 is the backward); a mode the
        kernels do not have still raises, on the forward and the backward."""
        q, feats, wk, bk, pmask, valid = map(_t, _problem(N=64, n_invalid=4))
        wk.requires_grad_(True)
        scores = tak.attention_scores_fused(q, feats, wk, bk, pmask, valid)
        (dwk,) = torch.autograd.grad(scores.sum() + scores[0], [wk])
        assert dwk.shape == wk.shape and torch.isfinite(dwk).all()
        with pytest.raises(ValueError, match="mode"):
            tak.attention_scores_fused(q, feats, wk, bk, pmask, valid, mode="tf32")
        _, m, s = tak.attention_scores_fwd(q, feats, wk.detach(), bk, pmask, valid)
        with pytest.raises(ValueError, match="mode"):
            tak.attention_scores_bwd(q, feats, wk.detach(), bk, pmask, valid, m, s,
                                     torch.ones(64), mode="tf32")

    def test_cpu_path_does_not_count_launches(self):
        before = (_launches("b1"), _launches("b2"))
        leaves = [x.requires_grad_(True) for x in map(_t, _problem(N=64, n_invalid=4)[:4])]
        scores = tak.attention_scores_fused(*leaves, *map(_t, _problem(N=64, n_invalid=4)[4:]))
        scores.sum().backward()
        assert (_launches("b1"),
                _launches("b2")) == before
