"""sixdgs_torch.parallel against sixdgs_tpu.parallel, on the CPU.

The same numpy inputs (tests/test_parallel.py's shapes: 4 images of 56x56,
1,024 rays, DINO 64 wide and 1 block deep; its 96-Gaussian render scene at
64x32 and 48-Gaussian training scene with 8 cameras at 32x32) go through
the JAX functions on 2- and 4-device slices of the 8 CPU devices, and
through the port in spawned gloo ranks on ``device_type="cpu"``
(tests/torch_parallel_ranks.py, which imports neither jax nor
sixdgs_tpu). The ranks of world sizes 1, 2 and 4 are started together
once, run every case of their size while the JAX side computes, and leave
their results in npz files.

Cases: ``_factor_2d`` and the mesh shapes for 1-8 ranks; the pose step at
(1, 2) (SP), (2, 1) (DP) and (2, 2) (both, where a gradient counted once
per rank would show), the cached step at (2, 1) and the step with one NaN
image (the global masked mean), against the JAX sharded step; the render's
gathered bands against JAX's ``make_sharded_render`` and ``render_eval``;
at one rank, the sharded loss and its gradients against the port's own
single-device ``batch_loss_cached`` (finite and with a NaN image); the DP
3DGS step (2 steps) at 2 ranks, "tiled" against JAX "tiled" and
"pallas" (its kernels' plain versions) against JAX "pallas_interpret", and
at 1 rank against 2.

Tolerances are tests/test_parallel.py's: pose loss rtol 2e-4 and
parameters atol 1.5e-3 rtol 5e-3 (Adafactor's first step divides each
gradient by its own size, so f32 noise in the reduction order shows at
lr * max(rms(p), 1e-3)). That division also hides a gradient scaled as a
whole (one counted once per rank), so the step's summed gradients are held
too, against ``jax.grad`` of the JAX batch loss with the step's zeroing of
non-finite entries, as tests/test_torch_pose_trainer.py holds the batch
loss: each within 1e-4 of its own largest entry, the two whose true value
is zero within 1e-5 of the largest entry overall. The render 2e-5; the
3DGS step loss rtol 1e-5, xyz atol 1e-5, xyz_grad_accum rtol 1e-4 atol
1e-6, denom and max radii equal.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from sixdgs_tpu.parallel import gs_sharding as jgs
from sixdgs_tpu.parallel import mesh as jmesh
from sixdgs_tpu.parallel import pose_sharding as jpose
from sixdgs_tpu.pose import dino as jdino
from sixdgs_tpu.pose import trainer as jtr
from sixdgs_tpu.pose.modules import init_id_module
from sixdgs_tpu.pose.trainer import make_adafactor
from sixdgs_tpu.scene.cameras import make_synthetic_camera
from sixdgs_tpu.scene.gaussians import from_arrays
from sixdgs_tpu.train import gs_trainer as jtrain
from sixdgs_tpu.utils.config import OptimizationConfig
from sixdgs_torch.parallel import mesh as tmesh
from sixdgs_torch.pose import trainer as ttr
from torch_threads import shared_cores  # noqa: F401 (an autouse fixture)

RANKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_ranks.py")
WORLDS = (1, 2, 4)
RANK_TIMEOUT = 300  # seconds for every rank of every world size
# the k-projection bias and the ray MLP's last bias: a true gradient of 0
ZERO_GRAD_PARAMS = ("attention/k/b", "ray_mlp/l4/b")
PARAMS = ("xyz", "features_dc", "features_rest", "opacity", "scaling", "rotation")
CAM_FIELDS = ("view", "full_proj", "camera_center", "tan_fovx", "tan_fovy")


def _flat(tree) -> dict:
    return ttr._flatten(jax.tree.map(np.asarray, tree))


def _look_at(pos):
    z = -pos / np.linalg.norm(pos)
    x = np.cross([0, 1, 0], z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, y, z, pos
    return m


def pose_inputs(B=4, N=1024, H=56, W=56, seed=0):
    """tests/test_parallel.py::make_inputs as numpy arrays."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    c2w = np.stack([_look_at(rng.normal(size=3) * 2) for _ in range(B)])
    ori = rng.normal(size=(N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    valid = np.ones(N, bool)
    valid[N - 100:] = False
    rays = {"ori": ori, "dir": d, "rgb": rng.uniform(size=(N, 3)).astype(np.float32),
            "valid": valid, "gaussian_idx": np.zeros(N, np.int32)}
    return {"images": images, "masks": np.ones((B, H, W), bool), "c2w": c2w}, rays


def feature_inputs(B=4, D=64, seed=0):
    """tests/test_parallel_cached.py::make_feature_batch as numpy arrays."""
    rng = np.random.default_rng(seed)
    _, rays = pose_inputs(B=B, seed=seed)
    c2w = np.stack([_look_at(rng.normal(size=3) * 2) for _ in range(B)])
    fb = {"feats_pe": rng.normal(size=(B, 256, D + 14)).astype(np.float32),
          "patch_mask": rng.uniform(size=(B, 256)) > 0.3,
          "fmap": rng.normal(size=(B, D, 16, 16)).astype(np.float32), "c2w": c2w}
    return fb, rays


def scene_arrays(n, seed):
    rng = np.random.default_rng(seed)
    return {
        "xyz": (rng.normal(size=(n, 3)) * 0.5 + [0, 0, 4]).astype(np.float32),
        "features_dc": rng.normal(size=(n, 1, 3)).astype(np.float32),
        "features_rest": np.zeros((n, 15, 3), np.float32),
        "opacity": rng.uniform(0, 2, size=(n, 1)).astype(np.float32),
        "scaling": rng.uniform(-2.0, -1.2, size=(n, 3)).astype(np.float32),
        "rotation": rng.normal(size=(n, 4)).astype(np.float32),
    }, rng


def ring_cameras(rng, W=32, H=32, n=8):
    """tests/test_parallel.py's 8 training cameras with random images."""
    cams = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        pos = np.array([3 * np.cos(ang), 0.2, 4 + 3 * np.sin(ang)])
        fwd = np.array([0, 0, 4]) - pos
        fwd /= np.linalg.norm(fwd)
        right = np.cross([0, 1, 0], fwd)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        R_w2c = np.stack([right, up, fwd], axis=0)
        cam = make_synthetic_camera(W, H, 0.8, 0.8, R_w2c.T, -R_w2c @ pos, name=f"c{i}")
        img = rng.uniform(size=(3, H, W)).astype(np.float32)
        cams.append(cam.__class__(**{**cam.__dict__, "image": img}))
    return cams


def jax_mesh(n, shape=None, axis_names=("data", "rays")):
    return jmesh.make_mesh(n, axis_names=axis_names, shape=shape,
                           devices=jax.devices()[:n])


def _jax_pose(step, params, sharded, loss_fn, *args):
    """One JAX sharded step from fresh copies of ``params`` and the
    single-device gradient of ``loss_fn`` on the same inputs, non-finite
    entries zeroed: (flat params, aux, flat grads)."""
    opt = make_adafactor()
    p = jax.tree.map(jnp.array, params)
    p, _, aux = step(p, opt.init(p), *sharded)
    grads = loss_fn(params, *args)[1]
    return (_flat(p), {k: np.asarray(v) for k, v in aux.items()},
            {k: np.where(np.isfinite(g), g, 0.0) for k, g in _flat(grads).items()})


def jax_side(d):
    """Every JAX reference, computed while the ranks run."""
    out = {}
    opt = make_adafactor()
    up = jnp.asarray(d["model_up"])
    rays = jpose.Rays(*(jnp.asarray(d[f"rays_{f}"]) for f in jpose.Rays._fields))

    # the pose steps: DP x SP on a (2, 2) slice, the cached step on (2, 1)
    mesh = jax_mesh(4)
    step = jpose.make_sharded_pose_step(mesh, opt)
    loss_fn = jax.jit(jax.value_and_grad(jtr.batch_loss, has_aux=True))
    for key, c2w in (("pose", "c2w"), ("pose_nan", "c2w_nan")):
        batch = jpose.PoseBatch(jnp.asarray(d["images"]), jnp.asarray(d["masks"]),
                                jnp.asarray(d[c2w]))
        sharded = (d["j_dino"], *jpose.shard_pose_inputs(mesh, batch, rays), up)
        out[key] = _jax_pose(step, d["j_idm"], sharded, loss_fn, d["j_dino"], batch, rays,
                             up)
    mesh = jax_mesh(2, shape=(2, 1))
    fb = jpose.FeatureBatch(*(jnp.asarray(d[f"fb_{f}"]) for f in jpose.FeatureBatch._fields))
    frays = jpose.Rays(*(jnp.asarray(d[f"frays_{f}"]) for f in jpose.Rays._fields))
    out["cached"] = _jax_pose(jpose.make_sharded_pose_step_cached(mesh, opt), d["j_idm"],
                              (*jpose.shard_feature_inputs(mesh, fb, frays), up),
                              jax.jit(jax.value_and_grad(jtr.batch_loss_cached,
                                                         has_aux=True)), fb, frays, up)

    # the render: JAX's sharded render on 2 devices and render_eval
    scene = from_arrays({k: d[f"r_{k}"] for k in PARAMS}, max_sh_degree=3,
                        capacity=int(d["r_capacity"]))
    render = jpose.make_sharded_render(jax_mesh(2, axis_names=("gaussians",)), 64, 32, 3,
                                       chunk=64)
    out["render_sharded"] = np.asarray(render(scene.params(), scene.active,
                                              jtrain.camera_arrays(d["j_rcam"]),
                                              jnp.zeros(3)))
    out["render_eval"] = np.asarray(jtrain.render_eval(scene, d["j_rcam"], jnp.zeros(3), 3,
                                                       chunk=64))

    # the DP 3DGS step on 2 devices, two steps
    gmesh = jax_mesh(2, axis_names=("data",))
    cams = jgs.shard_camera_batch(gmesh, jgs.stack_camera_batch(d["j_gcams"]))
    lrs = jtrain.lr_dict(OptimizationConfig(), 1.0, 100)
    for rasterizer in ("tiled", "pallas_interpret"):
        step = jgs.make_sharded_gs_step(gmesh, width=32, height=32, sh_degree=3, chunk=64,
                                        rasterizer=rasterizer)
        state = jtrain.init_train_state(from_arrays(
            {k: d[f"g_{k}"] for k in PARAMS}, max_sh_degree=3, capacity=int(d["g_capacity"])))
        losses = []
        for _ in range(2):
            state, m = step(state, cams, jnp.zeros(3), lrs)
            losses.append(float(m["loss"]))
        out[f"gs_{rasterizer}"] = {
            "loss": losses, "xyz": np.asarray(state.scene.xyz),
            "xyz_grad_accum": np.asarray(state.xyz_grad_accum),
            "denom": np.asarray(state.denom), "max_radii2d": np.asarray(state.max_radii2d)}
    return out


def shared_inputs():
    """The numpy inputs of both sides: {npz-able arrays} plus the JAX-only
    objects (params trees, cameras) under "j_" keys."""
    d = {}
    j_dino = jdino.init_params(jax.random.key(0), embed_dim=64, depth=1)
    j_idm = init_id_module(jax.random.key(1), feature_dim=64)
    d.update({f"dino/{k}": v for k, v in _flat(j_dino).items()})
    d.update({f"idm/{k}": v for k, v in _flat(j_idm).items()})
    batch, rays = pose_inputs()
    d.update(batch)
    c2w_nan = batch["c2w"].copy()
    c2w_nan[1, 0, 3] = np.nan  # image 1: NaN target, its loss skipped
    d["c2w_nan"] = c2w_nan
    d.update({f"rays_{k}": v for k, v in rays.items()})
    d["model_up"] = np.array([0.0, 1.0, 0.0], np.float32)
    fb, frays = feature_inputs()
    d.update({f"fb_{k}": v for k, v in fb.items()})
    d.update({f"frays_{k}": v for k, v in frays.items()})

    arrs, _ = scene_arrays(96, seed=4)
    d.update({f"r_{k}": v for k, v in arrs.items()})
    d["r_capacity"] = np.asarray(128)
    rcam = make_synthetic_camera(64, 32, 0.8, 0.8, np.eye(3), np.zeros(3))
    for f, v in zip(CAM_FIELDS, jtrain.camera_arrays(rcam)):
        d[f"rcam_{f}"] = np.asarray(v)
    d["rcam_hw"] = np.asarray([32, 64])

    arrs, rng = scene_arrays(48, seed=6)
    d.update({f"g_{k}": v for k, v in arrs.items()})
    d["g_capacity"] = np.asarray(64)
    gcams = ring_cameras(rng)
    for f, v in zip(jtrain.CameraArrays._fields, jgs.stack_camera_batch(gcams)):
        d[f"gcam_{f}"] = np.asarray(v)
    for k, v in jtrain.lr_dict(OptimizationConfig(), 1.0, 100).items():
        d[f"lr_{k}"] = np.asarray(v, np.float32)
    npz = dict(d)
    d.update(j_dino=j_dino, j_idm=j_idm, j_rcam=rcam, j_gcams=gcams)
    return npz, d


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": references, "port": {world: [per-rank npz dicts]}}."""
    work = tmp_path_factory.mktemp("ranks")
    npz, d = shared_inputs()
    np.savez(work / "inputs.npz", **npz)
    procs = [(w, r, subprocess.Popen([sys.executable, RANKS, str(r), str(w), str(work)],
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
             for w in WORLDS for r in range(w)]
    try:
        ref = jax_side(d)
        for w, r, p in procs:
            log, _ = p.communicate(timeout=RANK_TIMEOUT)
            assert p.returncode == 0, f"world {w} rank {r}:\n{log.decode()[-4000:]}"
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    port = {w: [dict(np.load(work / f"out{w}_{r}.npz")) for r in range(w)] for w in WORLDS}
    return {"jax": ref, "port": port}


# ------------------------------------------------------------------ mesh


@pytest.mark.parametrize("n", range(1, 9))
def test_factor_2d_and_mesh_shapes(n):
    """The JAX package's shape rules on n ranks of a fake process group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert tmesh._factor_2d(n) == jmesh._factor_2d(n)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        mesh = tmesh.make_mesh(device_type="cpu")
        want = jax_mesh(n)
        assert mesh.mesh_dim_names == want.axis_names == ("data", "rays")
        assert tuple(mesh.shape) == want.devices.shape
        assert tuple(tmesh.make_mesh(axis_names=("gaussians",), device_type="cpu").shape) == (n,)
        with pytest.raises(ValueError):
            tmesh.make_mesh(n + 1, device_type="cpu")
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- pose steps


def _check_pose(got: dict, name: str, want):
    params, aux, grads = want
    np.testing.assert_allclose(got[f"{name}/aux/loss"], aux["loss"], rtol=2e-4)
    assert int(got[f"{name}/aux/n_nan"]) == int(aux["n_nan"])
    for k, v in params.items():
        np.testing.assert_allclose(got[f"{name}/param/{k}"], v, atol=1.5e-3, rtol=5e-3,
                                   err_msg=f"{name} {k}")
    top = max(np.abs(g).max() for g in grads.values())
    for k, g in grads.items():
        atol = 1e-5 * top if k in ZERO_GRAD_PARAMS else 1e-4 * np.abs(g).max() + 1e-12
        np.testing.assert_allclose(got[f"{name}/grad/{k}"], g, rtol=1e-3, atol=atol,
                                   err_msg=f"{name} gradient {k}")


@pytest.mark.parametrize("case", ["finite", "nan"])
def test_sharded_loss_one_rank_matches_batch_loss(runs, case):
    """At world size 1 the sharded loss (its own copy of the softmax over
    rays, the target's scale, the valid count and the masked mean) and its
    gradients equal the port's single-device ``batch_loss_cached``; with a
    NaN image both skip it. Port against port, without JAX."""
    got = runs["port"][1][0]
    pre = f"loss1/{case}"
    keys = [k[len(f"{pre}/single/"):] for k in got if k.startswith(f"{pre}/single/")]
    assert "total" in keys and any(k.startswith("grad/") for k in keys)
    if case == "nan":
        assert int(got[f"{pre}/single/aux/n_nan"]) == 1
    def amax(x):  # the largest finite magnitude (the steps zero the rest)
        return np.abs(np.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)).max()

    top = max(amax(got[f"{pre}/single/{k}"]) for k in keys if k.startswith("grad/"))
    for k in keys:
        want, have = got[f"{pre}/single/{k}"], got[f"{pre}/sharded/{k}"]
        if k.startswith("grad/"):
            # entries whose true value is 0 (the k bias) are f32 noise
            # against the largest gradient
            atol = max(1e-4 * amax(want), 1e-6 * top)
            np.testing.assert_allclose(have, want, rtol=1e-4, atol=atol, equal_nan=True,
                                       err_msg=f"{case} {k}")
        else:
            np.testing.assert_allclose(have, want, rtol=1e-5, err_msg=f"{case} {k}")


@pytest.mark.parametrize("world,name", [(2, "pose_1x2"), (2, "pose_2x1"), (4, "pose_2x2")])
def test_pose_step_matches_jax(runs, world, name):
    """SP, DP and both: the updated id module and the loss against the JAX
    sharded step on a (2, 2) slice, the summed gradients against jax.grad;
    every rank holds the same parameters, bit for bit."""
    ranks = runs["port"][world]
    _check_pose(ranks[0], name, runs["jax"]["pose"])
    for other in ranks[1:]:
        for k, v in ranks[0].items():
            if k.startswith(f"{name}/"):
                np.testing.assert_array_equal(other[k], v, err_msg=k)


def test_cached_step_matches_jax(runs):
    ranks = runs["port"][2]
    _check_pose(ranks[0], "cached_2x1", runs["jax"]["cached"])
    for k, v in ranks[0].items():
        if k.startswith("cached_2x1/"):
            np.testing.assert_array_equal(ranks[1][k], v, err_msg=k)


def test_nan_image_uses_global_masked_mean(runs):
    """Image 1 (of rank 0's two) has a NaN loss: the mean runs over the
    three finite images of the whole batch, not over per-rank means."""
    got, (_, aux, grads) = runs["port"][2][0], runs["jax"]["pose_nan"]
    assert int(aux["n_nan"]) == 1
    # the NaN image's gradients reach the ray MLP and the attention, whose
    # summed gradients the step zeroes; the camera-up head keeps its own
    assert not grads["ray_mlp/l1/w"].any() and grads["cam_up/mlp2/w"].any()
    _check_pose(got, "pose_nan_2x1", runs["jax"]["pose_nan"])
    assert np.isfinite(got["pose_nan_2x1/aux/loss"])


# ------------------------------------------------------------------ render


def test_sharded_render_bands(runs):
    """The bands of the two ranks, stacked, against JAX's sharded render
    and render_eval; each rank composites its own half of the rows."""
    ranks = runs["port"][2]
    rows = [tuple(r["render/rows"]) for r in ranks]
    assert rows == [(0, 16), (16, 32)]
    for r, (a, b) in zip(ranks, rows):
        assert r["render/band"].shape == (3, b - a, 64)
    img = np.concatenate([r["render/band"] for r in ranks], axis=1)
    np.testing.assert_allclose(img, runs["jax"]["render_sharded"], atol=2e-5)
    np.testing.assert_allclose(img, runs["jax"]["render_eval"], atol=2e-5)
    assert img.max() > 0.1


# ---------------------------------------------------------- DP 3DGS step


def _check_gs(got: dict, prefix: str, want: dict):
    np.testing.assert_allclose(got[f"{prefix}/step1/loss"], want["loss"][1], rtol=1e-5)
    np.testing.assert_allclose(got[f"{prefix}/step0/loss"], want["loss"][0], rtol=1e-5)
    np.testing.assert_allclose(got[f"{prefix}/xyz"], want["xyz"], atol=1e-5)
    np.testing.assert_allclose(got[f"{prefix}/xyz_grad_accum"], want["xyz_grad_accum"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got[f"{prefix}/denom"], want["denom"])
    np.testing.assert_array_equal(got[f"{prefix}/max_radii2d"], want["max_radii2d"])


@pytest.mark.parametrize("port,jax_route", [("tiled", "tiled"),
                                            ("pallas", "pallas_interpret")])
def test_dp_gs_step_matches_jax(runs, port, jax_route):
    """Two steps of 8 cameras on 2 ranks against JAX's on 2 devices; the
    state advanced (xyz moved, densification stats counted) and is the same
    on both ranks."""
    ranks = runs["port"][2]
    got = ranks[0]
    _check_gs(got, f"gs_{port}", runs["jax"][f"gs_{jax_route}"])
    assert int(got[f"gs_{port}/step1/grad_dropped"]) == 0
    assert not np.allclose(got[f"gs_{port}/xyz"][:48], scene_arrays(48, seed=6)[0]["xyz"])
    assert got[f"gs_{port}/denom"].max() > 8
    for k, v in got.items():
        if k.startswith(f"gs_{port}/"):
            np.testing.assert_array_equal(ranks[1][k], v, err_msg=k)


@pytest.mark.parametrize("port", ["tiled", "pallas"])
def test_dp_gs_step_one_rank_matches_two(runs, port):
    one, two = runs["port"][1][0], runs["port"][2][0]
    prefix = f"gs_{port}"
    want = {"loss": [float(two[f"{prefix}/step0/loss"]), float(two[f"{prefix}/step1/loss"])],
            **{k: two[f"{prefix}/{k}"] for k in ("xyz", "xyz_grad_accum", "denom",
                                                 "max_radii2d")}}
    _check_gs(one, prefix, want)


def test_every_rank_ran_without_jax(runs):
    for world, ranks in runs["port"].items():
        assert len(ranks) == world
        assert all(bool(r["jax_free"]) for r in ranks)
