"""One gloo rank of tests/test_torch_parallel.py: the port's sharded steps on
the CPU.

    python tests/torch_parallel_ranks.py RANK WORLD WORKDIR

reads WORKDIR/inputs.npz (numpy arrays written by the test), joins a gloo
group of WORLD ranks through WORKDIR/init<WORLD>, runs every case of its
world size and writes WORKDIR/out<WORLD>_<RANK>.npz. It imports neither jax
nor sixdgs_tpu, and fails if either is loaded.
"""

from __future__ import annotations

import copy
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sixdgs_torch import weights  # noqa: E402
from sixdgs_torch.parallel import gs_sharding, pose_sharding  # noqa: E402
from sixdgs_torch.parallel.mesh import make_mesh  # noqa: E402
from sixdgs_torch.pose import trainer as ttr  # noqa: E402
from sixdgs_torch.rays.engine import Rays  # noqa: E402
from sixdgs_torch.scene.gaussians import PARAM_NAMES, from_arrays  # noqa: E402
from sixdgs_torch.train import gs_trainer as gs  # noqa: E402
from torch_threads import held_at  # noqa: E402 (tests/torch_threads.py)

CAM_FIELDS = ("view", "full_proj", "camera_center", "tan_fovx", "tan_fovy")


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x))


def _tree(data, prefix: str):
    return ttr._nest({k[len(prefix):]: data[k] for k in data.files if k.startswith(prefix)})


def _rays(data, prefix: str) -> Rays:
    return Rays(*(_t(data[f"{prefix}{f}"]) for f in Rays._fields))


def _pose_case(out, name, data, shape, cached=False, nan=False):
    """One sharded id-module step from the shared weights: the updated
    parameters and the step's gradients (summed over the mesh, non-finite
    entries zeroed) in the JAX package's names, and the global aux."""
    mesh = make_mesh(axis_names=("data", "rays"), shape=shape, device_type="cpu")
    idm = weights.id_module_from_numpy(_tree(data, "idm/"), device="cpu")
    opt = ttr.make_adafactor(idm.parameters())
    rays = _rays(data, "frays_" if cached else "rays_")
    up = _t(data["model_up"])
    if cached:
        fb = ttr.FeatureBatch(*(_t(data[f"fb_{f}"]) for f in ttr.FeatureBatch._fields))
        fb, rays = pose_sharding.shard_feature_inputs(mesh, fb, rays)
        aux = pose_sharding.make_sharded_pose_step_cached(mesh)(idm, opt, fb, rays, up)
    else:
        dino = weights.dino_from_numpy(_tree(data, "dino/"), device="cpu").eval()
        batch = ttr.PoseBatch(_t(data["images"]), _t(data["masks"]),
                              _t(data["c2w_nan" if nan else "c2w"]))
        batch, rays = pose_sharding.shard_pose_inputs(mesh, batch, rays)
        aux = pose_sharding.make_sharded_pose_step(mesh)(idm, opt, dino, batch, rays, up)
    for k, v in ttr._flatten(weights.id_module_to_numpy(idm)).items():
        out[f"{name}/param/{k}"] = v
    grads = copy.deepcopy(idm)
    with torch.no_grad():
        for g, p in zip(grads.parameters(), idm.parameters()):
            g.copy_(p.grad)
    for k, v in ttr._flatten(weights.id_module_to_numpy(grads)).items():
        out[f"{name}/grad/{k}"] = v
    for k, v in aux.items():
        out[f"{name}/aux/{k}"] = v.numpy()


def _loss_case(out, data):
    """At one rank, the sharded loss and its gradients beside the
    single-device ``batch_loss_cached`` of the port, with and without a NaN
    image: a drift between the two copies of the loss shows without JAX."""
    mesh = make_mesh(axis_names=("data", "rays"), device_type="cpu")
    rays = _rays(data, "frays_")
    up = _t(data["model_up"])
    fb = ttr.FeatureBatch(*(_t(data[f"fb_{f}"]) for f in ttr.FeatureBatch._fields))
    c2w_nan = fb.c2w.clone()
    c2w_nan[1, 0, 3] = float("nan")
    for case, batch in (("finite", fb), ("nan", fb._replace(c2w=c2w_nan))):
        idm = weights.id_module_from_numpy(_tree(data, "idm/"), device="cpu")
        for side, fn in (("sharded", lambda: pose_sharding._sharded_batch_loss(
                              mesh, idm, batch, rays, up)),
                         ("single", lambda: ttr.batch_loss_cached(idm, batch, rays, up))):
            idm.zero_grad(set_to_none=True)
            total, aux = fn()
            total.backward()
            out[f"loss1/{case}/{side}/total"] = total.detach().numpy()
            for k, v in aux.items():
                out[f"loss1/{case}/{side}/aux/{k}"] = v.detach().numpy()
            for (k, p) in idm.named_parameters():
                out[f"loss1/{case}/{side}/grad/{k}"] = p.grad.numpy().copy()


def _render_case(out, data, world):
    mesh = make_mesh(axis_names=("gaussians",), device_type="cpu")
    scene = from_arrays({k: data[f"r_{k}"] for k in PARAM_NAMES}, max_sh_degree=3,
                        capacity=int(data["r_capacity"]), device="cpu")
    params, active = pose_sharding.shard_scene(mesh, scene.params(), scene.active)
    cam = gs.CameraArrays(*(_t(data[f"rcam_{f}"]) for f in CAM_FIELDS))
    h, w = data["rcam_hw"]
    render = pose_sharding.make_sharded_render(mesh, int(w), int(h), 3, chunk=64)
    out["render/band"] = render(params, active, cam, torch.zeros(3)).numpy()
    out["render/rows"] = np.asarray(pose_sharding.band_rows(int(h), world, dist.get_rank()))


def _gs_case(out, data, rasterizer):
    """Two DP 3DGS steps on the camera batch."""
    mesh = make_mesh(axis_names=("data",), device_type="cpu")
    cams = gs.CameraArrays(*(_t(data[f"gcam_{f}"]) for f in gs.CameraArrays._fields))
    h, w = cams.gt_image.shape[-2:]
    step = gs_sharding.make_sharded_gs_step(mesh, width=w, height=h, sh_degree=3, chunk=64,
                                            rasterizer=rasterizer)
    state = gs.init_train_state(from_arrays({k: data[f"g_{k}"] for k in PARAM_NAMES},
                                            max_sh_degree=3,
                                            capacity=int(data["g_capacity"]),
                                            device="cpu"))
    local = gs_sharding.shard_camera_batch(mesh, cams)
    lrs = {k[len("lr_"):]: float(data[k]) for k in data.files if k.startswith("lr_")}
    for i in range(2):
        state, m = step(state, local, torch.zeros(3), lrs)
        for k, v in m.items():
            out[f"gs_{rasterizer}/step{i}/{k}"] = v.numpy()
    for k in PARAM_NAMES:
        out[f"gs_{rasterizer}/{k}"] = getattr(state.scene, k).numpy()
    for k in ("xyz_grad_accum", "denom", "max_radii2d"):
        out[f"gs_{rasterizer}/{k}"] = getattr(state, k).numpy()


def main(rank: int, world: int, workdir: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{workdir}/init{world}",
                            rank=rank, world_size=world)
    data = np.load(os.path.join(workdir, "inputs.npz"))
    out = {}
    if world == 1:
        _loss_case(out, data)
    elif world == 4:
        _pose_case(out, "pose_2x2", data, (2, 2))
    elif world == 2:
        _pose_case(out, "pose_1x2", data, (1, 2))
        _pose_case(out, "pose_2x1", data, (2, 1))
        _pose_case(out, "pose_nan_2x1", data, (2, 1), nan=True)
        _pose_case(out, "cached_2x1", data, (2, 1), cached=True)
        _render_case(out, data, world)
    for rasterizer in ("tiled", "pallas"):
        if world in (1, 2):
            _gs_case(out, data, rasterizer)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "sixdgs_tpu"))
    if loaded:
        raise AssertionError(f"rank {rank} loaded {loaded[:5]}")
    out["jax_free"] = np.asarray(True)
    np.savez(os.path.join(workdir, f"out{world}_{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    with held_at(1):  # up to four ranks at once inside one test worker
        main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
