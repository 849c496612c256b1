"""The system under test, built from the benchmark's inputs through the
program's public loaders: a torch.hub DINOv2 or superpoint_v1 state dict
through the backbone's ``convert_torch_state_dict``, the id module through
``weights.id_module_from_numpy`` (the 6DGS checkpoint tree), the scene as a
``GaussianScene`` of the benchmark's tensors, the pose-stage settings as a
``PoseEstimationConfig``. Only the port (``sixdgs_torch``) is imported.
"""

from __future__ import annotations

import torch

from benchmark import inputs


def pose_config(config):
    from sixdgs_torch.utils.config import PoseEstimationConfig

    p = config["pose"]
    keys = ("n_iterations", "gradient_accumulation_steps", "renewal_every_n_iterations",
            "val_every_n_iterations", "rays_to_output", "quadricell_targets",
            "max_ellipsoids", "knn_normals", "ray_budget")
    return PoseEstimationConfig(backbone_type=config["backbone"]["type"],
                                **{k: p[k] for k in keys if k in p})


def backbone_name(config) -> str:
    return config["backbone"]["type"]


def backbone(config, state, device):
    """The frozen backbone module with ``state`` (published key names)."""
    if config["backbone"]["type"] == "dino":
        from sixdgs_torch.pose.dino import DinoViT, convert_torch_state_dict

        sd = convert_torch_state_dict(state)
        with torch.device("meta"):
            model = DinoViT(sd["cls_token"].shape[1], config["backbone"]["num_hidden_layers"],
                            num_patches=sd["pos_embed"].shape[0] - 1)
    else:
        from sixdgs_torch.pose.superpoint import SuperPoint, convert_torch_state_dict

        sd = convert_torch_state_dict(state)
        with torch.device("meta"):
            model = SuperPoint()
    model.load_state_dict(sd, assign=True)
    return model.to(device).requires_grad_(False)


def id_module(leaves, device):
    from sixdgs_torch.weights import id_module_from_numpy

    tree = inputs.nest({k: v.detach().cpu().numpy() for k, v in leaves.items()})
    return id_module_from_numpy(tree, device=device)


def gaussian_scene(config, leaves):
    from sixdgs_torch.scene.gaussians import GaussianScene

    n = leaves["xyz"].shape[0]
    return GaussianScene(active=torch.ones(n, dtype=torch.bool, device=leaves["xyz"].device),
                         max_sh_degree=config["scene"]["sh_degree"], **leaves)


def rays(config, scene, select, slots):
    """One ray set cast from ``scene`` with the benchmark's draws."""
    from sixdgs_torch.rays.engine import generate_rays_from_scene

    p = config["pose"]
    return generate_rays_from_scene(scene, cfg=pose_config(config), r_max=p["ring_slots"],
                                    p_max=p["ring_points"], select_priority=select,
                                    slot_priority=slots)


def as_ray_dict(r):
    """A program ``Rays`` as the reference's dict of tensors."""
    return {"ori": r.ori, "dir": r.dir, "rgb": r.rgb, "valid": r.valid,
            "gidx": r.gaussian_idx.to(torch.long)}
