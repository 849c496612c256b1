"""Full training-state checkpoints, optimizer included (port of
sixdgs_tpu/train/checkpoint.py; the counterpart of the reference's
``torch.save((gaussians.capture(), iteration))`` -> ``chkpnt<iter>.pth``).

One .npz of flat arrays under the JAX package's key names, shapes and
types, so each package loads the other's checkpoints: scene parameters,
the active mask, both Adam moments per parameter, the step count and the
densification statistics.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from sixdgs_torch.scene.gaussians import PARAM_NAMES, GaussianScene
from sixdgs_torch.train.gs_trainer import GSTrainState
from sixdgs_torch.train.optim import AdamState


def save_train_state(path: str, state: GSTrainState, iteration: int,
                     active_sh_degree: int) -> None:
    def host(t):
        return t.detach().cpu().numpy()

    flat = {
        "iteration": np.asarray(iteration),
        "active_sh_degree": np.asarray(active_sh_degree),
        "max_sh_degree": np.asarray(state.scene.max_sh_degree),
        "active": host(state.scene.active),
        "xyz_grad_accum": host(state.xyz_grad_accum),
        "denom": host(state.denom),
        "max_radii2d": host(state.max_radii2d),
        "adam_step": host(state.adam.step),
    }
    for name in PARAM_NAMES:
        flat[f"param:{name}"] = host(getattr(state.scene, name))
        flat[f"adam_m:{name}"] = host(state.adam.m[name])
        flat[f"adam_v:{name}"] = host(state.adam.v[name])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_train_state(path: str, device="cuda") -> Tuple[GSTrainState, int, int]:
    """Returns (state, iteration, active_sh_degree), the state on ``device``."""
    data = np.load(path)

    def dev(key):
        return torch.tensor(data[key], device=device)

    scene = GaussianScene(
        active=dev("active"),
        max_sh_degree=int(data["max_sh_degree"]),
        **{name: dev(f"param:{name}") for name in PARAM_NAMES},
    )
    adam = AdamState(
        m={name: dev(f"adam_m:{name}") for name in PARAM_NAMES},
        v={name: dev(f"adam_v:{name}") for name in PARAM_NAMES},
        step=dev("adam_step"),
    )
    state = GSTrainState(
        scene=scene,
        adam=adam,
        xyz_grad_accum=dev("xyz_grad_accum"),
        denom=dev("denom"),
        max_radii2d=dev("max_radii2d"),
    )
    return state, int(data["iteration"]), int(data["active_sh_degree"])
