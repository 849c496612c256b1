"""GaussianScene: the 3DGS parameter container as a dataclass of tensors.

Port of sixdgs_tpu/scene/gaussians.py. The scene keeps the fixed-capacity
layout of the reference package: arrays are padded to a capacity bucket and
``active`` marks the live Gaussians; padded entries get an identity
quaternion and opacity -15 so they never contribute. Same parameterization:
log-scale, sigmoid-opacity, unnormalized quaternion, SH features split
dc/rest.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from sixdgs_torch.ops.knn import mean_sq_dist_3nn
from sixdgs_torch.ops.sh import rgb_to_sh
from sixdgs_torch.ops.transforms import (
    build_a_mat,
    build_covariance,
    build_covariance_6,
    inverse_sigmoid,
    log32,
    quat_to_rotmat,
)
from sixdgs_torch.scene import ply_io
from sixdgs_torch.scene.structures import BasicPointCloud

CAPACITY_BUCKET = 16384

PARAM_NAMES = ("xyz", "features_dc", "features_rest", "opacity", "scaling", "rotation")


def round_capacity(n: int, bucket: int = CAPACITY_BUCKET) -> int:
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


@dataclasses.dataclass
class GaussianScene:
    """Capacity-padded Gaussian scene.

    Parameter tensors (shape [C, ...]): xyz, features_dc [C,1,3],
    features_rest [C,R,3], opacity [C,1] (pre-sigmoid), scaling [C,3] (log),
    rotation [C,4] (unnormalized quat). ``active`` [C] bool marks live
    Gaussians.
    """

    xyz: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    opacity: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    active: torch.Tensor
    max_sh_degree: int = 3

    # ------------------------------------------------------------ accessors
    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def num_active(self) -> torch.Tensor:
        return torch.sum(self.active.to(torch.int32))

    @property
    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    @property
    def get_rotation(self) -> torch.Tensor:
        return self.rotation / torch.linalg.norm(self.rotation, dim=-1, keepdim=True)

    @property
    def get_opacity(self) -> torch.Tensor:
        """Sigmoid opacity, zeroed on padded entries."""
        return torch.sigmoid(self.opacity) * self.active[:, None]

    @property
    def get_features(self) -> torch.Tensor:
        """[C, (deg+1)**2, 3] full SH coefficients (gaussian_model.py:141-144)."""
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def get_rotation_mat(self) -> torch.Tensor:
        return quat_to_rotmat(self.rotation)

    def get_covariance(self, scaling_modifier: float = 1.0) -> torch.Tensor:
        return build_covariance_6(self.get_scaling, self.rotation, scaling_modifier)

    def get_covariance_mat(self, scaling_modifier: float = 1.0) -> torch.Tensor:
        return build_covariance(self.get_scaling, self.rotation, scaling_modifier)

    def get_a_mat(self, scaling_modifier: float = 1.0) -> torch.Tensor:
        return build_a_mat(self.get_scaling, self.rotation, scaling_modifier)

    # ------------------------------------------------------------- params
    def params(self) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in PARAM_NAMES}

    def with_params(self, params: Dict[str, torch.Tensor]) -> "GaussianScene":
        return dataclasses.replace(self, **params)

    # ---------------------------------------------------------------- IO
    def to_numpy_active(self) -> Dict[str, np.ndarray]:
        """Live Gaussians as host numpy arrays (for PLY)."""
        mask = self.active.cpu().numpy()
        return {name: getattr(self, name).detach().cpu().numpy()[mask]
                for name in PARAM_NAMES}

    def save_ply(self, path: str) -> None:
        ply_io.save_gaussian_ply(path, **self.to_numpy_active())


def _pad(arr: np.ndarray, capacity: int, fill: float = 0.0) -> np.ndarray:
    n = arr.shape[0]
    if n == capacity:
        return arr
    out = np.full((capacity,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[:n] = arr
    return out


def from_arrays(
    arrays: Dict[str, np.ndarray],
    max_sh_degree: int,
    capacity: Optional[int] = None,
    device="cuda",
) -> GaussianScene:
    """Build a padded scene on ``device`` from host arrays of live Gaussians."""
    n = arrays["xyz"].shape[0]
    cap = capacity or round_capacity(n)
    if cap < n:
        raise ValueError(f"capacity {cap} < number of gaussians {n}")
    active = np.zeros(cap, bool)
    active[:n] = True
    padded = {name: _pad(np.asarray(arrays[name], np.float32), cap) for name in PARAM_NAMES}
    # padded quaternions must stay normalizable; padded opacities very negative
    padded["rotation"][n:, 0] = 1.0
    padded["opacity"][n:] = -15.0
    kw = {name: torch.tensor(v, device=device) for name, v in padded.items()}
    return GaussianScene(active=torch.tensor(active, device=device),
                         max_sh_degree=max_sh_degree, **kw)


def create_from_pcd(pcd: BasicPointCloud, max_sh_degree: int = 3,
                    capacity: Optional[int] = None, device="cuda") -> GaussianScene:
    """Initialize from a point cloud (gaussian_model.py:189-228): DC SH from
    colors, isotropic log-scale from sqrt(mean 3-NN squared distance),
    identity rotation, opacity inverse_sigmoid(0.1). The 3-NN runs on
    ``device``."""
    pts = np.asarray(pcd.points, np.float32)
    n = pts.shape[0]
    fused_color = rgb_to_sh(torch.tensor(np.asarray(pcd.colors, np.float32))).numpy()
    dist2 = mean_sq_dist_3nn(torch.tensor(pts, device=device)).cpu().numpy()
    # log32: the same float32 on every host (ops/transforms.py)
    scales = log32(np.sqrt(np.maximum(dist2, 1e-7)))[:, None].repeat(3, axis=1)
    rots = np.zeros((n, 4), np.float32)
    rots[:, 0] = 1.0
    opacities = inverse_sigmoid(0.1 * torch.ones((n, 1), dtype=torch.float32)).numpy()
    return from_arrays(
        {
            "xyz": pts,
            "features_dc": fused_color.reshape(n, 1, 3),
            "features_rest": np.zeros((n, (max_sh_degree + 1) ** 2 - 1, 3), np.float32),
            "opacity": opacities,
            "scaling": scales.astype(np.float32),
            "rotation": rots,
        },
        max_sh_degree=max_sh_degree,
        capacity=capacity,
        device=device,
    )


def load_ply(path: str, max_sh_degree: int = 3, capacity: Optional[int] = None,
             device="cuda") -> GaussianScene:
    """Load a reference-format checkpoint PLY (gaussian_model.py:342-420)."""
    arrays = ply_io.load_gaussian_ply(path, max_sh_degree)
    return from_arrays(arrays, max_sh_degree=max_sh_degree, capacity=capacity,
                       device=device)
