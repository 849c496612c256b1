"""Scene & data layer: Gaussian scene, PLY IO, dataset loaders, cameras."""

from sixdgs_torch.scene.gaussians import GaussianScene
from sixdgs_torch.scene.structures import BasicPointCloud, CameraInfo, SceneInfo
from sixdgs_torch.scene.dataset_loader import load_data, get_dataset_prefix

__all__ = [
    "GaussianScene",
    "BasicPointCloud",
    "CameraInfo",
    "SceneInfo",
    "load_data",
    "get_dataset_prefix",
]
