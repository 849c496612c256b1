"""Camera-up output augmentations (mostly-off options).

Port of sixdgs_tpu/pose/cam_augmentations.py (reference
pose_estimation/cam_augmentations.py:5-51); the default path is NONE
(identification_module.py:11,26-36). The reference's NormalizationReverser
registers the MEAN as both buffers (":14" ``self.register_buffer("std",
mean)``); as in the reference package, the intended behaviour (std as std)
is implemented and the upstream bug documented.
"""

from __future__ import annotations

import enum

import torch


class OutputAugmentationTypes(enum.Enum):
    NONE = 1
    NORMAL = 2
    REVERSE_POS_ENC = 3


def make_normalization_reverser(targets: torch.Tensor):
    """x -> x * std + mean over the target distribution (population std, as
    jnp.std)."""
    flat = targets.reshape(-1, targets.shape[-1])
    mean = torch.mean(flat, dim=0)
    std = torch.std(flat, dim=0, correction=0)

    def apply(x):
        return x * std + mean

    return apply


def make_reverse_pos_enc(augmentation_channels: int = 10):
    """Inverse positional-encoding aggregation (cam_augmentations.py:37-47,
    "second version")."""
    frac = 1.0 / augmentation_channels

    def apply(x):
        freq_bands = 2.0 ** torch.arange(augmentation_channels, dtype=torch.float32,
                                         device=x.device)
        xv = x.reshape(*x.shape[:-1], -1, augmentation_channels + 1)
        return frac * torch.sum(
            torch.arcsin(torch.clamp(xv[..., 1:], -1.0, 1.0)) / freq_bands
            + xv[..., 0, None],
            dim=-1,
        )

    return apply
