"""Image metrics: SSIM / PSNR / L1 (port of sixdgs_tpu/ops/ssim.py).

SSIM is the reference's (utils/loss_utils.py:25-83): 11x11 Gaussian window
(sigma 1.5), zero ("same") padding, per channel, C1 = 0.01^2, C2 = 0.03^2.
The window is separable, and the blur is written as two passes of 11
weighted slice-adds over all five moments at once (a [15, H, W] stack), in
exact float32: sigma = blur(x^2) - mu^2 cancels in flat regions against
C2 = 9e-4, which a convolution run in TF32 (cuDNN's default for float32)
would drown in rounding noise.
"""

from __future__ import annotations

import numpy as np
import torch


def _window_1d(window_size: int, sigma: float) -> np.ndarray:
    xs = np.arange(window_size, dtype=np.float64)
    g = np.exp(-np.square(xs - window_size // 2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _blur(stack: torch.Tensor, window_size: int, sigma: float) -> torch.Tensor:
    """Separable zero-padded "same" Gaussian blur of [B, H, W]."""
    half = window_size // 2
    g = _window_1d(window_size, sigma)
    h, w = stack.shape[-2], stack.shape[-1]
    xp = torch.nn.functional.pad(stack, (0, 0, half, half))
    y = float(g[0]) * xp[:, 0:h, :]
    for o in range(1, window_size):
        y = torch.add(y, xp[:, o:o + h, :], alpha=float(g[o]))
    yp = torch.nn.functional.pad(y, (half, half))
    out = float(g[0]) * yp[:, :, 0:w]
    for o in range(1, window_size):
        out = torch.add(out, yp[:, :, o:o + w], alpha=float(g[o]))
    return out


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM of two [C, H, W] images in [0, 1]."""
    c = img1.shape[0]
    stack = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=0)
    bl = _blur(stack, window_size, 1.5)
    mu1, mu2 = bl[0:c], bl[c:2 * c]
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = bl[2 * c:3 * c] - mu1_sq
    sigma2_sq = bl[3 * c:4 * c] - mu2_sq
    sigma12 = bl[4 * c:5 * c] - mu1_mu2
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return torch.mean(ssim_map)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """PSNR in dB for images in [0, 1] (utils/image_utils.py:19-23)."""
    mse = torch.mean(torch.square(img1 - img2))
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def l2_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(a - b))


def dssim_l1_loss(img: torch.Tensor, gt: torch.Tensor, lambda_dssim: float = 0.2):
    """The 3DGS photometric loss 0.8 L1 + 0.2 (1 - SSIM) (train.py:117-121):
    (loss, l1)."""
    ll1 = l1_loss(img, gt)
    return (1.0 - lambda_dssim) * ll1 + lambda_dssim * (1.0 - ssim(img, gt)), ll1
