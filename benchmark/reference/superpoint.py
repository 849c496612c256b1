"""Plain reference of the SuperPoint descriptor backbone (arXiv:1712.07629)
as the 6DGS pose stage uses it: 256-wide descriptors on the stride-8 grid
of a normalised 224 x 224 crop, L2-normalised over channels.

Weights are read by the superpoint_v1.pth key names: the VGG encoder
(conv1a ... conv4b, 64-64-128-128, 3 x 3, ReLU, 2 x 2 max-pool after
conv1b, conv2b, conv3b) and the descriptor head (convDa 3 x 3 to 256,
ReLU, convDb 1 x 1). The grey-level conv1a is applied to each colour
channel and summed (the 6DGS reference repeats its weight over three input
channels). Imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.pose_common import conv

GRID = 28
DIM = 256
ENCODER = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b", "conv4a", "conv4b")


def features(w, x, dt=torch.float32):
    """[3, 224, 224] -> [784, 256] unit descriptors."""
    h = x[None]
    for i, name in enumerate(ENCODER):
        wt = w[name + ".weight"]
        if wt.shape[1] == 1:
            wt = wt.expand(wt.shape[0], h.shape[1], *wt.shape[2:])
        h = F.relu(conv(h, wt, w[name + ".bias"], dt, padding=1))
        if i in (1, 3, 5):
            h = F.max_pool2d(h, 2, 2)
    h = F.relu(conv(h, w["convDa.weight"], w["convDa.bias"], dt, padding=1))
    d = conv(h, w["convDb.weight"], w["convDb.bias"], dt)[0]
    d = d / torch.linalg.norm(d, dim=0, keepdim=True)
    return d.permute(1, 2, 0).reshape(GRID * GRID, DIM)
