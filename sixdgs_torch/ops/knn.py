"""Exact k-nearest neighbours by chunked brute force (port of
sixdgs_tpu/ops/knn.py; the reference initializes scales with a Morton-box
approximate 3-NN, ``distCUDA2``, and estimates normals from a chunked
cdist + topk 20-NN).

A chunk of queries against all points is one matrix product
(|x|^2 + |y|^2 - 2 x.y) and one top-k; peak memory is chunk x N floats.
Float32 matrix products run in full float32 on the card (TF32 is off for
matmuls by default), which the neighbour order needs.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def _knn_sq_dists(points: torch.Tensor, k: int, chunk: int):
    """[N, 3] -> (sq_dists [N, k], indices [N, k]) of the k nearest OTHER
    points, nearest first."""
    points = points.to(torch.float32)
    n = points.shape[0]
    sq_norms = torch.sum(torch.square(points), dim=-1)
    cols = torch.arange(n, device=points.device)
    dists, idx = [], []
    for start in range(0, n, chunk):
        q = points[start:start + chunk]
        d = sq_norms[start:start + chunk, None] + sq_norms[None, :] - 2.0 * (q @ points.T)
        d = torch.clamp_min(d, 0.0)
        d[cols[start:start + chunk] - start, cols[start:start + chunk]] = float("inf")
        neg_top, i = torch.topk(-d, k, dim=1)
        dists.append(-neg_top)
        idx.append(i)
    return torch.cat(dists), torch.cat(idx)


def mean_sq_dist_3nn(points: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """Mean squared distance to the 3 nearest neighbours per point (exact;
    stands in for ``simple_knn._C.distCUDA2``, gaussian_model.py:203-205)."""
    dists, _ = _knn_sq_dists(points, k=3, chunk=chunk)
    return torch.mean(dists, dim=-1)


def knn_indices(points: torch.Tensor, k: int = 20, chunk: int = 1024) -> torch.Tensor:
    """Indices of the k nearest neighbours (excluding self) per point. The
    reference includes the query point in its 20-NN (sampling.py:77-80);
    callers that want that prepend the query index."""
    _, idx = _knn_sq_dists(points, k=k, chunk=chunk)
    return idx
