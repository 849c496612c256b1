"""Point-cloud normal estimation via local PCA.

Port of sixdgs_tpu/rays/normals.py (reference
pose_estimation/sampling.py:28-113): k-NN including the query point itself,
neighborhood covariance, smallest-eigenvector normal, and the
Tombari-style sign disambiguation. ``torch.topk`` may order tied distances
differently from ``jax.lax.top_k``; only the neighbour set enters the
covariance.
"""

from __future__ import annotations

import torch

from sixdgs_torch.ops.sym_eig import sym_eig_3x3


def disambiguate_vector_directions(df: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Flip vecs to agree with the majority of neighborhood offsets
    (sampling.py:37-59). df: [N, K, 3]; vecs: [N, 3]."""
    K = df.shape[-2]
    proj = torch.sum(vecs[:, None, :] * df, dim=-1)  # [N, K]
    n_pos = torch.sum((proj > 0).to(df.dtype), dim=-1, keepdim=True)
    flip = (n_pos < 0.5 * K).to(df.dtype)
    return (1.0 - 2.0 * flip) * vecs


def estimate_normals(points: torch.Tensor, k_neighbors: int = 20,
                     valid: torch.Tensor | None = None) -> torch.Tensor:
    """Normals for each point of a (possibly padded) point set.

    Args:
        points: [N, 3].
        k_neighbors: neighborhood size, including the point itself.
        valid: optional [N] bool; invalid points are pushed to 1e12 so they
            are never neighbors of valid ones.

    Returns:
        [N, 3] unit normals.
    """
    pts = points
    if valid is not None:
        pts = torch.where(valid[:, None], points, torch.full_like(points, 1e12))
    sq = torch.sum(torch.square(pts), dim=-1)
    d = sq[:, None] + sq[None, :] - 2.0 * (pts @ pts.T)
    _, idx = torch.topk(-d, k_neighbors, dim=-1)  # includes self (distance 0)
    neigh = pts[idx]  # [N, K, 3]
    mean = torch.mean(neigh, dim=-2, keepdim=True)
    centered = neigh - mean
    cov = torch.einsum("nki,nkj->nij", centered, centered)
    _, vecs = sym_eig_3x3(cov)
    normal = disambiguate_vector_directions(centered, vecs[:, :, 0])
    return normal / torch.clamp_min(torch.linalg.norm(normal, dim=-1, keepdim=True), 1e-12)
