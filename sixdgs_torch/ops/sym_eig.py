"""Closed-form batched eigendecomposition of symmetric 3x3 matrices.

Port of sixdgs_tpu/ops/sym_eig.py, algorithm unchanged: deflate the trace,
take the eigenvalues from the characteristic polynomial through the
trigonometric form of Cardano, and recover eigenvectors from cross products
of the rows of (A - lam I), with branch-free fallbacks for repeated
eigenvalues. ``torch.linalg.eigh`` is not used: its eigenvector signs differ,
and the signs feed ``rays.normals.disambiguate_vector_directions``.

Returns eigenvalues ascending and eigenvectors as COLUMNS.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def _unit(axis: int, like: torch.Tensor) -> torch.Tensor:
    e = torch.zeros_like(like)
    e[..., axis] = 1.0
    return e


def _det3(B: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] by cofactor expansion."""
    return torch.sum(B[..., 0, :] * torch.linalg.cross(B[..., 1, :], B[..., 2, :]),
                     dim=-1)


def _orthonormal_complement(v: torch.Tensor) -> torch.Tensor:
    """A unit vector orthogonal to v[..., 3], branch-free."""
    # helper axis least aligned with v
    helper = torch.where((torch.abs(v[..., 0]) > 0.9)[..., None],
                         _unit(2, v), _unit(0, v))
    w = torch.linalg.cross(v, helper)
    return w / torch.clamp_min(torch.linalg.norm(w, dim=-1, keepdim=True), _EPS)


def _eigvec_for(A: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Eigenvector of A [..., 3, 3] for eigenvalue lam [...] via the
    cross-product of the two most independent rows of (A - lam I)."""
    B = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
    c01 = torch.linalg.cross(r0, r1)
    c02 = torch.linalg.cross(r0, r2)
    c12 = torch.linalg.cross(r1, r2)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    # the cross product with the largest norm
    best = torch.where(
        ((n01 >= n02) & (n01 >= n12))[..., None],
        c01,
        torch.where((n02 >= n12)[..., None], c02, c12),
    )
    nbest = torch.maximum(n01, torch.maximum(n02, n12))
    # Degenerate: (A - lam I) has rank <= 1 -> every row pair is parallel.
    # Fall back to any unit vector orthogonal to the largest row.
    rn0 = torch.sum(r0 * r0, dim=-1)
    rn1 = torch.sum(r1 * r1, dim=-1)
    rn2 = torch.sum(r2 * r2, dim=-1)
    biggest_row = torch.where(
        ((rn0 >= rn1) & (rn0 >= rn2))[..., None],
        r0,
        torch.where((rn1 >= rn2)[..., None], r1, r2),
    )
    rn_max = torch.maximum(rn0, torch.maximum(rn1, rn2))
    safe_row = torch.where(
        (rn_max > _EPS)[..., None],
        biggest_row / torch.sqrt(torch.clamp_min(rn_max, _EPS))[..., None],
        _unit(2, biggest_row),
    )
    fallback = _orthonormal_complement(safe_row)
    v = torch.where((nbest > _EPS)[..., None], best, fallback)
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), _EPS)


def sym_eig_3x3(A: torch.Tensor, eigenvectors: bool = True):
    """Batched symmetric 3x3 eigendecomposition.

    Args:
        A: [..., 3, 3] symmetric matrices.
        eigenvectors: also compute eigenvectors.

    Returns:
        (eigvals [..., 3] ascending, eigvecs [..., 3, 3] with eigvecs[..., :, i]
        the i-th eigenvector) or just eigvals.
    """
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    A = 0.5 * (A + A.transpose(-1, -2))
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    B = A - q[..., None, None] * eye
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp_min(p2, _EPS * _EPS))
    r = _det3(B) / (2.0 * p**3)
    r = torch.clamp(r, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    # eigenvalues in ascending order
    lam2 = q + 2.0 * p * torch.cos(phi)  # largest
    lam0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    lam1 = 3.0 * q - lam0 - lam2
    # Near-isotropic matrices: p ~ 0 -> all eigenvalues = q.
    iso = p2 <= (_EPS * torch.clamp_min(q * q, 1.0))
    lam0 = torch.where(iso, q, lam0)
    lam1 = torch.where(iso, q, lam1)
    lam2 = torch.where(iso, q, lam2)
    eigvals = torch.stack([lam0, lam1, lam2], dim=-1)

    if not eigenvectors:
        return eigvals

    v0 = _eigvec_for(A, lam0)
    v2 = _eigvec_for(A, lam2)
    # Enforce orthogonality: v2 <- v2 - (v2.v0) v0, then v1 = v2 x v0.
    v2 = v2 - torch.sum(v2 * v0, dim=-1, keepdim=True) * v0
    v2n = torch.linalg.norm(v2, dim=-1, keepdim=True)
    v2 = torch.where(v2n > _EPS, v2 / torch.clamp_min(v2n, _EPS),
                     _orthonormal_complement(v0))
    v1 = torch.linalg.cross(v2, v0)
    # Isotropic fallback: identity basis.
    vecs = torch.stack([v0, v1, v2], dim=-1)  # columns
    vecs = torch.where(iso[..., None, None], eye.expand(A.shape), vecs)
    return eigvals, vecs
