"""Quadricell: near-uniform point sampling on ellipsoid surfaces.

Port of sixdgs_tpu/rays/quadricell.py (reference
pose_estimation/quadricell.py): Ramanujan-type ellipse perimeter, Thomsen
ellipsoid surface (p = 1.6075), ring counts from the two principal ellipse
perimeters, per-ring point counts from ring perimeters, and the degraded
mask rings >= target. Points sit at uniform angles on a dense
[E, R_MAX, P_MAX] grid with validity masks, as in the reference package.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


def ellipse_perimeter(b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Ramanujan-type approximation (quadricell.py:86-97)."""
    return math.pi * (
        (b + c)
        + (3 * torch.square(b - c))
        / (10 * (b + c) + torch.sqrt(torch.square(b) + 14 * b * c + torch.square(c)))
    )


def ellipsoid_surface(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Thomsen approximation, p = 1.6075 (quadricell.py:163-168)."""
    p = 1.6075
    return (4 * math.pi) * torch.pow(
        (torch.pow(a * b, p) + torch.pow(a * c, p) + torch.pow(b * c, p)) / 3.0,
        1.0 / p,
    )


def ring_layout(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                target_points: int = 50):
    """Ring counts and target cell side per ellipsoid (quadricell.py:191-207).

    Returns (total_rings [E] int32, square_side [E]).
    """
    cell_surface = ellipsoid_surface(a, b, c) / float(target_points)
    side = torch.sqrt(cell_surface)
    rings_b = torch.floor(ellipse_perimeter(a, b) / (2 * side))
    rings_c = torch.floor(ellipse_perimeter(a, c) / (2 * side))
    total_rings = ((rings_b + rings_c) * 0.5).to(torch.int32)
    return total_rings, side


def mask_degraded_ellipsoids(a, b, c, target_points: int = 50) -> torch.Tensor:
    """True for usable ellipsoids: rings < target (quadricell.py:171-188)."""
    total_rings, _ = ring_layout(a, b, c, target_points)
    return total_rings < target_points


class QuadricellGrid(NamedTuple):
    points: torch.Tensor  # [E, R_MAX, P_MAX, 3] local surface points
    valid: torch.Tensor  # [E, R_MAX, P_MAX] bool


def quadricell_points(
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    target_points: int = 50,
    r_max: int = 50,
    p_max: int = 32,
) -> QuadricellGrid:
    """Near-uniform surface points per ellipsoid, fixed-shape.

    Local frame as in the reference: rings stacked along the *a* axis as z
    (quadricell.py:100-106,302-317), ring ellipse spanned by (b, c) in the
    local (x, y) plane.
    """
    total_rings, side = ring_layout(a, b, c, target_points)  # [E]
    ring_idx = torch.arange(r_max, dtype=a.dtype, device=a.device)  # [R]
    rings_f = torch.clamp_min(total_rings.to(a.dtype), 1.0)

    # ring height: z = 0.5*dz + dz*r - a, dz = 2a/rings (quadricell.py:100-103,310-311)
    dz = (2.0 * a[:, None]) / rings_f[:, None]  # [E, 1]
    z = 0.5 * dz + dz * ring_idx[None, :] - a[:, None]  # [E, R]

    # ring minor axes: axis * sqrt(1 - (x-a)^2/a^2), x = z + a (quadricell.py:100-106)
    shrink = torch.sqrt(torch.clamp_min(1.0 - torch.square(z / a[:, None]), 0.0))
    b_r = b[:, None] * shrink
    c_r = c[:, None] * shrink

    # points per ring: floor(perimeter / side) (quadricell.py:145-148)
    ppr = torch.floor(ellipse_perimeter(b_r, c_r) / side[:, None])  # [E, R]
    ppr = torch.clamp_max(ppr, float(p_max))
    ppr_safe = torch.clamp_min(ppr, 1.0)

    p_idx = torch.arange(p_max, dtype=a.dtype, device=a.device)  # [P]
    theta = (2.0 * math.pi / ppr_safe)[..., None] * p_idx[None, None, :]  # [E, R, P]
    x = b_r[..., None] * torch.cos(theta)
    y = c_r[..., None] * torch.sin(theta)
    zz = z[..., None].expand(theta.shape)
    points = torch.stack([x, y, zz], dim=-1)

    ring_valid = ring_idx[None, :] < total_rings.to(a.dtype)[:, None]  # [E, R]
    pnt_valid = p_idx[None, None, :] < ppr[..., None]  # [E, R, P]
    valid = ring_valid[..., None] & pnt_valid
    return QuadricellGrid(points=points, valid=valid)
