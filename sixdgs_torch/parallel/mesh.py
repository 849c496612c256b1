"""Device-mesh construction and the collectives of the sharded steps (port
of sixdgs_tpu/parallel/mesh.py).

A mesh is a ``torch.distributed`` ``DeviceMesh`` over every rank of the
process group the caller initialised; it neither picks nor swaps a
backend. The steps work on plain local tensors with explicit collectives:

  * ``all_reduce_sum`` is differentiable. Its backward all-reduces the
    cotangent, which is the gradient when every rank's objective is its own
    share of the global loss (the sharded steps build theirs so), and is R
    times too large when every rank differentiates the same replicated loss;
  * ``all_gather_rows`` gathers in rank order through an all-reduce of a
    zero-padded buffer, so it runs on CUDA tensors under gloo (whose
    all-gather takes CPU tensors only) as under NCCL, and is exact (x + 0).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def _factor_2d(n: int) -> Tuple[int, int]:
    """Balanced two-axis factorization of n (prefers near-square)."""
    best = (1, n)
    for a in range(1, int(np.sqrt(n)) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data", "rays"),
    shape: Optional[Tuple[int, ...]] = None,
    device_type: str = "cuda",
):
    """Build a DeviceMesh over the initialised process group.

    Args:
        n_devices: the number of ranks (default: the world size, which it
            must equal).
        axis_names: mesh axis names; default ("data", "rays") for pose
            training (DP x SP).
        shape: explicit mesh shape; default (n,) for one axis and the
            balanced 2D factorization for two.
        device_type: "cuda", or "cpu" for gloo ranks on the host.
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group")
    n = dist.get_world_size() if n_devices is None else n_devices
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of {n} ranks in a world of {dist.get_world_size()}")
    if shape is None:
        if len(axis_names) == 1:
            shape = (n,)
        elif len(axis_names) == 2:
            shape = _factor_2d(n)
        else:
            raise ValueError("provide shape for >2 axes")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not hold {n} ranks")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def local_slice(x: torch.Tensor, mesh, name: str) -> torch.Tensor:
    """This rank's part of ``x`` split on its first dimension over the mesh
    axis ``name`` (``torch.tensor_split``: the first ranks take one more
    when the split is uneven)."""
    return torch.tensor_split(x, mesh.get_group(name).size())[mesh.get_local_rank(name)]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``x`` over ``group`` on every rank, differentiable: the
    cotangent is summed over the group on the way back."""
    return _AllReduceSum.apply(x, group)


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """[n, ...] on each of the group's R ranks -> [R n, ...], rank r's rows
    at r n; every rank must hold the same n. Not differentiable."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    n = x.shape[0]
    buf = x.new_zeros((size * n,) + tuple(x.shape[1:]))
    buf[rank * n:(rank + 1) * n] = x
    dist.all_reduce(buf, group=group)
    return buf
