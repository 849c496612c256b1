"""Multi-rank scaling on torch.distributed (port of sixdgs_tpu/parallel).

The reference is strictly single-GPU. Here, on a DeviceMesh over the
caller's process group (NCCL on GPUs, gloo on the host), with plain local
tensors and explicit collectives:

  * DP over the pose-training image batch and SP over the ray axis (the
    softmax over rays, the target's scale and the valid-ray count reduced
    over the "rays" ranks, the masked mean's count of finite losses over the
    "data" ranks),
  * Gaussian-parallel projection + pixel-parallel compositing for rendering,
  * DP over a batch of cameras for 3DGS training (one B-camera step is the
    statistical equivalent of B reference iterations; densify stats keep
    reference semantics).
"""

from sixdgs_torch.parallel.gs_sharding import make_sharded_gs_step, shard_camera_batch
from sixdgs_torch.parallel.mesh import make_mesh
from sixdgs_torch.parallel.pose_sharding import make_sharded_pose_step, shard_pose_inputs

__all__ = ["make_mesh", "make_sharded_pose_step", "shard_pose_inputs",
           "make_sharded_gs_step", "shard_camera_batch"]
