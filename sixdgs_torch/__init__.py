"""sixdgs_torch — the PyTorch and CUDA port of sixdgs_tpu (6DGS).

Single-image 6-DoF camera pose estimation against a trained 3DGS scene via
ellipsoid-surface ray casting and cross-attention ray scoring, and the
scene's rendering and training, on an NVIDIA Hopper GPU. It mirrors the JAX package's relative paths and function names;
plain tensor math is PyTorch, and each TPU kernel on the ported path is a
kernel written by hand for sm_90a (``csrc/``), built with nvcc at first use.

Layout (every module of the JAX package):
  ops/      SH, quaternions and covariances, cameras, sym-eig 3x3, LS
            lines, fused attention scores (forward B1 and backward B2),
            SSIM / PSNR / L1, exact kNN, rasterizer/ (projection, golden
            compositor, tile binning, the tile rasterizer on B5, B3 and,
            for gradients, B4)
  apps/     CLIs: train_gs, render, metrics, full_eval, convert, and the
            pose driver (pose_eval)
  renderer/ public render() API, the SIBR remote-viewer server
            (network_gui)
  scene/    GaussianScene, byte-compatible PLY codec, structures, cameras,
            COLMAP / Blender / T&T / Cambridge Landmarks (NVM) loaders, an
            8-bit PNG codec for machines without Pillow
  rays/     quadricell surface sampling, PCA normals, ray engine
  pose/     DINOv2 ViT-S/14, ray MLP, attention, camera-up head, loss,
            solver, evaluation, id-module trainer (Adafactor),
            camera-up augmentations
  train/    the 3DGS trainer (train_step, GSTrainer, render_eval),
            per-group Adam, densification, checkpoints
  utils/    configs and cfg_args, metrics writer, the gsio loader,
            profiler traces and step timers
  parallel/ torch.distributed: the device mesh, the DP x SP id-module step,
            the Gaussian-parallel render, the DP 3DGS step (gloo ranks on
            the CPU in the tests, NCCL or gloo on the card)
  weights   the JAX package's param dicts <-> the port's modules

Entry points run on "cuda" unless the caller passes ``device="cpu"``.
Importing the package needs neither nvcc nor a GPU.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API (keeps `import sixdgs_torch` light)."""
    import importlib

    api = {
        "GaussianScene": ("sixdgs_torch.scene.gaussians", "GaussianScene"),
        "load_ply": ("sixdgs_torch.scene.gaussians", "load_ply"),
        "create_from_pcd": ("sixdgs_torch.scene.gaussians", "create_from_pcd"),
        "load_data": ("sixdgs_torch.scene.dataset_loader", "load_data"),
        "render": ("sixdgs_torch.renderer", "render"),
        "generate_rays": ("sixdgs_torch.rays.engine", "generate_rays_from_scene"),
        "score_image": ("sixdgs_torch.pose.id_module", "score_image"),
        "solve_pose": ("sixdgs_torch.pose.solver", "solve_pose"),
        "eval_image": ("sixdgs_torch.pose.evaluate", "eval_image"),
        "test_pose_estimation": ("sixdgs_torch.pose.evaluate", "test_pose_estimation"),
        "render_eval": ("sixdgs_torch.train.gs_trainer", "render_eval"),
        "GSTrainer": ("sixdgs_torch.train.gs_trainer", "GSTrainer"),
        "PoseTrainer": ("sixdgs_torch.pose.trainer", "PoseTrainer"),
        "make_mesh": ("sixdgs_torch.parallel.mesh", "make_mesh"),
    }
    if name in api:
        module, attr = api[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'sixdgs_torch' has no attribute {name!r}")
