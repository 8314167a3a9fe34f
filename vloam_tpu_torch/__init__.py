"""vloam_tpu_torch — the PyTorch/CUDA port of the vloam_tpu engine.

A second package beside ``vloam_tpu`` (the JAX reference, which it never
imports).  It mirrors the reference layout so that every function's twin is
easy to find:

  runtime: the sequence driver (VloamDriver, run_synthetic, run_kitti) and
           the CLI ``python -m vloam_tpu_torch.runtime``
  models : visual_odometry (VO), lidar_odometry (LO), laser_mapping (MO),
           frame_graph, vloam (the full frame step), lidar_slice (LO + MO)
  ops    : geometry-level solvers and searches, the image frontends
           (``image_ops`` KLT, ``orb`` descriptors and matching); ``knn``,
           ``fused_knn``, ``fused_gn``, ``patch_gather`` and
           ``gather_variants`` hold the wrappers of the hand-written CUDA
           kernels (csrc/) beside their plain PyTorch versions
  tools  : ``gather_experiments``, which times the formulations of the
           patch gather on the GPU
  data   : NumPy host data layer (ring gridding, synthetic raycast world,
           the bench frame stream, the KITTI loaders)
  utils  : trajectory export, KITTI metrics, stage timing, checkpoints

State is a NamedTuple of tensors on an explicit device; functions are plain
functions over state (there are no weights, so no nn.Module).

Numeric policy: float32 everywhere, and no TF32.  This is a metric-scale
geometry engine — matmuls carry world coordinates of tens of metres and
Gauss-Newton normal equations; TF32 keeps ~10 mantissa bits, which corrupts
k-NN distances at those scales the same way the TPU's bf16 pass did.
"""

__version__ = "0.1.0"

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from vloam_tpu_torch.config import VloamConfig  # noqa: E402,F401
