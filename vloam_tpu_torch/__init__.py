"""vloam_tpu_torch — the PyTorch/CUDA port of the vloam_tpu engine.

A second package beside ``vloam_tpu`` (the JAX reference, which it never
imports).  It mirrors the reference layout so that every function's twin is
easy to find:

  models : lidar_odometry (LO), laser_mapping (MO), lidar_slice (their
           composition inside one frame)
  ops    : geometry-level solvers and searches; ``fused_knn`` and
           ``fused_gn`` hold the hand-written CUDA kernels (csrc/) beside
           their plain PyTorch versions
  data   : NumPy host data layer (ring gridding, synthetic raycast world)

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
