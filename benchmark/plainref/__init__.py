"""plainref — the benchmark's plain reference of the VLOAM frame step.

A frozen copy of the plain PyTorch path of ``vloam_tpu_torch`` as it stood
at commit 2b93434 (the frame step ``models/vloam.vloam_step`` and what it
imports, the NumPy host data layer ``data/gridding`` and ``geometry_np``),
with the package renamed and every kernel wrapper cut down to its plain
version: ``ops/fused_knn.knn_pair``, ``ops/knn.knn``,
``ops/fused_gn.solve_pose_gn_*`` and ``ops/patch_gather.gather_patches*``
call their ``*_reference`` functions on every device, so nothing here
launches a hand-written kernel or imports ``vloam_tpu_torch``.  Later edits
to the port do not move it: the benchmark holds the port's outputs to this
copy's.

Numeric policy, as the port's: float32 everywhere, and no TF32.  The
benchmark's precision control switches TF32 on after import.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
