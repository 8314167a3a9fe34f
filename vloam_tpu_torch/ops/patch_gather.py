"""Patch gather for the KLT tracker (counterpart of
``vloam_tpu/ops/pallas_gather.gather_patches_pair``).

``gather_patches_pair`` launches the CUDA kernel ``csrc/gather_patches.cu``
for CUDA tensors and uses the plain PyTorch version,
``gather_patches_pair_reference``, for CPU tensors; it never falls back from
one to the other.  Both are an exact copy of the (P, P) window
``img[cy:cy+P, cx:cx+P]`` at each corner (the reference's ``_slice_patches``
semantics, image_ops.py:258-263).  Corners are (N, 2) int32 ``(x, y)``,
pre-clipped by the caller to ``[0, W-P] x [0, H-P]``; nothing clamps them
here, and the plain version raises on one out of range.

The single-image and stacked variants (``gather_patches``,
``gather_patches_stack``) serve only the descriptor frontends and are not
ported (ROADMAP A9).
"""

from __future__ import annotations

import torch

from vloam_tpu_torch import kernels

P_DEFAULT = 32
LAUNCHES = 0  # kernel launches by gather_patches_pair (plain-version calls do not count)


def _slice_patches(img: torch.Tensor, corners: torch.Tensor, P: int) -> torch.Tensor:
    H, W = img.shape
    cx, cy = corners[:, 0].to(torch.int64), corners[:, 1].to(torch.int64)
    if bool(((cx < 0) | (cy < 0) | (cx > W - P) | (cy > H - P)).any()):
        raise ValueError(f"gather_patches_pair: a corner lies outside [0, {W - P}] x [0, {H - P}]")
    off = torch.arange(P, device=img.device)
    rows = cy[:, None] + off                                   # (N, P)
    cols = cx[:, None] + off
    return img[rows[:, :, None], cols[:, None, :]]


def gather_patches_pair_reference(img_a, img_b, corners_a, corners_b, P: int = P_DEFAULT):
    """Plain PyTorch version: two (N, P, P) index gathers."""
    return _slice_patches(img_a, corners_a, P), _slice_patches(img_b, corners_b, P)


def gather_patches_pair(img_a, img_b, corners_a, corners_b, P: int = P_DEFAULT):
    """Slice (N, P, P) patches from two (H, W) f32 images at per-keypoint
    corners, both images in one launch.  Returns (patches_a, patches_b)."""
    global LAUNCHES
    if img_a.device.type == "cpu":
        return gather_patches_pair_reference(img_a, img_b, corners_a, corners_b, P)
    kernels.require_cuda("gather_patches_pair", img_a, img_b, corners_a, corners_b)
    for name, t, dtype in (("img_a", img_a, torch.float32), ("img_b", img_b, torch.float32),
                           ("corners_a", corners_a, torch.int32),
                           ("corners_b", corners_b, torch.int32)):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"gather_patches_pair: {name} must be contiguous {dtype}")
    n = corners_a.shape[0]
    if corners_a.shape != (n, 2) or corners_b.shape != (n, 2):
        raise ValueError("gather_patches_pair: corners must both be (N, 2)")
    (ha, wa), (hb, wb) = img_a.shape, img_b.shape
    out_a = torch.empty((n, P, P), dtype=torch.float32, device=img_a.device)
    out_b = torch.empty_like(out_a)
    rc = kernels.lib().vloam_gather_patches(
        img_a.data_ptr(), ha, wa, img_b.data_ptr(), hb, wb,
        corners_a.data_ptr(), corners_b.data_ptr(), n, P,
        out_a.data_ptr(), out_b.data_ptr(), kernels.stream_ptr(img_a.device),
    )
    kernels.check(rc, "gather_patches_pair")
    LAUNCHES += 1
    return out_a, out_b
