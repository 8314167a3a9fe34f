"""Patch gather for the 2D frontend (counterpart of
``vloam_tpu/ops/pallas_gather``): the three launch forms of one kernel.

  * ``gather_patches_pair``: two images, a corner set each, one launch (the
    KLT tracker's template and search patches);
  * ``gather_patches``: one image (the ORB/BRIEF descriptor support);
  * ``gather_patches_stack``: a (C, H, W) stack, every image's patch at every
    corner, one launch (a blur stack of one octave).

Each launches its entry of ``csrc/gather_patches.cu`` for CUDA tensors and
uses its plain PyTorch version (``*_reference``) for CPU tensors; it never
falls back from one to the other.  All are an exact copy of the (P, P)
window ``img[cy:cy+P, cx:cx+P]`` at each corner (the reference's
``_slice_patches`` semantics, image_ops.py:258-263).  Corners are (N, 2)
int32 ``(x, y)``, pre-clipped by the caller to ``[0, W-P] x [0, H-P]``;
nothing clamps them here (JAX's ``dynamic_slice`` would), the plain version
raises on one out of range and the kernel traps.  No padding and no rule on
N or W: the TPU kernel's blocks of 32 keypoints and 256-lane bands have no
counterpart.
"""

from __future__ import annotations

import torch

from vloam_tpu_torch import kernels

P_DEFAULT = 32
LAUNCHES = 0         # kernel launches by gather_patches_pair (plain-version calls do not count)
LAUNCHES_SINGLE = 0  # ... by gather_patches
LAUNCHES_STACK = 0   # ... by gather_patches_stack


def _slice_patches(img: torch.Tensor, corners: torch.Tensor, P: int) -> torch.Tensor:
    H, W = img.shape
    cx, cy = corners[:, 0].to(torch.int64), corners[:, 1].to(torch.int64)
    if bool(((cx < 0) | (cy < 0) | (cx > W - P) | (cy > H - P)).any()):
        raise ValueError(f"gather_patches: a corner lies outside [0, {W - P}] x [0, {H - P}]")
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


def gather_patches_reference(img, corners, P: int = P_DEFAULT):
    """Plain PyTorch version of ``gather_patches``: one (N, P, P) index gather."""
    return _slice_patches(img, corners, P)


def gather_patches_stack_reference(imgs, corners, P: int = P_DEFAULT):
    """Plain PyTorch version of ``gather_patches_stack``: (C, N, P, P), the
    reference's ``_slice_patches_multi`` transposed (pallas_gather.py:145)."""
    return torch.stack([_slice_patches(img, corners, P) for img in imgs])


def _launch_stack(name, imgs, corners, P):
    kernels.require_cuda(name, imgs, corners)
    if imgs.dtype != torch.float32 or not imgs.is_contiguous():
        raise ValueError(f"{name}: the image must be contiguous float32")
    if corners.dtype != torch.int32 or not corners.is_contiguous():
        raise ValueError(f"{name}: corners must be contiguous int32")
    n = corners.shape[0]
    if corners.shape != (n, 2):
        raise ValueError(f"{name}: corners must be (N, 2)")
    c, h, w = imgs.shape
    out = torch.empty((c, n, P, P), dtype=torch.float32, device=imgs.device)
    rc = kernels.lib().vloam_gather_patches_stack(
        imgs.data_ptr(), c, h, w, corners.data_ptr(), n, P, out.data_ptr(),
        kernels.stream_ptr(imgs.device))
    kernels.check(rc, name)
    return out


def gather_patches(img, corners, P: int = P_DEFAULT):
    """Single-image form: (N, P, P) patches of one (H, W) f32 image."""
    global LAUNCHES_SINGLE
    if img.device.type == "cpu":
        return gather_patches_reference(img, corners, P)
    if img.dim() != 2:
        raise ValueError("gather_patches: the image must be (H, W)")
    out = _launch_stack("gather_patches", img[None], corners, P)
    LAUNCHES_SINGLE += 1
    return out[0]


def gather_patches_stack(imgs, corners, P: int = P_DEFAULT):
    """Stacked form: every image's patch at every corner, (C, N, P, P), from
    a (C, H, W) f32 stack in one launch."""
    global LAUNCHES_STACK
    if imgs.device.type == "cpu":
        return gather_patches_stack_reference(imgs, corners, P)
    if imgs.dim() != 3:
        raise ValueError("gather_patches_stack: the images must be (C, H, W)")
    out = _launch_stack("gather_patches_stack", imgs, corners, P)
    LAUNCHES_STACK += 1
    return out
