"""Patch gather for the 2D frontend (counterpart of
``vloam_tpu/ops/pallas_gather``): the three launch forms of one kernel.

  * ``gather_patches_pair``: two images, a corner set each, one launch (the
    KLT tracker's template and search patches);
  * ``gather_patches``: one image (the ORB/BRIEF descriptor support);
  * ``gather_patches_stack``: a (C, H, W) stack, every image's patch at every
    corner, one launch (a blur stack of one octave).

In this copy each is its plain PyTorch version (``*_reference``) on every
device.  All are an exact copy of the (P, P)
window ``img[cy:cy+P, cx:cx+P]`` at each corner (the reference's
``_slice_patches`` semantics, image_ops.py:258-263).  Corners are (N, 2)
int32 ``(x, y)``, pre-clipped by the caller to ``[0, W-P] x [0, H-P]``;
nothing clamps them here (JAX's ``dynamic_slice`` would); one out of range
raises.  No padding and no rule on
N or W.
"""

from __future__ import annotations

import torch


P_DEFAULT = 32


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
    return gather_patches_pair_reference(img_a, img_b, corners_a, corners_b, P)


def gather_patches_reference(img, corners, P: int = P_DEFAULT):
    """Plain PyTorch version of ``gather_patches``: one (N, P, P) index gather."""
    return _slice_patches(img, corners, P)


def gather_patches_stack_reference(imgs, corners, P: int = P_DEFAULT):
    """Plain PyTorch version of ``gather_patches_stack``: (C, N, P, P), the
    reference's ``_slice_patches_multi`` transposed (pallas_gather.py:145)."""
    return torch.stack([_slice_patches(img, corners, P) for img in imgs])


def gather_patches(img, corners, P: int = P_DEFAULT):
    """Single-image form: (N, P, P) patches of one (H, W) f32 image."""
    return gather_patches_reference(img, corners, P)


def gather_patches_stack(imgs, corners, P: int = P_DEFAULT):
    """Stacked form: every image's patch at every corner, (C, N, P, P), from
    a (C, H, W) f32 stack in one launch."""
    return gather_patches_stack_reference(imgs, corners, P)
