"""Depth-enhanced monocular visual odometry (port of
``vloam_tpu/models/visual_odometry.py``: the KLT branch and the ORB/BRIEF
descriptor-match branch).

Per frame: Shi-Tomasi corners on the current image; the previous frame's
corners are either tracked into it by forward-backward pyramidal LK, seeded
by the motion prior (``optical_flow_match=True``), or matched to the current
corners by ORB/BRIEF descriptors and brute-force Hamming distance
(``optical_flow_match=False``, ``ops/orb``); depth for each previous corner
from the previous frame's lidar depth buckets; matches with depth give 3D-2D
reprojection residuals, the rest 2D-2D epipolar residuals; one fused GN
solve (``ops/fused_gn``, the CUDA kernel B4) gives cam0_curr_T_cam0_last.

``VoState.count`` is a host ``int``: the frame-0 and coarse-pyramid
branches are Python ``if``s, and the "enough tracks" gate is a device
select, so a VO frame reads nothing back from the device.

Binary descriptors are int32 words holding the reference's uint32 bit
patterns (see ``ops/orb``), in the state and in a checkpoint.

Not ported (ROADMAP A9): CLAHE, the descriptor families other than ORB and
BRIEF and the approximate (``flann``) matcher, which the reference reaches
through its ``image_util`` facade, ``keypoint_nms``, detectors other than
Shi-Tomasi, and the device-side depth-bucket build (``pre_buckets=None``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vloam_tpu_torch import geometry as geo
from vloam_tpu_torch.config import VloamConfig
from vloam_tpu_torch.ops import image_ops, orb
from vloam_tpu_torch.ops.depth_map import DepthBuckets, bucket_shape, query_depth
from vloam_tpu_torch.ops.fused_gn import solve_pose_gn_vo


class VoState(NamedTuple):
    prev_img: torch.Tensor          # (H, W)
    prev_pts: torch.Tensor          # (max_features, 2) corners detected on the prev frame
    prev_pts_mask: torch.Tensor     # (max_features,)
    prev_desc: torch.Tensor         # (max_features, D) descriptors (rolls in descriptor mode only)
    prev_desc_mask: torch.Tensor    # (max_features,)
    prev_buckets: DepthBuckets      # lidar depth map of the prev frame
    count: int                      # host frame counter


def _desc_buffer_spec(vc) -> tuple[int, torch.dtype]:
    """Descriptor buffer (width, dtype) per family: ORB/BRIEF 256-bit,
    BRISK/FREAK/AKAZE 512-bit binary (int32 words with the reference's
    uint32 bit patterns), SIFT 128-d float."""
    t = vc.descriptor_type
    if t in ("orb", "brief"):
        return 8, torch.int32
    if t in ("brisk", "freak", "akaze"):
        return 16, torch.int32
    if t == "sift":
        return 128, torch.float32
    raise ValueError(f"unknown descriptor_type {t!r}")


def init_vo_state(cfg: VloamConfig, device) -> VoState:
    vc = cfg.visual
    bw, bh = bucket_shape(vc)
    dw, ddt = _desc_buffer_spec(vc)
    z = lambda: torch.zeros((bw, bh), dtype=torch.float32, device=device)  # noqa: E731
    return VoState(
        prev_img=torch.zeros((vc.img_height, vc.img_width), dtype=torch.float32, device=device),
        prev_pts=torch.zeros((vc.max_features, 2), dtype=torch.float32, device=device),
        prev_pts_mask=torch.zeros((vc.max_features,), dtype=torch.bool, device=device),
        prev_desc=torch.zeros((vc.max_features, dw), dtype=ddt, device=device),
        prev_desc_mask=torch.zeros((vc.max_features,), dtype=torch.bool, device=device),
        prev_buckets=DepthBuckets(z(), z(), z(), z()),
        count=0,
    )


def vo_state_from_numpy(state, device) -> VoState:
    """A reference ``VoState`` whose leaves are NumPy arrays -> this port's
    state on ``device``.  uint32 descriptor words cross as the int32 view of
    the same bits."""
    f = lambda x: torch.tensor(np.asarray(x), device=device)  # noqa: E731
    desc = np.asarray(state.prev_desc)
    if desc.dtype == np.uint32:
        desc = desc.view(np.int32)
    return VoState(
        prev_img=f(state.prev_img), prev_pts=f(state.prev_pts),
        prev_pts_mask=f(state.prev_pts_mask), prev_desc=f(desc),
        prev_desc_mask=f(state.prev_desc_mask),
        prev_buckets=DepthBuckets(*(f(b) for b in state.prev_buckets)),
        count=int(np.asarray(state.count)),
    )


def inv3(K: torch.Tensor) -> torch.Tensor:
    """Inverse of a 3x3 matrix by its adjugate: elementwise ops only, so it
    never synchronises (``torch.linalg.inv`` checks its result on the host)."""
    a, b, c = K[0, 0], K[0, 1], K[0, 2]
    d, e, f = K[1, 0], K[1, 1], K[1, 2]
    g, h, i = K[2, 0], K[2, 1], K[2, 2]
    co = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e]),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f]),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d]),
    ])
    det = a * co[0, 0] + b * co[1, 0] + c * co[2, 0]
    return co / det


def _unproject(K_inv: torch.Tensor, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """K^-1 [u d, v d, d]: the rectified-camera 3D point (visual_odometry.cpp:403-415)."""
    uvd = torch.stack([uv[..., 0] * depth, uv[..., 1] * depth, depth], dim=-1)
    return uvd @ K_inv.T


def _ray(K_inv: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Normalised image ray (xbar, ybar) = (K^-1 [u v 1]) / z."""
    X = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1) @ K_inv.T
    return X[..., :2] / torch.clamp(X[..., 2:3], min=1e-9)


def vo_step(state: VoState, img: torch.Tensor, K: torch.Tensor, cfg: VloamConfig,
            lo_prior: torch.Tensor | None = None, pre_buckets: DepthBuckets | None = None):
    """One VO frame.  Returns (new_state, cam0_curr_T_cam0_last pose).

    ``pre_buckets`` is the depth-bucket grid of the CURRENT cloud, built by
    the host data layer.  The reference's ``cloud``, ``cloud_mask`` and
    ``proj`` arguments feed only the device-side bucket build, which is not
    ported (ROADMAP A9), so they are not taken."""
    vc = cfg.visual
    if vc.clahe:
        raise NotImplementedError("VisualConfig.clahe is not ported yet (ROADMAP A9)")
    if not vc.optical_flow_match and not (vc.descriptor_type in ("orb", "brief")
                                          and vc.matcher_type == "bf"):
        raise NotImplementedError(
            f"descriptor_type={vc.descriptor_type!r} with matcher_type={vc.matcher_type!r} is "
            "not ported yet (ROADMAP A9); descriptor mode runs ORB or BRIEF with the brute-force "
            "matcher")
    if vc.keypoint_nms:
        raise NotImplementedError("VisualConfig.keypoint_nms is not ported yet (ROADMAP A9)")
    if pre_buckets is None:
        raise NotImplementedError(
            "the device-side depth-bucket build (pre_buckets=None) is not ported yet (ROADMAP A9)")
    dev = img.device
    count = state.count

    # --- frontend -----------------------------------------------------------
    pts, pts_mask, _ = image_ops.detect_corners(img, vc)

    # --- depth association (prev frame's buckets at prev pixel) -------------
    depth0 = query_depth(state.prev_buckets, state.prev_pts, vc)
    K_inv = inv3(K)

    if vc.optical_flow_match:
        # Seed KLT with the motion-prior flow: project each prev feature's 3D
        # point (bucket depth, or a nominal mid-range depth) through the prior.
        pose_pred = geo.pose_identity(dev) if lo_prior is None else lo_prior
        d_nom = torch.where(depth0 > 0, depth0, 15.0)
        X1_pred = geo.pose_apply(pose_pred, _unproject(K_inv, state.prev_pts, d_nom))
        uv_pred = X1_pred @ K.T
        uv_pred = uv_pred[:, :2] / torch.clamp(uv_pred[:, 2:3], min=1e-3)
        init_flow = torch.clamp(uv_pred - state.prev_pts, -120.0, 120.0)

        # With a real LO prior (frame >= 2) the seeded flow lands inside the
        # level-0 patch slack, so the coarse pyramid levels are skipped.
        skip_coarse = None if lo_prior is None else count >= 2
        track = image_ops.lk_track_fb if vc.klt_fb_check else image_ops.lk_track
        curr_pts, track_ok = track(state.prev_img, img, state.prev_pts, state.prev_pts_mask, vc,
                                   init_flow, skip_coarse=skip_coarse)
        desc, desc_mask = state.prev_desc, state.prev_desc_mask    # unused in this mode
    else:
        # Descriptor mode (the reference default): describe the current
        # corners, match the previous frame's descriptors against them.
        desc, desc_mask = orb.orb_descriptors(img, pts, pts_mask, vc,
                                              rotate=(vc.descriptor_type == "orb"))
        midx, track_ok = orb.match_descriptors(state.prev_desc, state.prev_desc_mask, desc,
                                               desc_mask, ratio=vc.match_ratio,
                                               select=vc.match_select)
        curr_pts = pts[midx]
    track_ok = track_ok & (count > 0)

    # outlier gate on pixel displacement (visual_odometry.cpp:363-368)
    if vc.remove_vo_outlier > 0:
        disp2 = torch.sum((curr_pts - state.prev_pts) ** 2, dim=-1)
        track_ok = track_ok & (disp2 <= vc.remove_vo_outlier ** 2)

    # --- residuals and the fused solve --------------------------------------
    has_depth = track_ok & (depth0 > 0)
    no_depth = track_ok & (depth0 <= 0)
    X0 = _unproject(K_inv, state.prev_pts, torch.clamp(depth0, min=1e-3))
    xb0 = _ray(K_inv, state.prev_pts)
    xb1 = _ray(K_inv, curr_pts)

    pose0 = (geo.pose_identity(dev) if (lo_prior is None or vc.reset_vo_to_identity)
             else lo_prior)
    # launched on every frame, frame 0 included (whose result is discarded)
    solved = solve_pose_gn_vo(pose0, X0, xb0, xb1, has_depth, no_depth,
                              vc.max_iters, vc.huber_delta, vc.lm_lambda)
    enough = torch.sum(track_ok) >= 10
    pose = torch.where(enough, solved, pose0) if count > 0 else pose0

    new_state = VoState(
        prev_img=img,
        prev_pts=pts,
        prev_pts_mask=pts_mask,
        prev_desc=desc,
        prev_desc_mask=desc_mask,
        prev_buckets=pre_buckets,
        count=count + 1,
    )
    return new_state, pose
