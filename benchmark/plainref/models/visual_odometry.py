"""Depth-enhanced monocular visual odometry (port of
``vloam_tpu/models/visual_odometry.py``).

Per frame: optionally CLAHE on the current image (``VisualConfig.clahe``);
keypoints on it: Shi-Tomasi or FAST corners inline, the scale-space
detectors (BRISK, ORB, AKAZE, SIFT) through the ImageUtil facade
(``image_util.det_keypoints``), optionally thinned per bucket
(``keypoint_nms``); the previous frame's keypoints are either tracked into
it by forward-backward pyramidal LK, seeded by the motion prior
(``optical_flow_match=True``), or matched to the current keypoints by
descriptors (``optical_flow_match=False``): ORB/BRIEF with the brute-force
Hamming matcher inline (``ops/orb``), every other family and the ``flann``
matcher through the facade (``image_util.desc_keypoints`` and ``match``);
depth for each previous keypoint from the previous frame's lidar depth
buckets (built by the host, or here from the cloud when none are given);
matches with depth give 3D-2D reprojection residuals, the rest 2D-2D
epipolar residuals; one fused GN solve (``ops/fused_gn``, the CUDA kernel
B4) gives cam0_curr_T_cam0_last.

``VoState.count`` is a host ``int``: the frame-0 and coarse-pyramid
branches are Python ``if``s, and the "enough tracks" gate is a device
select, so a VO frame reads nothing back from the device.

Binary descriptors are int32 words holding the reference's uint32 bit
patterns (see ``ops/orb``), in the state and in a checkpoint; SIFT's are
float32.

Beside the frame step, the reference's two other solvers, which no frame
step calls: ``solve_nls_2d_only`` (epipolar residuals only, the generic GN)
and ``solve_ransac`` (essential-matrix RANSAC and cheirality, ``ops/epipolar``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from plainref import geometry as geo
from plainref import image_util as iu
from plainref.config import VloamConfig
from plainref.ops import image_ops, orb, vo_factors
from plainref.ops.clahe import clahe
from plainref.ops.depth_map import (DepthBuckets, bucket_shape, build_buckets,
                                           project_cloud, query_depth)
from plainref.ops.fused_gn import solve_pose_gn_vo
from plainref.ops.gauss_newton import solve_pose_gn


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
            lo_prior: torch.Tensor | None = None, pre_buckets: DepthBuckets | None = None,
            cloud: torch.Tensor | None = None, cloud_mask: torch.Tensor | None = None,
            proj: torch.Tensor | None = None):
    """One VO frame.  Returns (new_state, cam0_curr_T_cam0_last pose).

    ``pre_buckets`` is the depth-bucket grid of the CURRENT cloud, built by
    the host data layer.  Without it the buckets are built here from
    ``cloud`` (N, 3), ``cloud_mask`` (N,) and ``proj`` (3, 4)
    (``depth_map.project_cloud`` + ``build_buckets``), which feed nothing
    else."""
    vc = cfg.visual
    if pre_buckets is None and (cloud is None or cloud_mask is None or proj is None):
        raise ValueError("vo_step needs pre_buckets, or cloud, cloud_mask and proj to build them")
    dev = img.device
    count = state.count

    # --- frontend -----------------------------------------------------------
    if vc.clahe:
        img = clahe(img, vc.clahe_clip)
    if vc.detector_type in ("shitomasi", "fast"):
        # the hot path: single-scale corner detectors, inline
        pts, pts_mask, resp = image_ops.detect_corners(img, vc)
        kp_oct = kp_ang = None
    else:
        # the scale-space families (BRISK/ORB/AKAZE/SIFT) through the facade
        kp = iu.det_keypoints(img, vc.detector_type, vc)
        pts, pts_mask, resp, kp_oct, kp_ang = kp
    if vc.keypoint_nms:
        pts_mask = image_ops.bucket_nms(pts, pts_mask, resp, vc)

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
        # keypoints, match the previous frame's descriptors against them;
        # ORB/BRIEF with the brute-force matcher inline, the rest through
        # the facade.
        if vc.descriptor_type in ("orb", "brief") and vc.matcher_type == "bf":
            desc, desc_mask = orb.orb_descriptors(img, pts, pts_mask, vc,
                                                  rotate=(vc.descriptor_type == "orb"))
            midx, track_ok = orb.match_descriptors(state.prev_desc, state.prev_desc_mask, desc,
                                                   desc_mask, ratio=vc.match_ratio,
                                                   select=vc.match_select)
        else:
            kp = (iu.single_scale(pts, pts_mask, resp) if kp_oct is None
                  else iu.Keypoints(pts, pts_mask, resp, kp_oct, kp_ang))
            desc, desc_mask = iu.desc_keypoints(img, kp, vc.descriptor_type, vc)
            midx, track_ok = iu.match(state.prev_desc, state.prev_desc_mask, desc, desc_mask,
                                      matcher_type=vc.matcher_type, select=vc.match_select,
                                      ratio=vc.match_ratio)
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

    if pre_buckets is None:
        pre_buckets = build_buckets(*project_cloud(cloud, cloud_mask, proj, vc), vc)
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


def solve_nls_2d_only(prev_pts: torch.Tensor, curr_pts: torch.Tensor, match_mask: torch.Tensor,
                      K: torch.Tensor, cfg: VloamConfig,
                      pose0: torch.Tensor | None = None) -> torch.Tensor:
    """Epipolar-only GN solve, ``VisualOdometry::solveNls2dOnly``
    (visual_odometry.h:61): every valid match of the (M, 2) pixel tracks
    contributes only the 2D-2D epipolar residual (ceres_cost_function.h:
    151-189), through the generic ``ops/gauss_newton.solve_pose_gn``.  The
    translation's scale is unobservable; the pose keeps the seed's scale
    (unit scale from the identity)."""
    vc = cfg.visual
    K_inv = inv3(K)
    xb0, xb1 = _ray(K_inv, prev_pts), _ray(K_inv, curr_pts)
    p0 = geo.pose_identity(prev_pts.device) if pose0 is None else pose0

    def residuals(p):
        return ((vo_factors.epipolar_22_residual(p, xb0, xb1), match_mask),)

    return solve_pose_gn(residuals, p0, vc.max_iters, vc.huber_delta, vc.lm_lambda)


def solve_ransac(prev_pts: torch.Tensor, curr_pts: torch.Tensor, match_mask: torch.Tensor,
                 K: torch.Tensor, n_hypotheses: int = 256, thresh_px: float = 1.0,
                 seed: int = 0):
    """Essential-matrix RANSAC pose, ``VisualOdometry::solveRANSAC``
    (visual_odometry.cpp:234-299).  Returns (pose (7,), n_inliers); the
    translation is unit-norm, as with cv::recoverPose."""
    from plainref.ops.epipolar import solve_ransac_pose

    return solve_ransac_pose(prev_pts, curr_pts, match_mask, K, n_hypotheses, thresh_px, seed)
