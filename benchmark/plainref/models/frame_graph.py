"""Frame graph and VO/LO/MO coupling (port of
``vloam_tpu/models/frame_graph.py``).

Static extrinsics and the pose conversions of the reference's VloamTF
(vloam_tf.cpp): the VO motion in the velodyne frame (the LO seed in the
coupled mode), world accumulation with the NaN guard, the LO motion in the
camera frame (the VO seed), and the trajectory rows rebased to cam0 at the
start frame.  As in the reference, LO/MO deltas computed in the velodyne
frame are attributed to base_link directly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from plainref import geometry as geo


class Extrinsics(NamedTuple):
    base_T_cam0: torch.Tensor   # (7,)
    velo_T_cam0: torch.Tensor   # (7,)
    cam_T_velo: torch.Tensor    # (4, 4) the projection-chain matrix for depth association
    P_rect0: torch.Tensor       # (3, 4)
    R_rect0: torch.Tensor       # (4, 4)


def kitti_default_extrinsics(device=None) -> Extrinsics:
    """Nominal KITTI transforms for synthetic runs (cam0 z forward = velo x)."""
    velo_R_cam = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]], np.float32)
    q = geo.matrix_to_quat(torch.tensor(velo_R_cam))
    velo_T_cam0 = geo.pose_from_qt(q, torch.zeros(3))
    cam_T_velo = np.eye(4, dtype=np.float32)
    cam_T_velo[:3, :3] = velo_R_cam.T
    P = np.zeros((3, 4), np.float32)
    P[:, :3] = np.array([[718.856, 0, 624.0], [0, 718.856, 188.0], [0, 0, 1.0]], np.float32)
    return Extrinsics(
        base_T_cam0=velo_T_cam0.to(device),   # base == velo for synthetic runs
        velo_T_cam0=velo_T_cam0.to(device),
        cam_T_velo=torch.tensor(cam_T_velo, device=device),
        P_rect0=torch.tensor(P, device=device),
        R_rect0=torch.eye(4, dtype=torch.float32, device=device),
    )


def vo_to_velo(cam0_curr_T_cam0_last: torch.Tensor, ext: Extrinsics) -> torch.Tensor:
    """velo_last_VOT_velo_curr (vloam_tf.cpp:69-70)."""
    return geo.pose_compose(
        geo.pose_compose(ext.velo_T_cam0, geo.pose_inverse(cam0_curr_T_cam0_last)),
        geo.pose_inverse(ext.velo_T_cam0),
    )


def accumulate_world(world_T_base: torch.Tensor, base_last_T_base_curr: torch.Tensor) -> torch.Tensor:
    """world_VOT_base_last *= delta, with the NaN guard (vloam_tf.cpp:76-79)
    as a device select (no sync)."""
    new = geo.pose_compose(world_T_base, base_last_T_base_curr)
    return torch.where(torch.isfinite(new).all(), new, world_T_base)


def lo_delta_to_cam0(velo_last_T_velo_curr: torch.Tensor, ext: Extrinsics) -> torch.Tensor:
    """cam0_curr_LOT_cam0_prev = base_T_cam0^-1 o delta^-1 o base_T_cam0
    (laser_odometry.cpp:615-616), the VO seed."""
    return geo.pose_compose(
        geo.pose_compose(geo.pose_inverse(ext.base_T_cam0), geo.pose_inverse(velo_last_T_velo_curr)),
        ext.base_T_cam0,
    )


def world_to_cam0_start(world_T_base: torch.Tensor, cam0_init_T_cam0_start: torch.Tensor,
                        ext: Extrinsics) -> torch.Tensor:
    """cam0_start_T_cam0_last = (init_T_start)^-1 o base_T_cam0^-1 o
    world_T_base o base_T_cam0 (vloam_tf.cpp:89-94)."""
    return geo.pose_compose(geo.pose_inverse(cam0_init_T_cam0_start),
                            cam0_init_pose(world_T_base, ext))


def cam0_init_pose(world_T_base: torch.Tensor, ext: Extrinsics) -> torch.Tensor:
    """cam0_init_T_cam0_last before rebasing, captured at frame 0 as the
    start frame."""
    return geo.pose_compose(
        geo.pose_compose(geo.pose_inverse(ext.base_T_cam0), world_T_base), ext.base_T_cam0)
