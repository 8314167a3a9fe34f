"""The full VLOAM frame step (port of ``vloam_tpu/models/vloam.py``).

One step in the reference's callback order (vloam_main_node.cpp:134-202):
image -> VO -> frame-graph conversion -> scan registration -> LO (seeded by
VO when coupled) -> mapping (every ``skip_frame``-th frame) -> world poses
and the trajectory rows rebased to cam0 at the start frame.

``detach_vo_lo`` selects the (D)/(C) modes: detached, LO warm-starts from
its previous solution and VO is a passenger; coupled, VO's motion in the
velodyne frame seeds LO.  In both, LO's motion seeds the next frame's VO.

``VloamState.count`` is a host ``int``, so the frame-0 anchor and the
mapping skip are Python branches, not device reads.  On the main path the
host data layer builds the ring grid, the less-flat table and the depth
buckets (``data/gridding`` or ``runtime/native``) and ``frame_to_device``
moves them to the card; given a raw padded cloud (``pre_gridded=False``)
or no buckets, the step builds them on the device with the same kernels
launched.  ``parallel/vloam_shard`` runs this step with the map sharded
over the ranks of a map mesh.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from plainref import geometry as geo
from plainref.config import VloamConfig
from plainref.models import frame_graph as fg
from plainref.models.laser_mapping import (MapState, init_map_state, map_state_from_numpy,
                                                  mapping_step)
from plainref.models.lidar_odometry import (LoState, init_lo_state, lo_state_from_numpy,
                                                   lo_step)
from plainref.models.visual_odometry import (VoState, init_vo_state, vo_state_from_numpy,
                                                    vo_step)
from plainref.ops.depth_map import DepthBuckets
from plainref.ops.scan_registration import extract_features, extract_features_from_grid


class VloamState(NamedTuple):
    vo: VoState
    lo: LoState
    mp: MapState
    world_VOT_base: torch.Tensor            # (7,) accumulated VO world pose
    cam0_curr_LOT_cam0_prev: torch.Tensor   # (7,) LO f2f in the cam0 frame (VO seed)
    cam0_init_T_cam0_start: torch.Tensor    # (7,) rebase anchor captured at frame 0
    count: int                              # host frame counter


class VloamOutputs(NamedTuple):
    vo_pose: torch.Tensor        # (7,) cam0_start_T_cam0_curr (VO trajectory row)
    lo_pose: torch.Tensor        # (7,) LO trajectory row
    mo_pose: torch.Tensor        # (7,) MO trajectory row
    world_vo: torch.Tensor       # (7,) world_T_base from VO
    world_lo: torch.Tensor       # (7,) world_T_base from LO
    world_mo: torch.Tensor       # (7,) world_T_base from mapping
    lo_corr: torch.Tensor        # (2,) LO edge/plane correspondence counts
    vo_delta: torch.Tensor       # (7,) velo_last_VOT_velo_curr (this frame's VO motion)
    lo_delta: torch.Tensor       # (7,) velo_last_LOT_velo_curr
    mo_correction: torch.Tensor  # (7,) wmap_T_wodom after this frame's mapping update


def init_vloam_state(cfg: VloamConfig, device, n_map_shards: int = 1) -> VloamState:
    """The state of frame 0.  ``n_map_shards > 1`` lays the map out for a
    map mesh of that many ranks (``init_map_state(..., n_shards=)``; each
    rank keeps its block through ``parallel/vloam_shard.shard_vloam_state``)."""
    return VloamState(
        vo=init_vo_state(cfg, device),
        lo=init_lo_state(cfg, device),
        mp=init_map_state(cfg, device, n_shards=n_map_shards),
        world_VOT_base=geo.pose_identity(device),
        cam0_curr_LOT_cam0_prev=geo.pose_identity(device),
        cam0_init_T_cam0_start=geo.pose_identity(device),
        count=0,
    )


def vloam_state_from_numpy(state, device) -> VloamState:
    """A reference single-shard ``VloamState`` whose leaves are NumPy arrays
    -> this port's state on ``device``."""
    f = lambda x: torch.tensor(np.asarray(x), device=device)  # noqa: E731
    return VloamState(
        vo=vo_state_from_numpy(state.vo, device),
        lo=lo_state_from_numpy(state.lo, device),
        mp=map_state_from_numpy(state.mp, device),
        world_VOT_base=f(state.world_VOT_base),
        cam0_curr_LOT_cam0_prev=f(state.cam0_curr_LOT_cam0_prev),
        cam0_init_T_cam0_start=f(state.cam0_init_T_cam0_start),
        count=int(np.asarray(state.count)),
    )


def host_to_device(x, device) -> torch.Tensor:
    """A host array as a tensor on ``device``.  To a card it goes through
    pinned memory as a non-blocking copy, so the upload does not stall the
    host (the caching pinned allocator keeps the buffer until the copy is
    done)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def frame_to_device(img, grid, gmask, buckets, lf_table, device):
    """Host frame (image, ring grid + mask, depth buckets (u, v, z, count),
    less-flat table) -> the tensors ``vloam_step`` takes, in its argument
    order after the state: (img, grid, gmask, DepthBuckets, lf_table)."""
    slot_grid, base_sums, n_runs = lf_table
    t = lambda x: host_to_device(x, device)  # noqa: E731
    return (
        t(img), t(grid), t(gmask),
        DepthBuckets(*(t(b) for b in buckets)),
        (t(slot_grid), t(base_sums), int(n_runs)),
    )


def vloam_step(state: VloamState, img, cloud, cloud_mask, ext: fg.Extrinsics, cfg: VloamConfig,
               pre_gridded: bool = False, pre_buckets: DepthBuckets | None = None,
               pre_lf_table=None, mapping_fn=None):
    """One frame.  ``cloud``/``cloud_mask`` are the host-built ring grid
    (R, C, 4) and its mask (``pre_gridded=True``), or a raw padded cloud
    (N, >=3) and its mask (``pre_gridded=False``: ``organize_scan`` grids
    it on the device and the less-flat cloud is reduced there, so
    ``pre_lf_table`` is not read).  ``pre_buckets`` and ``pre_lf_table``
    come from the host data layer; without ``pre_buckets`` VO builds the
    depth buckets from the cloud.  ``mapping_fn`` replaces the MO stage,
    ``mapping_step``'s signature (``parallel/vloam_shard`` passes the sharded
    step).  Returns (new_state, VloamOutputs)."""
    if mapping_fn is None:
        mapping_fn = mapping_step
    if pre_gridded:
        grid, gmask = cloud, cloud_mask
        flat_cloud, flat_mask = grid.reshape(-1, 4)[:, :3], gmask.reshape(-1)
    else:
        flat_cloud, flat_mask = cloud[..., :3], cloud_mask
    count = state.count

    # ---- visual odometry (vloam_main_node.cpp:147-174) ----------------------
    K = ext.P_rect0[:, :3]
    proj = None if pre_buckets is not None else ext.P_rect0 @ ext.R_rect0 @ ext.cam_T_velo
    vo_state, cam0_curr_T_cam0_last = vo_step(
        state.vo, img, K, cfg, lo_prior=state.cam0_curr_LOT_cam0_prev, pre_buckets=pre_buckets,
        cloud=flat_cloud, cloud_mask=flat_mask, proj=proj)

    # frame-graph conversion + world accumulation (vloam_main_node.cpp:176-181)
    velo_last_VOT_velo_curr = fg.vo_to_velo(cam0_curr_T_cam0_last, ext)
    world_VOT_base = fg.accumulate_world(state.world_VOT_base, velo_last_VOT_velo_curr)

    # ---- scan registration + LO + mapping (:186-190) ------------------------
    if pre_gridded:
        feats = extract_features_from_grid(grid, gmask, gmask.sum(dim=1), cfg.scan,
                                           lf_table=pre_lf_table)
    else:
        feats = extract_features(flat_cloud, flat_mask, cfg.scan)
    vo_prior = None if cfg.detach_vo_lo else velo_last_VOT_velo_curr
    lo_state, lo_delta, world_LOT_base, lo_corr = lo_step(state.lo, feats, cfg, vo_prior=vo_prior)
    cam0_curr_LOT_cam0_prev = fg.lo_delta_to_cam0(lo_delta, ext)

    skip = cfg.mapping.skip_frame
    if skip > 1 and count % skip != 0:
        # skipped frames get the propagated pose wmap_wodom o wodom
        # (laser_mapping.cpp:184-208, 824-862)
        mp_state = state.mp
        world_MOT_base = geo.pose_compose(state.mp.wmap_wodom, world_LOT_base)
    else:
        mp_state, world_MOT_base = mapping_fn(
            state.mp, feats.less_sharp, feats.less_sharp_mask,
            feats.less_flat, feats.less_flat_mask, world_LOT_base, cfg,
        )

    # ---- trajectory rows rebased to cam0 at the start (vloam_tf.cpp:84-160) -
    anchor = (fg.cam0_init_pose(world_VOT_base, ext) if count == 0
              else state.cam0_init_T_cam0_start)
    new_state = VloamState(
        vo=vo_state, lo=lo_state, mp=mp_state,
        world_VOT_base=world_VOT_base,
        cam0_curr_LOT_cam0_prev=cam0_curr_LOT_cam0_prev,
        cam0_init_T_cam0_start=anchor,
        count=count + 1,
    )
    return new_state, VloamOutputs(
        vo_pose=fg.world_to_cam0_start(world_VOT_base, anchor, ext),
        lo_pose=fg.world_to_cam0_start(world_LOT_base, anchor, ext),
        mo_pose=fg.world_to_cam0_start(world_MOT_base, anchor, ext),
        world_vo=world_VOT_base, world_lo=world_LOT_base, world_mo=world_MOT_base,
        lo_corr=lo_corr,
        vo_delta=velo_last_VOT_velo_curr, lo_delta=lo_delta,
        mo_correction=mp_state.wmap_wodom,
    )
