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

The step opens the reference's named scopes as spans (``utils/profiling``):
``visual_odometry``, ``scan_registration``, ``laser_odometry`` and
``laser_mapping``, timed into the caller's open ``StageTimer`` stage; VO's
is also timed on the card (``device_span``: ``dev.visual_odometry``).

``run_step`` is the step as segments (``models/segments``), cut at the
layers, at MO's two host decisions and at the four ``knn_pair`` calls;
``vloam_step`` calls them eagerly, ``models/graph_step`` replays them from
CUDA graphs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vloam_tpu_torch import geometry as geo
from vloam_tpu_torch.config import VloamConfig
from vloam_tpu_torch.models import frame_graph as fg
from vloam_tpu_torch.models.laser_mapping import (MapState, init_map_state, map_state_from_numpy,
                                                  mapping_segments)
from vloam_tpu_torch.models.lidar_odometry import (LoState, init_lo_state, lo_segments,
                                                   lo_state_from_numpy)
from vloam_tpu_torch.models.segments import eager
from vloam_tpu_torch.models.visual_odometry import (VoState, init_vo_state, vo_state_from_numpy,
                                                    vo_step)
from vloam_tpu_torch.ops.depth_map import DepthBuckets
from vloam_tpu_torch.ops.scan_registration import extract_features, extract_features_from_grid
from vloam_tpu_torch.utils.profiling import device_span, span


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
    return run_step(state, img, cloud, cloud_mask, ext, cfg, pre_gridded, pre_buckets,
                    pre_lf_table, mapping_fn, eager)


def run_step(state: VloamState, img, cloud, cloud_mask, ext: fg.Extrinsics, cfg: VloamConfig,
             pre_gridded: bool, pre_buckets, pre_lf_table, mapping_fn, run):
    """``vloam_step`` as segments called through ``run``
    (``models/segments``), each layer's new state written into ``state``'s
    tensors (``out``)."""
    if pre_gridded:
        grid, gmask = cloud, cloud_mask
        flat_cloud, flat_mask = grid.reshape(-1, 4)[:, :3], gmask.reshape(-1)
    else:
        flat_cloud, flat_mask = cloud[..., :3], cloud_mask
    count = state.count

    # ---- visual odometry (vloam_main_node.cpp:147-174) ----------------------
    def vo(vo_state, img, lo_prior, buckets, flat_cloud, flat_mask):
        proj = None if buckets is not None else ext.P_rect0 @ ext.R_rect0 @ ext.cam_T_velo
        return vo_step(vo_state, img, ext.P_rect0[:, :3], cfg, lo_prior=lo_prior,
                       pre_buckets=buckets, cloud=flat_cloud, cloud_mask=flat_mask, proj=proj)

    with span("visual_odometry"), device_span("visual_odometry", img.device):
        # vo_step reads its counter only as count > 0 and count >= 2: clamped
        # at 2, every later frame runs one variant
        vo_state, cam0_curr_T_cam0_last = run(
            "visual_odometry", vo, state.vo._replace(count=min(state.vo.count, 2)), img,
            state.cam0_curr_LOT_cam0_prev, pre_buckets, flat_cloud, flat_mask,
            out=(state.vo, None))
    vo_state = vo_state._replace(count=state.vo.count + 1)

    # frame-graph conversion + world accumulation (vloam_main_node.cpp:176-181)
    velo_last_VOT_velo_curr, world_VOT_base = run(
        "frame_graph.vo", lambda pose, world: _vo_in_world(pose, world, ext),
        cam0_curr_T_cam0_last, state.world_VOT_base, out=(None, state.world_VOT_base))

    # ---- scan registration + LO + mapping (:186-190) ------------------------
    with span("scan_registration"):
        if pre_gridded:
            feats = run("scan_registration",
                        lambda g, m, lf: extract_features_from_grid(g, m, m.sum(dim=1), cfg.scan,
                                                                    lf_table=lf),
                        grid, gmask, pre_lf_table)
        else:
            feats = run("scan_registration", lambda c, m: extract_features(c, m, cfg.scan),
                        flat_cloud, flat_mask)
    vo_prior = None if cfg.detach_vo_lo else velo_last_VOT_velo_curr
    with span("laser_odometry"):
        lo_state, lo_delta, world_LOT_base, lo_corr = lo_segments(state.lo, feats, cfg, vo_prior,
                                                                  run)
        cam0_curr_LOT_cam0_prev = run(
            "frame_graph.lo", lambda delta: fg.lo_delta_to_cam0(delta, ext), lo_delta,
            out=state.cam0_curr_LOT_cam0_prev)

    skip = cfg.mapping.skip_frame
    with span("laser_mapping"):
        if skip > 1 and count % skip != 0:
            # skipped frames get the propagated pose wmap_wodom o wodom
            # (laser_mapping.cpp:184-208, 824-862)
            mp_state = state.mp
            world_MOT_base = run("laser_mapping.skipped", geo.pose_compose, state.mp.wmap_wodom,
                                 world_LOT_base)
        else:
            args = (state.mp, feats.less_sharp, feats.less_sharp_mask,
                    feats.less_flat, feats.less_flat_mask, world_LOT_base, cfg)
            mp_state, world_MOT_base = (mapping_segments(*args, None, run) if mapping_fn is None
                                        else mapping_fn(*args))

    # ---- trajectory rows rebased to cam0 at the start (vloam_tf.cpp:84-160) -
    anchor, (vo_pose, lo_pose, mo_pose) = run(
        "frame_graph.rows", lambda *a: _rows(*a, ext), count == 0, world_VOT_base,
        world_LOT_base, world_MOT_base, state.cam0_init_T_cam0_start,
        out=(state.cam0_init_T_cam0_start, None))
    new_state = VloamState(
        vo=vo_state, lo=lo_state, mp=mp_state,
        world_VOT_base=world_VOT_base,
        cam0_curr_LOT_cam0_prev=cam0_curr_LOT_cam0_prev,
        cam0_init_T_cam0_start=anchor,
        count=count + 1,
    )
    return new_state, VloamOutputs(
        vo_pose=vo_pose, lo_pose=lo_pose, mo_pose=mo_pose,
        world_vo=world_VOT_base, world_lo=world_LOT_base, world_mo=world_MOT_base,
        lo_corr=lo_corr,
        vo_delta=velo_last_VOT_velo_curr, lo_delta=lo_delta,
        mo_correction=mp_state.wmap_wodom,
    )


def _vo_in_world(cam0_curr_T_cam0_last, world_VOT_base, ext: fg.Extrinsics):
    """VO's motion in the velodyne frame and the VO world pose it moves."""
    velo_last_VOT_velo_curr = fg.vo_to_velo(cam0_curr_T_cam0_last, ext)
    return velo_last_VOT_velo_curr, fg.accumulate_world(world_VOT_base, velo_last_VOT_velo_curr)


def _rows(first: bool, world_vo, world_lo, world_mo, anchor, ext: fg.Extrinsics):
    """The rebase anchor (captured at frame 0) and the three trajectory rows."""
    if first:
        anchor = fg.cam0_init_pose(world_vo, ext)
    return anchor, tuple(fg.world_to_cam0_start(w, anchor, ext)
                         for w in (world_vo, world_lo, world_mo))
