"""The lidar half of one frame: scan registration -> LO -> MO.

Composes the modules exactly as ``vloam_tpu/models/vloam.vloam_step`` does
on its ``pre_gridded=True`` path in the decoupled mode (vloam.py:114-149),
where VO is a passenger and these three stages alone produce the LO and MO
trajectories.  The host data layer (``data/gridding``) builds the ring grid
and the less-flat voxel table; ``frame_to_device`` moves them to the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vloam_tpu_torch.config import VloamConfig
from vloam_tpu_torch.models.laser_mapping import MapState, init_map_state, mapping_step
from vloam_tpu_torch.models.lidar_odometry import LoState, init_lo_state, lo_step
from vloam_tpu_torch.ops.scan_registration import extract_features_from_grid


class LidarState(NamedTuple):
    lo: LoState
    mp: MapState


class LidarOutputs(NamedTuple):
    world_lo: torch.Tensor   # (7,) world_T_base from LO
    world_mo: torch.Tensor   # (7,) world_T_base from mapping
    lo_delta: torch.Tensor   # (7,) velo_last_LOT_velo_curr
    lo_corr: torch.Tensor    # (2,) LO edge/plane correspondence counts


def init_lidar_state(cfg: VloamConfig, device) -> LidarState:
    return LidarState(lo=init_lo_state(cfg, device), mp=init_map_state(cfg, device))


def frame_to_device(grid: np.ndarray, gmask: np.ndarray, lf_table, device):
    """Host ring grid + less-flat table -> (grid, gmask, lf_table) tensors."""
    slot_grid, base_sums, n_runs = lf_table
    return (
        torch.as_tensor(grid, device=device),
        torch.as_tensor(gmask, device=device),
        (torch.as_tensor(slot_grid, device=device), torch.as_tensor(base_sums, device=device),
         int(n_runs)),
    )


def lidar_step(state: LidarState, grid, gmask, lf_table, cfg: VloamConfig):
    """One frame of scan registration + LO + MO on a pre-gridded scan.
    Returns (new_state, LidarOutputs)."""
    if not cfg.detach_vo_lo:
        raise NotImplementedError("the coupled (C) mode needs VO: use models/vloam.vloam_step")
    if cfg.mapping.skip_frame > 1:
        raise NotImplementedError("MappingConfig.skip_frame > 1: use models/vloam.vloam_step")
    n_per_ring = gmask.sum(dim=1)
    feats = extract_features_from_grid(grid, gmask, n_per_ring, cfg.scan, lf_table=lf_table)
    lo_state, lo_delta, world_lo, lo_corr = lo_step(state.lo, feats, cfg)
    mp_state, world_mo = mapping_step(
        state.mp, feats.less_sharp, feats.less_sharp_mask,
        feats.less_flat, feats.less_flat_mask, world_lo, cfg,
    )
    return LidarState(lo_state, mp_state), LidarOutputs(world_lo, world_mo, lo_delta, lo_corr)
