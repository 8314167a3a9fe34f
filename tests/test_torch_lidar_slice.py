"""The port's lidar slice (grid -> scan registration -> LO -> MO) against
the JAX reference composed the same way (vloam.py:114-149, decoupled mode),
over four synthetic frames at a small map configuration.

The JAX side runs op by op (``jax.disable_jit``): compiled, XLA fuses
multiply-adds inside the mapping plane fit, whose 3x3 normal equations are
ill-conditioned for nearly collinear 5-NN sets, and that alone moves the
compiled reference's MO pose by millimetres against its own op-by-op run.

Bounds: per frame, LO and MO world translations within 4 mm (the oracle
bound of README.md, tests/test_oracle_parity.py) and rotations within
1e-3 rad; total map point counts within 0.5 % (the insert gate reads
matmul-form distances in the reference and difference-form ones here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vloam_tpu.config import MappingConfig, ScanConfig, kitti_hdl64
from vloam_tpu.data import synthetic
from vloam_tpu.data.gridding import grid_cloud, less_flat_voxel_table
from vloam_tpu.models.laser_mapping import init_map_state, mapping_step
from vloam_tpu.models.lidar_odometry import init_lo_state, lo_step
from vloam_tpu.ops.scan_registration import extract_features_from_grid
from vloam_tpu_torch import config as tconfig
from vloam_tpu_torch.models.laser_mapping import map_state_from_numpy
from vloam_tpu_torch.models.lidar_odometry import lo_state_from_numpy
from vloam_tpu_torch.models.lidar_slice import (LidarState, frame_to_device, init_lidar_state,
                                                lidar_step)

N_FRAMES = 4
SC = dict(ring_cap=512, max_points=32768, less_flat_cap=8192)
MC = dict(grid_w=7, grid_h=7, grid_d=3, corner_cube_cap=1024, surf_cube_cap=2048,
          corner_stack_cap=2048, surf_stack_cap=4096,
          submap_corner_cap=4096, submap_surf_cap=8192)
JCFG = kitti_hdl64().replace(scan=ScanConfig(**SC), mapping=MappingConfig(**MC))
TCFG = tconfig.kitti_hdl64().replace(scan=tconfig.ScanConfig(**SC),
                                     mapping=tconfig.MappingConfig(**MC))
T_TOL, R_TOL, COUNT_TOL = 4e-3, 1e-3, 0.005


def _jax_frame(lo, mp, grid, gmask, lf):
    npr = jnp.sum(gmask, axis=1).astype(jnp.int32)
    feats = extract_features_from_grid(grid, gmask, npr, JCFG.scan, lf_table=lf)
    lo, _, world_lo, _ = lo_step(lo, feats, JCFG)
    mp, world_mo = mapping_step(mp, feats.less_sharp, feats.less_sharp_mask,
                                feats.less_flat, feats.less_flat_mask, world_lo, JCFG)
    return lo, mp, np.asarray(world_lo), np.asarray(world_mo)


@pytest.fixture(scope="module")
def runs():
    scene = synthetic.default_scene()
    frames = []
    for i, (R, t) in enumerate(synthetic.straight_trajectory(N_FRAMES, speed=0.8, yaw_rate=0.005)):
        pts = synthetic.simulate_scan(R, t, scene, n_azimuth=700, noise=0.005, seed=i)
        grid, gmask, _ = grid_cloud(pts, JCFG.scan)
        frames.append((grid, gmask, less_flat_voxel_table(grid, gmask, JCFG.scan)))

    ref = []
    lo, mp = init_lo_state(JCFG), init_map_state(JCFG)
    with jax.disable_jit():
        for grid, gmask, (sg, bs, nr) in frames:
            lo, mp, wlo, wmo = _jax_frame(lo, mp, jnp.array(grid), jnp.array(gmask),
                                          (jnp.array(sg), jnp.array(bs), jnp.int32(nr)))
            ref.append(dict(world_lo=wlo, world_mo=wmo,
                            lo=jax.tree.map(np.asarray, lo), mp=jax.tree.map(np.asarray, mp)))

    port = []
    state = init_lidar_state(TCFG, "cpu")
    for f in frames:
        state, out = lidar_step(state, *frame_to_device(*f, "cpu"), TCFG)
        port.append(dict(world_lo=out.world_lo.numpy(), world_mo=out.world_mo.numpy(),
                         corner=int(state.mp.corner_cnt.sum()), surf=int(state.mp.surf_cnt.sum())))
    return frames, ref, port


def _assert_pose_close(got, want, what):
    dt = np.abs(got[4:] - want[4:]).max()
    ang = 2.0 * np.arccos(min(1.0, abs(float(np.dot(got[:4], want[:4])))))
    assert dt < T_TOL and ang < R_TOL, (what, dt, ang, got, want)


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_frame_poses_match_reference(runs, frame):
    _, ref, port = runs
    for key in ("world_lo", "world_mo"):
        _assert_pose_close(port[frame][key], ref[frame][key], f"frame {frame} {key}")


def test_map_counts_match_reference(runs):
    _, ref, port = runs
    mp = ref[-1]["mp"]
    for key, want in (("corner", mp.corner_cnt.sum()), ("surf", mp.surf_cnt.sum())):
        assert abs(port[-1][key] - int(want)) <= COUNT_TOL * int(want), (key, port[-1][key], want)


def test_state_carried_across_from_reference(runs):
    """Two reference frames, then the reference state moves into the port,
    and the third frame runs in both."""
    frames, ref, _ = runs
    state = LidarState(lo=lo_state_from_numpy(ref[1]["lo"], "cpu"),
                       mp=map_state_from_numpy(ref[1]["mp"], "cpu"))
    assert state.lo.initialized and state.mp.initialized
    _, out = lidar_step(state, *frame_to_device(*frames[2], "cpu"), TCFG)
    _assert_pose_close(out.world_lo.numpy(), ref[2]["world_lo"], "carried world_lo")
    _assert_pose_close(out.world_mo.numpy(), ref[2]["world_mo"], "carried world_mo")
