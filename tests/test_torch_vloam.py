"""The port's full frame step (``models/vloam.vloam_step``, decoupled (D)
mode, ``pre_gridded=True``) against the JAX ``vloam_step`` over four frames
of the ``bench._gen_frames`` stream, at the small scan and map
configuration of tests/test_torch_lidar_slice.py with full 376 x 1248
images.

The JAX side runs op by op (``jax.disable_jit``), as in the slice test: the
compiled reference moves its own MO pose by millimetres (ROADMAP C).

Bounds: per frame, the VO, LO and MO world poses and the three trajectory
rows rebased to cam0 agree within 4 mm in translation (the oracle bound of
README.md) and 1e-3 rad in rotation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from vloam_tpu.config import MappingConfig, ScanConfig, kitti_hdl64
from vloam_tpu.models import frame_graph as jfg
from vloam_tpu.models.vloam import init_vloam_state as jinit
from vloam_tpu.models.vloam import vloam_step as jstep
from vloam_tpu.ops.depth_map import DepthBuckets as JBuckets
from vloam_tpu_torch import config as tconfig
from vloam_tpu_torch.data import stream
from vloam_tpu_torch.models import frame_graph as tfg
from vloam_tpu_torch.models.vloam import (frame_to_device, init_vloam_state, vloam_state_from_numpy,
                                          vloam_step)

N_FRAMES = 4
N_AZIMUTH = 700
SC = dict(ring_cap=512, max_points=32768, less_flat_cap=8192)
MC = dict(grid_w=7, grid_h=7, grid_d=3, corner_cube_cap=1024, surf_cube_cap=2048,
          corner_stack_cap=2048, surf_stack_cap=4096,
          submap_corner_cap=4096, submap_surf_cap=8192)
T_TOL, R_TOL = 4e-3, 1e-3
POSE_KEYS = ("world_vo", "world_lo", "world_mo", "vo_pose", "lo_pose", "mo_pose")


def configs(**kw):
    """(JAX config, port config) at the small scan/map sizes."""
    j = kitti_hdl64().replace(scan=ScanConfig(**SC), mapping=MappingConfig(**MC), **kw)
    t = tconfig.kitti_hdl64().replace(scan=tconfig.ScanConfig(**SC),
                                      mapping=tconfig.MappingConfig(**MC), **kw)
    return j, t


def jax_frame(frame):
    img, grid, gmask, bk, (sg, bs, nr) = frame
    return (jnp.array(img), jnp.array(grid), jnp.array(gmask), JBuckets(*(jnp.array(b) for b in bk)),
            (jnp.array(sg), jnp.array(bs), jnp.int32(nr)))


def run_jax(jcfg, frames, n):
    """n frames of the JAX step, op by op: per frame its outputs and state
    as NumPy."""
    ext = jfg.kitti_default_extrinsics()
    state, ref = jinit(jcfg), []
    with jax.disable_jit():
        for f in frames[:n]:
            img, grid, gmask, bk, lf = jax_frame(f)
            state, out = jstep(state, img, grid, gmask, ext, jcfg, pre_gridded=True,
                               pre_buckets=bk, pre_lf_table=lf)
            ref.append(dict(out={k: np.asarray(v) for k, v in out._asdict().items()},
                            state=jax.tree.map(np.asarray, state)))
    return ref


def run_port(tcfg, frames, n, state=None):
    ext = tfg.kitti_default_extrinsics("cpu")
    state = init_vloam_state(tcfg, "cpu") if state is None else state
    outs = []
    for f in frames[:n]:
        img, grid, gmask, bk, lf = frame_to_device(*f, "cpu")
        state, out = vloam_step(state, img, grid, gmask, ext, tcfg, pre_gridded=True,
                                pre_buckets=bk, pre_lf_table=lf)
        outs.append({k: v.numpy() for k, v in out._asdict().items()})
    return state, outs


def assert_pose_close(got, want, what):
    dt = np.abs(got[4:] - want[4:]).max()
    ang = 2.0 * np.arccos(min(1.0, abs(float(np.dot(got[:4], want[:4])))))
    assert dt < T_TOL and ang < R_TOL, (what, dt, ang, got, want)


@pytest.fixture(scope="module")
def runs():
    jcfg, tcfg = configs()
    frames, _ = stream.gen_frames(tcfg, tfg.kitti_default_extrinsics("cpu"), N_FRAMES,
                                  n_azimuth=N_AZIMUTH)
    ref = run_jax(jcfg, frames, N_FRAMES)
    _, port = run_port(tcfg, frames, N_FRAMES)
    return frames, ref, port


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_frame_poses_match_reference(runs, frame):
    _, ref, port = runs
    for key in POSE_KEYS:
        assert_pose_close(port[frame][key], ref[frame]["out"][key], f"frame {frame} {key}")


def test_state_carried_across_from_reference(runs):
    """Two reference frames, then the reference state moves into the port,
    and the third frame runs in both."""
    frames, ref, _ = runs
    _, tcfg = configs()
    state = vloam_state_from_numpy(ref[1]["state"], "cpu")
    assert state.count == 2 and state.vo.count == 2 and state.lo.initialized
    _, outs = run_port(tcfg, frames[2:], 1, state=state)
    for key in POSE_KEYS:
        assert_pose_close(outs[0][key], ref[2]["out"][key], f"carried {key}")


def test_stream_copy_equals_bench_frames():
    jcfg, tcfg = configs()
    got, got_poses = stream.gen_frames(tcfg, tfg.kitti_default_extrinsics("cpu"), 2)
    want, want_poses = bench._gen_frames(jcfg, jfg.kitti_default_extrinsics(), n_frames=2)
    for (g_img, g_grid, g_mask, g_bk, g_lf), (w_img, w_grid, w_mask, w_bk, w_lf) in zip(got, want):
        for a, b in zip((g_img, g_grid, g_mask, *g_bk, *g_lf), (w_img, w_grid, w_mask, *w_bk, *w_lf)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for (gR, gt), (wR, wt) in zip(got_poses, want_poses):
        np.testing.assert_array_equal(gR, wR)
        np.testing.assert_array_equal(gt, wt)
