"""The port's full frame step in the coupled (C) mode with
``mapping.skip_frame=2`` against the JAX ``vloam_step``: three frames, so
the map, skip and map branches all run.  Same stream, configuration, op-by-op
JAX reference and 4 mm / 1e-3 rad bounds as tests/test_torch_vloam.py.

Also the two repairs the coupled mode and the skip need: ``lo_step`` takes
the VO prior that seeds LO, and ``mapping_step`` no longer refuses
``skip_frame > 1`` (the skip is ``vloam_step``'s job; ``lidar_step``, which
has no skip branch, refuses it).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_vloam import POSE_KEYS, assert_pose_close, configs, run_jax, run_port
from vloam_tpu import geometry as jgeo
from vloam_tpu.models.lidar_odometry import lo_step as jlo_step
from vloam_tpu.ops.scan_registration import extract_features_from_grid as jextract
from vloam_tpu_torch.data import stream
from vloam_tpu_torch.models import frame_graph as tfg
from vloam_tpu_torch.models.laser_mapping import init_map_state, mapping_step
from vloam_tpu_torch.models.lidar_odometry import lo_state_from_numpy, lo_step
from vloam_tpu_torch.models.lidar_slice import frame_to_device as lidar_frame
from vloam_tpu_torch.models.lidar_slice import init_lidar_state, lidar_step
from vloam_tpu_torch.ops.scan_registration import extract_features_from_grid

N_FRAMES = 3
COUPLED = dict(detach_vo_lo=False)


def _skip2(cfg):
    return cfg.replace(mapping=dataclasses.replace(cfg.mapping, skip_frame=2))


@pytest.fixture(scope="module")
def runs():
    jcfg, tcfg = (_skip2(c) for c in configs(**COUPLED))
    frames, poses = stream.gen_frames(tcfg, tfg.kitti_default_extrinsics("cpu"), N_FRAMES,
                                      n_azimuth=700)
    ref = run_jax(jcfg, frames, N_FRAMES)
    _, port = run_port(tcfg, frames, N_FRAMES)
    return frames, poses, ref, port


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_coupled_skip_frame_poses_match_reference(runs, frame):
    _, _, ref, port = runs
    for key in POSE_KEYS:
        assert_pose_close(port[frame][key], ref[frame]["out"][key], f"frame {frame} {key}")


def test_skipped_frame_keeps_the_map(runs):
    """Frame 1 is skipped: the map correction stays frame 0's."""
    _, _, ref, port = runs
    np.testing.assert_array_equal(port[1]["mo_correction"], port[0]["mo_correction"])
    np.testing.assert_array_equal(ref[1]["out"]["mo_correction"], ref[0]["out"]["mo_correction"])


def test_lo_step_vo_prior_matches_reference(runs):
    """lo_step seeded with a VO prior, from the reference's carried LoState,
    in both packages (lidar_odometry.py:210)."""
    frames, poses, ref, _ = runs
    jcfg, tcfg = configs(**COUPLED)
    (R0, t0), (R1, t1) = poses[0], poses[1]
    # the true motion, perturbed: a non-identity seed away from last_delta
    q = np.asarray(jgeo.matrix_to_quat(jnp.array(R0.T @ R1, jnp.float32)))
    prior = np.concatenate([q, R0.T @ (t1 - t0) + np.array([0.05, -0.03, 0.02])]).astype(np.float32)
    _, grid, gmask, _, (sg, bs, nr) = frames[1]
    jstate = ref[0]["state"].lo
    with jax.disable_jit():
        jfeats = jextract(jnp.array(grid), jnp.array(gmask),
                          jnp.sum(jnp.array(gmask), axis=1).astype(jnp.int32), jcfg.scan,
                          lf_table=(jnp.array(sg), jnp.array(bs), jnp.int32(nr)))
        jlo = jax.tree.map(jnp.asarray, jstate)
        _, jdelta, jworld, _ = jlo_step(jlo, jfeats, jcfg, vo_prior=jnp.array(prior))
    g, m, lf = lidar_frame(grid, gmask, (sg, bs, nr), "cpu")
    feats = extract_features_from_grid(g, m, m.sum(dim=1), tcfg.scan, lf_table=lf)
    _, delta, world, _ = lo_step(lo_state_from_numpy(jstate, "cpu"), feats, tcfg,
                                 vo_prior=torch.tensor(prior))
    assert_pose_close(delta.numpy(), np.asarray(jdelta), "LO delta")
    assert_pose_close(world.numpy(), np.asarray(jworld), "LO world")


def test_mapping_step_accepts_skip_frame(runs):
    """mapping_step with skip_frame=2 runs and gives the skip_frame=1
    result on the same inputs (two frames, so the second registers)."""
    frames, _, _, _ = runs
    _, tcfg = configs()
    results = []
    for cfg in (tcfg, _skip2(tcfg)):
        mp = init_map_state(cfg, "cpu")
        for i, f in enumerate(frames[:2]):
            g, m, lf = lidar_frame(*f[1:3], f[4], "cpu")
            feats = extract_features_from_grid(g, m, m.sum(dim=1), cfg.scan, lf_table=lf)
            pose_wodom = torch.tensor([0.0, 0.0, 0.0, 1.0, 0.8 * i, 0.0, 0.0])
            mp, world = mapping_step(mp, feats.less_sharp, feats.less_sharp_mask, feats.less_flat,
                                     feats.less_flat_mask, pose_wodom, cfg)
        results.append((world, mp))
    (w1, mp1), (w2, mp2) = results
    torch.testing.assert_close(w2, w1, rtol=0, atol=0)
    assert torch.equal(mp1.corner_cnt, mp2.corner_cnt) and torch.equal(mp1.surf_cnt, mp2.surf_cnt)


def test_lidar_step_refuses_skip_frame(runs):
    frames, _, _, _ = runs
    _, tcfg = configs()
    cfg = _skip2(tcfg)
    with pytest.raises(NotImplementedError):
        lidar_step(init_lidar_state(cfg, "cpu"), *lidar_frame(*frames[0][1:3], frames[0][4], "cpu"),
                   cfg)
