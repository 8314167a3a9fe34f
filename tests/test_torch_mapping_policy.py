"""The port's reference-exact map policy (``MappingConfig.insert_dedup=False``:
a fresh submap gather every frame, every registered point inserted, the
window's cubes re-voxelised after the insert) against the JAX
``mapping_step``, and the policy contract of
``tests/test_mapping_policy_parity.py`` on the port alone.

* Three frames at the slice tests' small caps: the port's scan
  registration and LO make the feature clouds and LO poses, both packages'
  ``mapping_step`` map them (the JAX side op by op).  Poses within the
  slice's 4 mm / 1e-3 rad; map counts within 0.5 %; the submap cache left
  as it was (this path never reads or writes it); each cube's count within
  1 % + 1 of its reference, and each centroid within a voxel of one of its
  reference's, both ways.
* ``slow``: the same drive as ``tests/test_mapping_policy_parity.py`` (8
  frames at a larger scan size) through both policies in the port, with
  its three asserts: mean error of the dedup path within 1.5x the
  reference-exact path's + 1 cm, its worst error under 3 % of the path,
  and its map larger than the reference-exact one but under twice it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_runtime import few_threads  # noqa: F401  (two threads a worker)
from vloam_tpu.config import MappingConfig, ScanConfig, kitti_hdl64
from vloam_tpu.models import laser_mapping as jmap
from vloam_tpu_torch import config as tconfig
from vloam_tpu_torch.data import synthetic
from vloam_tpu_torch.models import laser_mapping as tmap
from vloam_tpu_torch.models.lidar_odometry import init_lo_state, lo_step
from vloam_tpu_torch.ops.scan_registration import extract_features

N_FRAMES = 3
SC = dict(ring_cap=512, max_points=32768, less_flat_cap=8192)
MC = dict(grid_w=7, grid_h=7, grid_d=3, corner_cube_cap=1024, surf_cube_cap=2048,
          corner_stack_cap=2048, surf_stack_cap=4096,
          submap_corner_cap=4096, submap_surf_cap=8192, insert_dedup=False)
T_TOL, R_TOL, COUNT_TOL = 4e-3, 1e-3, 0.005


def _feeds(tcfg, poses, n_azimuth):
    """Feature clouds and LO world poses of the synthetic scans at ``poses``."""
    scene = synthetic.default_scene()
    lo, feeds = init_lo_state(tcfg, "cpu"), []
    for i, (R, t) in enumerate(poses):
        pts = synthetic.simulate_scan(R, t, scene, n_azimuth=n_azimuth, noise=0.005, seed=i)
        p, m = synthetic.pad_cloud(pts, tcfg.scan.max_points)
        feats = extract_features(torch.tensor(p), torch.tensor(m), tcfg.scan)
        lo, _, world_lo, _ = lo_step(lo, feats, tcfg)
        feeds.append((feats.less_sharp, feats.less_sharp_mask, feats.less_flat,
                      feats.less_flat_mask, world_lo))
    return feeds


@pytest.fixture(scope="module")
def runs():
    jcfg = kitti_hdl64().replace(scan=ScanConfig(**SC), mapping=MappingConfig(**MC))
    tcfg = tconfig.kitti_hdl64().replace(scan=tconfig.ScanConfig(**SC),
                                         mapping=tconfig.MappingConfig(**MC))
    feeds = _feeds(tcfg, synthetic.straight_trajectory(N_FRAMES, speed=0.8, yaw_rate=0.005), 500)
    state = tmap.init_map_state(tcfg, "cpu")
    cache0 = [x.clone() for x in (state.sub_c, state.sub_c_n, state.sub_s, state.sub_s_n,
                                  state.sub_center)]
    port = []
    for feed in feeds:
        state, pose = tmap.mapping_step(state, *feed, tcfg)
        port.append(pose.numpy())
    jstate, ref = jmap.init_map_state(jcfg), []
    with jax.disable_jit():
        for feed in feeds:
            jstate, pose = jmap.mapping_step(jstate, *(jnp.array(x.numpy()) for x in feed), jcfg)
            ref.append(np.asarray(pose))
    return dict(port=port, ref=ref, state=state, cache0=cache0,
                jstate=jax.tree.map(np.asarray, jstate), cfg=tcfg)


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_reference_policy_pose_matches_reference(runs, frame):
    got, want = runs["port"][frame], runs["ref"][frame]
    dt = np.abs(got[4:] - want[4:]).max()
    ang = 2.0 * np.arccos(min(1.0, abs(float(np.dot(got[:4], want[:4])))))
    assert np.isfinite(got).all() and dt < T_TOL and ang < R_TOL, (frame, dt, ang, got, want)


def test_reference_policy_map_matches_reference(runs):
    state, jstate, mc = runs["state"], runs["jstate"], runs["cfg"].mapping
    for got, want in ((state.corner_cnt, jstate.corner_cnt), (state.surf_cnt, jstate.surf_cnt)):
        got, want = got.numpy(), want
        assert want.sum() > 0 and abs(int(got.sum()) - int(want.sum())) <= COUNT_TOL * want.sum()
        # a sub-mm pose difference moves a point across a voxel face now and then
        assert np.all(np.abs(got - want) <= 0.01 * want + 1), (got[want > 0], want[want > 0])
    np.testing.assert_array_equal(state.cube_coord.numpy(), jstate.cube_coord)
    # every centroid has one of its reference's within a voxel, both ways
    cube, jcube = state.cube_pts[:-1].numpy(), jstate.cube_pts
    for cnt, jcnt, off, leaf in ((state.corner_cnt, jstate.corner_cnt, 0, mc.line_resolution),
                                 (state.surf_cnt, jstate.surf_cnt, mc.corner_cube_cap,
                                  mc.plane_resolution)):
        for k in np.flatnonzero(jcnt > 0):
            a = cube[k, off:off + int(cnt[k]), :3]
            b = jcube[k, off:off + jcnt[k], :3]
            d = np.linalg.norm(a[:, None] - b[None], axis=-1)
            assert d.min(axis=1).max() <= leaf and d.min(axis=0).max() <= leaf, k


def test_reference_policy_leaves_the_cache(runs):
    state, cache0 = runs["state"], runs["cache0"]
    for a, b in zip((state.sub_c, state.sub_c_n, state.sub_s, state.sub_s_n, state.sub_center),
                    cache0):
        assert torch.equal(a, b)


@pytest.mark.slow
def test_insert_dedup_pose_gap_vs_reference_exact_revoxelize():
    """The port alone on tests/test_mapping_policy_parity.py's drive and bounds."""
    sc = dict(ring_cap=1024, max_points=65536, less_flat_cap=16384)
    mk = dict(grid_w=7, grid_h=7, grid_d=3, corner_cube_cap=1024, surf_cube_cap=2048,
              corner_stack_cap=2048, surf_stack_cap=4096)
    base = tconfig.kitti_hdl64().replace(scan=tconfig.ScanConfig(**sc))
    poses = synthetic.straight_trajectory(8, speed=0.9, yaw_rate=0.01)
    feeds = _feeds(base.replace(mapping=tconfig.MappingConfig(**mk)), poses, 700)

    def run(dedup):
        cfg = base.replace(mapping=tconfig.MappingConfig(**mk, insert_dedup=dedup))
        mp, out = tmap.init_map_state(cfg, "cpu"), []
        for feed in feeds:
            mp, pose_w = tmap.mapping_step(mp, *feed, cfg)
            out.append(pose_w.numpy())
        return np.stack(out), int(mp.corner_cnt.sum() + mp.surf_cnt.sum())

    (poses_fast, n_fast), (poses_ref, n_ref) = run(True), run(False)
    gt = np.stack([t for _, t in poses])
    err_fast = np.linalg.norm(poses_fast[:, 4:] - gt, axis=1)
    err_ref = np.linalg.norm(poses_ref[:, 4:] - gt, axis=1)
    path_len = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    assert np.mean(err_fast) < 1.5 * np.mean(err_ref) + 0.01, (np.mean(err_fast), np.mean(err_ref))
    assert np.max(err_fast) / max(path_len, 1e-9) < 0.03, err_fast
    assert n_ref < n_fast < 2 * n_ref, (n_fast, n_ref)
