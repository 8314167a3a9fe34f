"""The port's full frame step with the map sharded
(``parallel/vloam_shard.make_sharded_vloam_step``) on the CPU.

* S = 2 gloo ranks (spawned, one thread each, a file store under the test's
  temporary directory) against the port's single-device ``vloam_step`` over
  three frames of ``data/stream.gen_frames`` at the small scan and map caps
  of tests/test_torch_vloam.py with full 376 x 1248 images: ``vo_pose``,
  ``lo_pose``, ``mo_pose`` and ``world_mo`` within 5e-3 on every rank (the
  bound of ``tests/test_vloam_sharded.py``), every rank's outputs the same,
  rank-summed map counts within max(5, 0.5 %), each rank holding only its
  block of every field ``state_partition_specs`` names.
* ``slow``: the mirror of ``tests/test_vloam_sharded.py`` (its caps, the
  raw-cloud step on three scans with the blob image, S = 8): its contract
  on the port, and the map count against JAX's ``make_sharded_vloam_step``
  on all 8 virtual CPU devices.
"""

import numpy as np
import pytest
import torch

import torch_shard_ranks as ranks
from vloam_tpu_torch import config as tconfig
from vloam_tpu_torch.data import stream
from vloam_tpu_torch.models import frame_graph as tfg
from vloam_tpu_torch.models.laser_mapping import init_map_state, n_cubes
from vloam_tpu_torch.models.vloam import frame_to_device, init_vloam_state, vloam_step
from vloam_tpu_torch.parallel.vloam_shard import state_partition_specs

POSE_TOL = 5e-3
NAMES = ("vo_pose", "lo_pose", "mo_pose", "world_mo")
SC = dict(ring_cap=512, max_points=32768, less_flat_cap=8192)
MC = dict(grid_w=7, grid_h=7, grid_d=3, corner_cube_cap=1024, surf_cube_cap=2048,
          corner_stack_cap=2048, surf_stack_cap=4096,
          submap_corner_cap=4096, submap_surf_cap=8192)
CFG = tconfig.kitti_hdl64().replace(scan=tconfig.ScanConfig(**SC),
                                    mapping=tconfig.MappingConfig(**MC))


def count_tol(n: int) -> int:
    return max(5, n // 200)


def test_sharded_full_step_matches_single_device(tmp_path):
    ext = tfg.kitti_default_extrinsics("cpu")
    frames, _ = stream.gen_frames(CFG, ext, 3, n_azimuth=600)
    state, want = init_vloam_state(CFG, "cpu"), []
    for f in frames:
        img, g, m, bk, lf = frame_to_device(*f, "cpu")
        state, out = vloam_step(state, img, g, m, ext, CFG, pre_gridded=True, pre_buckets=bk,
                                pre_lf_table=lf)
        want.append(out)
    S = 2
    res = ranks.run_job(tmp_path, "vloam", S, dict(cfg=CFG, ext=ext, frames=frames))
    for r in res:
        for i, (got, ref) in enumerate(zip(r["outs"], want)):
            for name in NAMES:
                assert torch.equal(got[name], res[0]["outs"][i][name])
                np.testing.assert_allclose(got[name].numpy(), getattr(ref, name).numpy(),
                                           atol=POSE_TOL, err_msg=f"frame {i} {name}")
        assert r["map"]["cube_pts"].shape[0] == -(-n_cubes(CFG) // S) + 1
        for path in state_partition_specs():           # "mp.<field>": this rank's block only
            name = path.split(".")[1]
            whole = getattr(init_map_state(CFG, "cpu", n_shards=S), name)
            rows = whole.shape[0] - (name == "cube_pts")
            assert r["map"][name].shape[0] == rows // S + (name == "cube_pts"), name
    for name in ("corner_cnt", "surf_cnt"):
        a = int(getattr(state.mp, name).sum())
        b = sum(int(r["map"][name].sum()) for r in res)
        assert a > 0 and abs(a - b) <= count_tol(a), (name, a, b)


@pytest.mark.slow
def test_sharded_full_step_matches_single_device_and_jax_on_8_devices(tmp_path):
    """``tests/test_vloam_sharded.py``'s contract on the port, at its caps and
    drive (the raw-cloud step, the blob image), S = 8: the four outputs within
    5e-3 of the port's own single-device step a frame, the corner count within
    max(5, 0.5 %) of it and of JAX's sharded program on the 8 devices.  JAX's
    poses are not held to the port's: its compiled MO moves by up to 6 mm
    from its own op-by-op step, the port's single step lies up to 4.7 mm from
    that (ROADMAP C, C-k)."""
    import jax.numpy as jnp

    from vloam_tpu.config import MappingConfig, ScanConfig, kitti_hdl64
    from vloam_tpu.data import synthetic as jsyn
    from vloam_tpu.models import frame_graph as jfg
    from vloam_tpu.models.vloam import init_vloam_state as jinit
    from vloam_tpu.parallel.mesh import map_mesh
    from vloam_tpu.parallel.vloam_shard import make_sharded_vloam_step, shard_vloam_state

    sc = dict(ring_cap=512, max_points=32768, less_flat_cap=8192)
    mc = dict(grid_w=7, grid_h=7, grid_d=3, corner_cube_cap=1024, surf_cube_cap=2048,
              corner_stack_cap=2048, surf_stack_cap=4096)
    jcfg = kitti_hdl64().replace(scan=ScanConfig(**sc), mapping=MappingConfig(**mc))
    tcfg = tconfig.kitti_hdl64().replace(scan=tconfig.ScanConfig(**sc),
                                         mapping=tconfig.MappingConfig(**mc))
    S = 8
    jext = jfg.kitti_default_extrinsics()
    vc = jcfg.visual
    scene = jsyn.default_scene()
    poses = jsyn.straight_trajectory(3, speed=0.8, yaw_rate=0.01)
    K = np.asarray(jext.P_rect0)[:, :3].astype(np.float64)
    rng = np.random.default_rng(3)
    uv0 = np.stack([rng.uniform(20, vc.img_width - 20, 600),
                    rng.uniform(20, vc.img_height - 20, 600)], -1)
    R_wc0 = poses[0][0] @ jsyn.CAM_R_WORLD.T
    pc0, hit = jsyn.raycast_camera(R_wc0, poses[0][1], scene, K, uv0)
    blob_world = (pc0[hit] @ R_wc0.T) + poses[0][1]
    frames = []
    for i, (R, t) in enumerate(poses):
        pts = jsyn.simulate_scan(R, t, scene, n_azimuth=500, noise=0.005, seed=i)
        p, m = jsyn.pad_cloud(pts, jcfg.scan.max_points)
        img = jsyn.render_blob_image((blob_world - t) @ (R @ jsyn.CAM_R_WORLD.T), K,
                                     vc.img_height, vc.img_width)
        frames.append((img, p, m))
    text = tfg.kitti_default_extrinsics("cpu")
    state, want = init_vloam_state(tcfg, "cpu"), []
    for img, p, m in frames:
        state, out = vloam_step(state, torch.tensor(img), torch.tensor(p), torch.tensor(m), text,
                                tcfg)
        want.append(out)
    res = ranks.run_job(tmp_path, "vloam_raw", S, dict(cfg=tcfg, frames=frames))
    for i, ref in enumerate(want):
        for name in NAMES:
            np.testing.assert_allclose(res[0]["outs"][i][name].numpy(), getattr(ref, name).numpy(),
                                       atol=POSE_TOL, err_msg=f"frame {i} {name}")
    step = make_sharded_vloam_step(jcfg, jext, map_mesh(S))
    jstate = shard_vloam_state(jinit(jcfg, n_map_shards=S), map_mesh(S))
    for img, p, m in frames:
        jstate, _ = step(jstate, jnp.array(img), jnp.array(p), jnp.array(m))
    got = sum(int(r["map"]["corner_cnt"].sum()) for r in res)
    for n in (int(state.mp.corner_cnt.sum()), int(np.asarray(jstate.mp.corner_cnt).sum())):
        assert abs(got - n) <= count_tol(n), (got, n)
