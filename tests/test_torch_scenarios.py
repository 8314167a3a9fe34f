"""The port's scenario worlds (``data/scenarios``), the long-drive
trajectories (``data/synthetic``), the snake and stressor streams
(``data/stream.gen_frames(snake=..., hard=...)``) and the validation-drive
tool (``tools/validate_drive``) against the JAX package.

The NumPy copies must give the reference's arrays exactly.  The coupling
scenarios of ``tests/test_coupling_modes.py`` run on the port with that
file's bounds, and are ``slow`` as there.  The tool runs at a tiny size:
its record has every key of the reference tool's record and the same mode
names.
"""

import ast
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from test_torch_runtime import few_threads  # noqa: F401  (two threads a worker)
import bench
from vloam_tpu.config import MappingConfig, ScanConfig, kitti_hdl64
from vloam_tpu.data import scenarios as jsc
from vloam_tpu.data import synthetic as jsyn
from vloam_tpu.models import frame_graph as jfg
from vloam_tpu_torch import config as tconfig
from vloam_tpu_torch import geometry_np as gnp
from vloam_tpu_torch.data import scenarios as tsc
from vloam_tpu_torch.data import stream
from vloam_tpu_torch.data import synthetic as tsyn
from vloam_tpu_torch.models import frame_graph as tfg
from vloam_tpu_torch.runtime.driver import VloamDriver
from vloam_tpu_torch.tools import validate_drive

SC = dict(ring_cap=512, max_points=32768, less_flat_cap=8192)
MC = dict(grid_w=7, grid_h=7, grid_d=3, corner_cube_cap=1024, surf_cube_cap=2048,
          corner_stack_cap=2048, surf_stack_cap=4096)
CFG = tconfig.kitti_hdl64().replace(scan=tconfig.ScanConfig(**SC),
                                    mapping=tconfig.MappingConfig(**MC), verbose_level=0)


def _equal(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name,args", [
    ("corridor_scene", (120.0,)), ("corridor_texture", (120.0,)),
    ("highway_static_scene", (300.0,)), ("truck_box", (17.5,)), ("truck_texture", (17.5,)),
    ("highway_static_texture", (300.0,)), ("highway_speeds", (40,)),
])
def test_scenario_worlds_are_the_reference_copy(name, args):
    _equal(getattr(tsc, name)(*args), getattr(jsc, name)(*args))


@pytest.mark.parametrize("name,kw", [
    ("straight_trajectory", dict(n_frames=30, speed=0.8, yaw_rate=0.005)),
    ("snake_trajectory", dict(n_frames=250, speed=0.9, yaw_amp=0.004)),
    ("turns_trajectory", dict(n_frames=80, speed=1.1, straight=24, turn_frames=9)),
    ("turns_trajectory", dict(n_frames=80, alternate=False)),
])
def test_trajectories_are_the_reference_copy(name, kw):
    _equal(getattr(tsyn, name)(**kw), getattr(jsyn, name)(**kw))


def test_routes_and_anchors_are_the_reference_copy():
    poses = tsyn.turns_trajectory(60, speed=1.1, straight=24, turn_frames=9)
    _equal(tsc.straight_poses_from_speeds(tsc.highway_speeds(20)),
           jsc.straight_poses_from_speeds(jsc.highway_speeds(20)))
    world = tsc.route_world(poses)
    _equal(world, jsc.route_world(poses))
    K = tsyn.kitti_like_intrinsics().astype(np.float64)
    got = tsc.raycast_blob_anchors(poses[:20], world, K, 376, 1248)
    want = jsc.raycast_blob_anchors(poses[:20], world, K, 376, 1248)
    for i in range(20):
        _equal(got(i), want(i))
    assert len(got(19)) > 100


def test_stressor_snake_stream_equals_bench_frames():
    """gen_frames(snake=True, hard=True) against bench._gen_frames on 3
    frames: frame 0 sees the crossing vehicle's texture, frames 1-2 the
    textureless stretch (it starts at n_frames // 3)."""
    jcfg = kitti_hdl64().replace(scan=ScanConfig(**SC), mapping=MappingConfig(**MC))
    got, got_poses = stream.gen_frames(CFG, tfg.kitti_default_extrinsics("cpu"), 3, speed=0.9,
                                       yaw_rate=0.004, snake=True, hard=True)
    want, want_poses = bench._gen_frames(jcfg, jfg.kitti_default_extrinsics(), n_frames=3,
                                         speed=0.9, yaw_rate=0.004, snake=True, hard=True)
    for (g_img, g_grid, g_mask, g_bk, g_lf), (w_img, w_grid, w_mask, w_bk, w_lf) in zip(got, want):
        _equal([g_img, g_grid, g_mask, *g_bk, *g_lf], [w_img, w_grid, w_mask, *w_bk, *w_lf])
    _equal(got_poses, want_poses)
    assert got[0][0].max() > 100 and got[1][0].max() == 0


def _reference_record_keys():
    """The keys of the record ``tools/validate_drive.py`` (the reference
    tool) builds, read from its source."""
    path = os.path.join(os.path.dirname(__file__), "..", "tools", "validate_drive.py")
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "result"
                and isinstance(node.value, ast.Dict)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no result record in tools/validate_drive.py")


def test_validate_drive_record_at_a_tiny_size():
    """The tool's drive over 5 snake frames (one timed) at the small sizes,
    in (D) with and without the exclusion; the mode names of (C) and the
    stressor world."""
    cfg = CFG.replace(mapping=dataclasses.replace(CFG.mapping, submap_corner_cap=4096,
                                                  submap_surf_cap=8192))
    cfg = cfg.replace(visual=dataclasses.replace(cfg.visual, img_height=192, img_width=624,
                                                 max_corners=256, max_features=256))
    ext = tfg.kitti_default_extrinsics("cpu")
    keys = _reference_record_keys()
    frames, poses = stream.gen_frames(cfg, ext, 5, speed=0.9, yaw_rate=0.004, n_azimuth=500,
                                      snake=True)
    plain = validate_drive.drive(cfg, ext, frames, poses)
    excl = validate_drive.drive(
        cfg.replace(scan=dataclasses.replace(cfg.scan, exclude_unreliable=True)), ext, frames,
        poses)
    assert plain["mode"] == "decoupled_D" and excl["mode"] == "excl_decoupled_D"
    for rec in (plain, excl):
        assert keys <= set(rec), keys - set(rec)
        json.dumps(rec)                       # serialisable
        assert rec["frames"] == 5 and rec["segments"] == 0 and rec["mo_trans_pct"] is None
        assert rec["final_err_pct"] < 3.0, rec
        assert rec["steady_ms_per_frame"] > 0 and rec["device"] == "cpu"
    assert validate_drive.mode_name(cfg.replace(detach_vo_lo=False), hard=True) == \
        "hard_coupled_C"
    assert validate_drive.mode_name(cfg.replace(
        detach_vo_lo=False, scan=dataclasses.replace(cfg.scan, exclude_unreliable=True)),
        hard=True) == "excl_hard_coupled_C"


def test_validate_drive_refuses_the_reference_records(tmp_path):
    with pytest.raises(SystemExit):
        validate_drive.main(["--frames", "2", "--device", "cpu",
                             "--out", str(tmp_path / "VALIDATION_r04.json")])


def test_validate_drive_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        validate_drive.main(["--frames", "2"])


# ---------------------------------------------------------------------------
# tests/test_coupling_modes.py on the port (slow, as there)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_corridor_coupled_rescues_degenerate_lo():
    n, speed = 24, 0.9
    length = n * speed + 40.0
    walls, tex = tsc.corridor_scene(length), tsc.corridor_texture(length)
    poses = tsyn.straight_trajectory(n, speed=speed)
    res = tsc.compare_modes(CFG, poses, lambda i: walls, lambda i: tex, n_azimuth=700,
                            device="cpu")
    d, c = res["decoupled_D"], res["coupled_C"]
    assert d["x_progress_ratio"] < 0.15, d
    assert c["x_progress_ratio"] > 0.45, c
    assert c["vo_x_progress_ratio"] > 0.85, c
    assert c["final_err_m"] < 0.7 * d["final_err_m"], (c, d)


@pytest.mark.slow
def test_highway_coupled_degrades_decoupled_robust():
    n = 40
    speeds = tsc.highway_speeds(n)
    poses = tsc.straight_poses_from_speeds(speeds)
    length = float(np.sum(speeds)) + 60.0
    static, static_tex = tsc.highway_static_scene(length), tsc.highway_static_texture(length)

    def boxes_fn(i):
        return np.concatenate([static, tsc.truck_box(poses[i][1][0] + 14.0)])

    def texture_fn(i):
        return np.concatenate([tsc.truck_texture(poses[i][1][0] + 14.0), static_tex])

    res = tsc.compare_modes(CFG, poses, boxes_fn, texture_fn, n_azimuth=700, device="cpu")
    d, c = res["decoupled_D"], res["coupled_C"]
    assert d["final_err_pct"] < 8.0, d
    assert d["x_progress_ratio"] > 0.85, d
    assert c["final_err_pct"] > 4.0 * d["final_err_pct"], (c, d)
    assert c["x_progress_ratio"] < 0.5, c


@pytest.mark.slow
def test_turn_onset_seed_errors_match_reference():
    """The drive of tests/test_coupling_modes.py's turn-onset test (a 90 deg
    turn at 10 deg/frame after 24 straight frames) through the port's and
    the JAX package's ``VloamDriver``: per frame, the rotation error of the
    VO seed and of the constant-motion warm start within 0.01 deg of the
    reference's.  The reference test's own assertions hold in neither
    package (ROADMAP C-g): it reads the onset at frame ``straight``, whose
    ground-truth motion is still straight, and at the true onset
    (``straight + 1``) the VO seed misses the turn as the warm start does."""
    from vloam_tpu import geometry as jgeo
    from vloam_tpu.runtime.driver import VloamDriver as JDriver
    import jax.numpy as jnp

    jcfg = kitti_hdl64().replace(scan=ScanConfig(**SC), mapping=MappingConfig(**MC))
    straight, turn_frames = 24, 9
    n = straight + turn_frames
    poses = tsyn.turns_trajectory(n, speed=1.1, straight=straight, turn_frames=turn_frames)
    world = tsc.route_world(poses)
    ext = tfg.kitti_default_extrinsics("cpu")
    K = stream.camera_matrices(ext)[0]
    vc = CFG.visual
    tex_fn = tsc.raycast_blob_anchors(poses, world, K, vc.img_height, vc.img_width)

    def rot_err_deg(a, b):
        d = gnp.pose_compose(gnp.pose_inverse(gnp.as_pose64(a)), gnp.as_pose64(b))
        return float(np.degrees(2.0 * np.arccos(np.clip(abs(d[3]), -1, 1))))

    port = VloamDriver(CFG.replace(detach_vo_lo=True), ext, device="cpu")
    ref = JDriver(jcfg.replace(detach_vo_lo=True), jfg.kitti_default_extrinsics())
    prev, errs = {}, {"port": {}, "ref": {}}
    for i, (R, t) in enumerate(poses):
        cloud = tsyn.simulate_scan(R, t, world, n_azimuth=700, noise=0.005, seed=i)
        R_wc = R @ tsyn.CAM_R_WORLD.T
        img = tsyn.render_blob_image((tex_fn(i) - t) @ R_wc, K, vc.img_height, vc.img_width)
        port.process(img, cloud)
        jout = ref.process(img, cloud)
        deltas = {"port": (port.host_out.vo_delta, port.host_out.lo_delta),
                  "ref": (np.asarray(jout.vo_delta), np.asarray(jout.lo_delta))}
        if i > 0:
            R0, t0 = poses[i - 1]
            q = np.asarray(jgeo.matrix_to_quat(jnp.array(R0.T @ R, jnp.float32)), np.float64)
            gtd = np.concatenate([q, R0.T @ (t - t0)])
            for k, (vo_d, _) in deltas.items():
                errs[k][i] = (rot_err_deg(gtd, vo_d),
                              rot_err_deg(gtd, prev[k]) if k in prev else None)
        prev = {k: lo_d for k, (_, lo_d) in deltas.items()}
    port.close()
    ref.close()
    for i in range(1, n):
        got, want = errs["port"][i], errs["ref"][i]
        for g, w in zip(got, want):
            assert (g is None) == (w is None) and (g is None or abs(g - w) < 0.01), (i, got, want)
    assert errs["ref"][straight + 1][1] > 5.0        # the warm start misses the onset
