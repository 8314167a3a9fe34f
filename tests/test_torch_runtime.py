"""The port's runtime entry point (``vloam_tpu_torch.runtime``: VloamDriver,
run_synthetic, the CLI, trajectory export, checkpoint/resume) and its host
modules against the JAX package's.  (VloamDriver as a whole against the JAX
VloamDriver over five frames is tests/test_torch_runtime_slice.py.)

* ``geometry_np``, ``utils/trajectory``, ``utils/kitti_eval`` and
  ``data/kitti`` are copies: bit-equal results on random inputs and on files
  the test writes.
* The host f64 chains and the export: the same sequence of step outputs
  (one frame with a NaN delta) through both drivers gives byte-identical
  VO/LO/MO files.
* Checkpoints: save -> load is exact, and resume at frame 3 of 6 equals the
  uninterrupted run exactly on the CPU (files included).
* The CLI in a subprocess, at a small configuration.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from test_kitti_loader import P_RECT, _fmt, make_raw_drive, write_bin, write_raw_calib
from vloam_tpu import geometry_np as jgnp
from vloam_tpu.config import MappingConfig, ScanConfig, kitti_hdl64
from vloam_tpu.data import kitti as jkitti
from vloam_tpu.models import frame_graph as jfg
from vloam_tpu.models.vloam import VloamOutputs as JOutputs
from vloam_tpu.runtime import driver as jdriver
from vloam_tpu.utils import kitti_eval as jeval
from vloam_tpu.utils import trajectory as jtraj
from vloam_tpu_torch import config as tconfig
from vloam_tpu_torch import geometry_np as tgnp
from vloam_tpu_torch.data import kitti as tkitti
from vloam_tpu_torch.data import synthetic
from vloam_tpu_torch.data.stream import camera_matrices
from vloam_tpu_torch.models import frame_graph as tfg
from vloam_tpu_torch.models.vloam import VloamOutputs, init_vloam_state
from vloam_tpu_torch.runtime import driver as tdriver
from vloam_tpu_torch.utils import checkpoint as tckpt
from vloam_tpu_torch.utils import kitti_eval as teval
from vloam_tpu_torch.utils import trajectory as ttraj
from vloam_tpu_torch.utils.profiling import StageTimer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ("VO1.txt", "LO1.txt", "MO1.txt")

# the small sizes of tests/test_torch_vloam.py
SC = dict(ring_cap=512, max_points=32768, less_flat_cap=8192)
MC = dict(grid_w=7, grid_h=7, grid_d=3, corner_cube_cap=1024, surf_cube_cap=2048,
          corner_stack_cap=2048, surf_stack_cap=4096,
          submap_corner_cap=4096, submap_surf_cap=8192)
# the tiny sizes of tests/test_checkpoint.py
SC_TINY = dict(ring_cap=128, max_points=4096, less_flat_cap=4096)
MC_TINY = dict(grid_w=5, grid_h=5, grid_d=3, corner_cube_cap=128, surf_cube_cap=256,
               corner_stack_cap=256, surf_stack_cap=512)


def configs(sc, mc):
    j = kitti_hdl64().replace(scan=ScanConfig(**sc), mapping=MappingConfig(**mc), verbose_level=0)
    t = tconfig.kitti_hdl64().replace(scan=tconfig.ScanConfig(**sc),
                                      mapping=tconfig.MappingConfig(**mc), verbose_level=0)
    return j, t


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module runs: the suite runs several
    workers side by side, and eight threads each only fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_frames(cfg, n, n_azimuth, speed=0.8, yaw_rate=0.005):
    """(image, cloud) per frame, the way ``run_synthetic`` makes them."""
    ext = tfg.kitti_default_extrinsics("cpu")
    boxes = synthetic.default_scene()
    poses = synthetic.straight_trajectory(n, speed=speed, yaw_rate=yaw_rate)
    K = camera_matrices(ext)[0]
    rng = np.random.default_rng(11)
    vc = cfg.visual
    uv0 = np.stack([rng.uniform(20, vc.img_width - 20, 1400),
                    rng.uniform(20, vc.img_height - 20, 1400)], -1)
    R_wc0 = poses[0][0] @ synthetic.CAM_R_WORLD.T
    pc0, hit = synthetic.raycast_camera(R_wc0, poses[0][1], boxes, K, uv0)
    blob_world = (pc0[hit] @ R_wc0.T) + poses[0][1]
    frames = []
    for i, (R, t) in enumerate(poses):
        cloud = synthetic.simulate_scan(R, t, boxes, n_azimuth=n_azimuth, noise=0.005, seed=i)
        R_wc = R @ synthetic.CAM_R_WORLD.T
        img = synthetic.render_blob_image((blob_world - t) @ R_wc, K, vc.img_height, vc.img_width)
        frames.append((img, cloud))
    return frames, poses


def read(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# the copied host modules
# ---------------------------------------------------------------------------

def _rand_pose(rng, scale=50.0):
    q = rng.normal(size=4)
    return np.concatenate([q / np.linalg.norm(q), rng.uniform(-scale, scale, 3)])


@pytest.mark.parametrize("fn", ["pose_compose", "pose_inverse", "pose_to_matrix", "quat_mul",
                                "quat_rotate", "quat_to_matrix", "as_pose64", "pose_identity"])
def test_geometry_np_is_the_reference_copy(fn, rng):
    for _ in range(20):
        a, b = _rand_pose(rng), _rand_pose(rng)
        args = {"pose_compose": (a, b), "pose_inverse": (a,), "pose_to_matrix": (a,),
                "quat_mul": (a[:4], b[:4]), "quat_rotate": (a[:4], b[4:]),
                "quat_to_matrix": (a[:4],), "as_pose64": (a.astype(np.float32) * 1.01,),
                "pose_identity": ()}[fn]
        np.testing.assert_array_equal(getattr(tgnp, fn)(*args), getattr(jgnp, fn)(*args))


def test_trajectory_rows_and_round_trip(tmp_path, rng):
    poses = [_rand_pose(rng, 500.0) for _ in range(25)]
    for p in poses:
        assert ttraj.pose_to_kitti_row(p) == jtraj.pose_to_kitti_row(p)
    pt, pj = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    with ttraj.TrajectoryWriter(pt) as wt, jtraj.TrajectoryWriter(pj) as wj:
        for p in poses:
            wt.append(p)
            wj.append(p)
    assert read(pt) == read(pj)
    # the reference's format: 12 "%f" numbers a row, parseable line for
    # line and equal to the 3x4 [R|t] after reload (6 decimals)
    lines = read(pt).decode().splitlines()
    assert len(lines) == 25 and all(len(ln.split()) == 12 for ln in lines)
    assert all(len(tok.split(".")[1]) == 6 for ln in lines for tok in ln.split())
    back = ttraj.load_kitti_trajectory(pt)
    assert back.shape == (25, 3, 4)
    np.testing.assert_array_equal(back, jtraj.load_kitti_trajectory(pj))
    want = np.stack([tgnp.pose_to_matrix(p)[:3] for p in poses])
    np.testing.assert_allclose(back, want, atol=5.1e-7)


def test_trajectory_writer_resume_truncates(tmp_path, rng):
    poses = [_rand_pose(rng) for _ in range(8)]
    path = str(tmp_path / "t.txt")
    w = ttraj.TrajectoryWriter(path)
    for p in poses:
        w.append(p)
    w.close()
    whole = read(path)
    w = ttraj.TrajectoryWriter(path)
    w.resume_at(5)
    assert w.rows == 5
    for p in poses[5:]:
        w.append(p)
    w.close()
    assert read(path) == whole
    with pytest.raises(RuntimeError):
        w2 = ttraj.TrajectoryWriter(path)
        w2.append(poses[0])
        w2.resume_at(1)


def _drifting_traj(rng, n=400):
    gt = np.tile(np.eye(4)[:3], (n, 1, 1))
    yaw = np.cumsum(rng.normal(0, 0.01, n))
    gt[:, 0, 0], gt[:, 0, 1], gt[:, 1, 0], gt[:, 1, 1] = np.cos(yaw), -np.sin(yaw), np.sin(yaw), np.cos(yaw)
    gt[:, :, 3] = np.cumsum(np.stack([np.cos(yaw), np.sin(yaw), np.zeros(n)], -1), axis=0)
    est = gt.copy()
    est[:, :, 3] = gt[:, :, 3] * 1.02 + np.cumsum(rng.normal(0, 0.01, (n, 3)), axis=0)
    return gt, est


def test_kitti_eval_is_the_reference_copy(rng):
    gt, est = _drifting_traj(rng)
    res, jres = teval.evaluate(gt, est), jeval.evaluate(gt, est)
    assert res == jres and res["segments"] > 0 and 1.0 < res["trans_pct"] < 4.0
    assert teval.ate(gt, est) == jeval.ate(gt, est) > 0.0
    np.testing.assert_array_equal(np.asarray(teval.kitti_errors(gt, est)),
                                  np.asarray(jeval.kitti_errors(gt, est)))


def test_stage_timer_summary_format():
    timer = StageTimer()
    for _ in range(3):
        with timer.stage("vloam_step"):
            pass
    with timer.stage("host_grid"):
        pass
    lines = timer.summary().splitlines()
    assert [ln.split()[0] for ln in lines] == ["vloam_step", "host_grid"]
    assert lines[0].endswith("n=3") and " avg " in lines[0] and " max " in lines[0]


# ---------------------------------------------------------------------------
# data/kitti.py on files the test writes
# ---------------------------------------------------------------------------

def _calib_equal(a, b):
    for name in ("cam_T_velo", "rect0_T_cam", "P_rect0", "proj"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_kitti_raw_calib(tmp_path):
    date_dir = str(tmp_path / "2026_03_15")
    write_raw_calib(date_dir)
    calib = tkitti.load_calib_raw(date_dir)
    _calib_equal(calib, jkitti.load_calib_raw(date_dir))
    np.testing.assert_allclose(calib.P_rect0, P_RECT, atol=1e-12)
    ext = tdriver.extrinsics_from_calib(calib, "cpu")
    jext = jdriver.extrinsics_from_calib(calib)
    for got, want in zip(ext, jext):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_kitti_odometry_calib(tmp_path):
    seq_dir = tmp_path / "sequences" / "04"
    seq_dir.mkdir(parents=True)
    Tr = np.hstack([np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]]),
                    np.array([[0.011], [-0.054], [-0.292]])])
    with open(seq_dir / "calib.txt", "w") as f:
        for i in range(4):
            f.write(f"P{i}: {_fmt(P_RECT + float(i))}\n")
        f.write(f"Tr: {_fmt(Tr)}\n")
    calib = tkitti.load_calib_odometry(str(seq_dir))
    _calib_equal(calib, jkitti.load_calib_odometry(str(seq_dir)))
    np.testing.assert_allclose(calib.P_rect0, P_RECT, atol=1e-12)     # P0, not P1-3


def test_kitti_bin_loader(tmp_path, rng):
    xyz = rng.uniform(-50, 50, (1000, 3)).astype(np.float32)
    path = str(tmp_path / "cloud.bin")
    write_bin(path, xyz, np.full((1000,), 1.0e9, np.float32))         # a stride slip shows
    out = tkitti.load_bin(path)
    assert out.shape == (1000, 3) and out.dtype == np.float32
    np.testing.assert_array_equal(out, xyz)
    np.testing.assert_array_equal(out, jkitti.load_bin(path))


def test_kitti_raw_sequence(tmp_path, rng):
    clouds = [rng.uniform(-30, 30, (200 + 50 * i, 3)).astype(np.float32) for i in range(3)]
    images = [rng.uniform(0, 255, (120, 250)) for _ in range(3)]
    make_raw_drive(str(tmp_path), "2026_03_15", "0007", clouds, images)
    seq = tkitti.RawSequence(str(tmp_path), "2026_03_15", "0007")
    jseq = jkitti.RawSequence(str(tmp_path), "2026_03_15", "0007")
    assert len(seq) == len(jseq) == 3
    for i, (fr, jfr) in enumerate(zip(seq, jseq)):
        assert fr.index == jfr.index == i
        np.testing.assert_array_equal(fr.cloud, clouds[i])
        np.testing.assert_array_equal(fr.image, jfr.image)
        assert fr.image.shape == (120, 250) and fr.image.dtype == np.float32


# ---------------------------------------------------------------------------
# host chains and export, without running a step
# ---------------------------------------------------------------------------

def _fake_outputs(rng, n):
    """n frames of step outputs as NumPy (f32): small deltas, world poses a
    little off the exact chain, and one frame with a NaN LO delta."""
    outs = []
    for i in range(n):
        def small():
            q = np.array([*rng.normal(0, 0.01, 3), 1.0])
            return np.concatenate([q / np.linalg.norm(q), rng.normal(0, 0.5, 3)]).astype(np.float32)
        f = dict(vo_delta=small(), lo_delta=small(), mo_correction=small(),
                 world_vo=_rand_pose(rng).astype(np.float32),
                 world_lo=_rand_pose(rng).astype(np.float32),
                 world_mo=_rand_pose(rng).astype(np.float32),
                 lo_corr=np.array([300, 900], np.int32))
        if i == 4:
            f["lo_delta"] = np.full(7, np.nan, np.float32)
        if i == 6:
            f["vo_delta"] = np.full(7, np.nan, np.float32)
        outs.append(f)
    return outs


def test_host_chains_and_export_match_jax_driver(tmp_path, rng):
    jcfg, tcfg = configs(SC_TINY, MC_TINY)
    jdrv = jdriver.VloamDriver(jcfg, jfg.kitti_default_extrinsics(), out_dir=str(tmp_path / "j"))
    tdrv = tdriver.VloamDriver(tcfg, tfg.kitti_default_extrinsics("cpu"),
                               out_dir=str(tmp_path / "t"), device="cpu")
    none = dict(vo_pose=None, lo_pose=None, mo_pose=None)
    for f in _fake_outputs(rng, 10):
        for drv, out in ((jdrv, JOutputs(**none, **f)), (tdrv, VloamOutputs(**none, **f))):
            drv._accumulate_f64(out)
            for key, chain in (("vo", drv._w_vo64), ("lo", drv._w_lo64), ("mo", drv._w_mo64)):
                drv.writers[key].append(drv._export_row(chain))
        for name in ("_w_vo64", "_w_lo64", "_w_mo64", "_anchor64"):
            np.testing.assert_array_equal(getattr(tdrv, name), getattr(jdrv, name))
    jdrv.close()
    tdrv.close()
    assert tdrv.f32_divergence_m == jdrv.f32_divergence_m
    for name in FILES:
        got = read(str(tmp_path / "t" / name))
        assert got == read(str(tmp_path / "j" / name)) and got.count(b"\n") == 10
        traj = ttraj.load_kitti_trajectory(str(tmp_path / "t" / name))
        R = traj[:, :, :3]
        assert np.isfinite(traj).all()
        assert np.abs(R @ R.transpose(0, 2, 1) - np.eye(3)).max() < 1e-5


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip(tmp_path):
    tcfg = configs(SC_TINY, MC_TINY)[1]
    state = init_vloam_state(tcfg, "cpu")
    state.world_VOT_base[4] = 3.25
    state.mp.corner_cnt[3] = 9
    state.vo.prev_pts_mask[5] = True
    state = state._replace(count=17, vo=state.vo._replace(count=17),
                           lo=state.lo._replace(initialized=True),
                           mp=state.mp._replace(initialized=True))
    path = str(tmp_path / "ckpt")
    tckpt.save_checkpoint(path, state, 17)
    restored, frame = tckpt.load_checkpoint(path, init_vloam_state(tcfg, "cpu"))
    assert frame == 17 and type(restored) is type(state) and type(restored.mp) is type(state.mp)
    assert restored.count == 17 and restored.vo.count == 17
    assert restored.lo.initialized is True and restored.mp.initialized is True
    want, got = tckpt.tree_leaves(state), tckpt.tree_leaves(restored)
    assert len(want) == len(got) > 30
    for a, b in zip(want, got):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b
    # a template of another size is refused
    other = configs(SC, MC_TINY)[1]
    with pytest.raises(ValueError, match="leaf"):
        tckpt.load_checkpoint(path, init_vloam_state(other, "cpu"))


def test_driver_resume_equals_uninterrupted(tmp_path):
    """Interrupted after the frame-3 checkpoint and resumed: trajectory
    files byte-identical to the uninterrupted run's, final state and chains
    equal (the CPU path has no atomics, so exactly)."""
    tcfg = configs(SC_TINY, MC_TINY)[1]
    # half-size images and 256 features keep the 15 frames of this test short
    tcfg = tcfg.replace(visual=dataclasses.replace(tcfg.visual, img_height=192, img_width=624,
                                                   max_corners=256, max_features=256))
    frames, _ = make_frames(tcfg, 6, 300, yaw_rate=0.004)
    ext = tfg.kitti_default_extrinsics("cpu")

    da = tdriver.VloamDriver(tcfg, ext, out_dir=str(tmp_path / "a"), device="cpu")
    for f in frames:
        da.process(*f)
    da.close()

    ck = str(tmp_path / "ck")
    db = tdriver.VloamDriver(tcfg, ext, out_dir=str(tmp_path / "b"), checkpoint_dir=ck,
                             checkpoint_every=3, device="cpu")
    for f in frames[:5]:
        db.process(*f)
    for w in db.writers.values():
        w.flush()
    del db                                   # no close(): a crash after frame 4
    assert sorted(os.listdir(ck)) == ["ckpt_000003", "ckpt_000003_driver.npz"]

    dc = tdriver.VloamDriver(tcfg, ext, out_dir=str(tmp_path / "b"), device="cpu")
    assert dc.restore_checkpoint(os.path.join(ck, "ckpt_000003")) == 3
    assert dc.state.count == 3 and dc.state.lo.initialized and dc.state.mp.initialized
    for f in frames[3:]:
        dc.process(*f)
    dc.close()

    for name in FILES:
        got = read(str(tmp_path / "b" / name))
        assert got == read(str(tmp_path / "a" / name)) and got.count(b"\n") == 6, name
    # the map's last slot is scrap: every rejected insert row lands on its row
    # 0, and which of them stays there is not defined
    sa = da.state._replace(mp=da.state.mp._replace(cube_pts=da.state.mp.cube_pts[:-1]))
    sc = dc.state._replace(mp=dc.state.mp._replace(cube_pts=dc.state.mp.cube_pts[:-1]))
    for a, b in zip(tckpt.tree_leaves(sa), tckpt.tree_leaves(sc)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    for name in ("_w_vo64", "_w_lo64", "_w_mo64", "_anchor64"):
        np.testing.assert_array_equal(getattr(da, name), getattr(dc, name))
    assert da.f32_divergence_m == dc.f32_divergence_m


# ---------------------------------------------------------------------------
# entry points: device, unported options, the CLI
# ---------------------------------------------------------------------------

def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a GPU")
    tcfg = configs(SC_TINY, MC_TINY)[1]
    with pytest.raises(RuntimeError, match="cuda"):
        tdriver.VloamDriver(tcfg, tfg.kitti_default_extrinsics("cpu"))
    with pytest.raises(RuntimeError, match="cuda"):
        tdriver.run_synthetic(tcfg, n_frames=1, verbose=False)


def test_driver_writes_debug_pngs(tmp_path):
    """``dump_debug`` at every ``debug_every``-th frame, each PNG against the
    JAX driver's ``dump_debug`` on the same image and grid: the keypoints
    image equal, the flow and depth images equal on >= 99.9 % of the pixels
    (a track or projection within rounding of a pixel edge may land one
    pixel over)."""
    from PIL import Image

    jcfg, tcfg = configs(SC_TINY, MC_TINY)
    frames, _ = make_frames(tcfg, 3, n_azimuth=120)
    tdir, jdir = tmp_path / "port", tmp_path / "ref"
    drv = tdriver.VloamDriver(tcfg, tfg.kitti_default_extrinsics("cpu"), debug_dir=str(tdir),
                              debug_every=2, device="cpu")
    jdrv = jdriver.VloamDriver(jcfg, jfg.kitti_default_extrinsics(), debug_dir=str(jdir),
                               debug_every=2)
    for i, (img, cloud) in enumerate(frames):
        drv.process(img, cloud)
        if i % 2 == 0:
            grid, gmask, _ = jdriver.grid_cloud(cloud.astype(np.float32), jcfg.scan)
            jdrv.count = i
            jdrv.dump_debug(jdriver.pad_image(img, jcfg), grid, gmask)
    names = {"keypoints_000000.png", "depth_000000.png", "keypoints_000002.png",
             "flow_000002.png", "depth_000002.png"}
    assert set(os.listdir(tdir)) == names == set(os.listdir(jdir))
    for name in sorted(names):
        got, want = (np.asarray(Image.open(d / name)) for d in (tdir, jdir))
        assert got.shape == want.shape == (tcfg.visual.img_height, tcfg.visual.img_width, 3)
        same = np.all(got == want, axis=-1).mean()
        assert same == 1.0 if name.startswith("keypoints") else same >= 0.999, (name, same)


# runs ``python -m vloam_tpu_torch.runtime`` with the 64-beam preset shrunk to
# the tiny sizes (the CLI has no size flags, as the reference's has none)
CLI = textwrap.dedent("""
    import runpy, sys
    from vloam_tpu_torch import config as C
    small = C.kitti_hdl64().replace(
        scan=C.ScanConfig(ring_cap=128, max_points=4096, less_flat_cap=4096),
        mapping=C.MappingConfig(grid_w=5, grid_h=5, grid_d=3, corner_cube_cap=128,
                                surf_cube_cap=256, corner_stack_cap=256, surf_stack_cap=512))
    C.kitti_hdl64 = lambda: small
    sys.argv = ["vloam_tpu_torch.runtime"] + sys.argv[1:]
    try:
        runpy.run_module("vloam_tpu_torch.runtime", run_name="__main__")
    finally:
        bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
        assert not bad, bad
""")


def run_cli(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-c", CLI, *args], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=300)


def test_cli_synthetic_json(tmp_path):
    res = run_cli("--device", "cpu", "--dataset", "synthetic", "--frames", "3", "--json",
                  "--out", str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1, res.stdout
    out = json.loads(lines[0])
    assert out["frames"] == 3 and np.isfinite(out["final_err_mo_m"])
    assert set(out) == {"frames", "path_len_m", "final_err_vo_m", "final_err_lo_m",
                        "final_err_mo_m", "steady_ms_per_frame", "fps"}
    for name in FILES:
        assert ttraj.load_kitti_trajectory(str(tmp_path / name)).shape == (3, 3, 4)


# put before the CLI script's ``try``: wraps the feature families' functions
# and records the ones the run reaches
FAMILY_SPY = textwrap.dedent("""
    from vloam_tpu_torch.ops import akaze as _ak, brisk as _br, image_ops as _io, orb as _orb
    from vloam_tpu_torch.ops import sift as _si
    _hits = set()
    def _spy(mod, name):
        real = getattr(mod, name)
        def wrapped(*a, **k):
            _hits.add(mod.__name__.rsplit(".", 1)[1] + "." + name)
            return real(*a, **k)
        setattr(mod, name, wrapped)
    for _m, _names in ((_br, ("brisk_detect", "brisk_descriptors", "freak_descriptors")),
                       (_ak, ("detect", "describe")),
                       (_si, ("detect", "orient", "describe", "match_float_descriptors",
                              "match_float_descriptors_approx")),
                       (_orb, ("orb_descriptors", "match_descriptors",
                               "match_descriptors_approx")),
                       (_io, ("shi_tomasi_response",))):
        for _n in _names:
            _spy(_m, _n)
""")


@pytest.mark.parametrize("flags,reached", [
    ("--detector orb --descriptor brisk",
     ["brisk.brisk_descriptors", "image_ops.shi_tomasi_response", "orb.match_descriptors"]),
    ("--detector brisk --descriptor freak --matcher flann",
     ["brisk.brisk_detect", "brisk.freak_descriptors", "orb.match_descriptors_approx"]),
    ("--detector akaze --descriptor akaze",
     ["akaze.describe", "akaze.detect", "orb.match_descriptors"]),
    ("--detector sift --descriptor sift --matcher flann",
     ["sift.describe", "sift.detect", "sift.match_float_descriptors_approx", "sift.orient"]),
])
def test_cli_feature_families(flags, reached):
    """``--descriptor-match`` with the scale-space detectors, the other
    descriptor families and ``--matcher flann`` through the CLI on the CPU:
    exit 0, two frames (the second matches the first's descriptors), and
    exactly the families' functions the flags name reached."""
    spy = CLI.replace("try:\n", FAMILY_SPY + "try:\n", 1).replace(
        "    bad = sorted(", "    print('reached:', sorted(_hits), file=sys.stderr)\n"
        "    bad = sorted(", 1)
    assert "_hits" in spy and "reached" in spy
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-c", spy, "--device", "cpu", "--dataset", "synthetic", "--frames", "2",
         "--json", "--descriptor-match", *flags.split()],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["frames"] == 2 and np.isfinite(out["final_err_vo_m"])
    assert f"reached: {reached}" in res.stderr, res.stderr[-2000:]


# put before the CLI script's ``try``: wraps the ported options' functions
# and records the ones the run reaches
SPY_PRELUDE = textwrap.dedent("""
    from vloam_tpu_torch.models import visual_odometry as _vo
    from vloam_tpu_torch.ops import image_ops as _io, lidar_factors as _lf
    _hits = set()
    def _spy(mod, name):
        real = getattr(mod, name)
        def wrapped(*a, **k):
            _hits.add(name)
            return real(*a, **k)
        setattr(mod, name, wrapped)
    for _m, _n in ((_vo, "clahe"), (_io, "fast_response"), (_io, "bucket_nms"),
                   (_lf, "pose_apply_interp")):
        _spy(_m, _n)
""")


def test_cli_frame_step_options(tmp_path):
    """``--distortion --clahe --detector fast --keypoint-nms`` and the debug
    dumps through the CLI on the CPU: exit 0, three frames, each option's
    ported function reached, the debug PNGs of frames 0 and 2 written."""
    dbg = tmp_path / "dbg"
    spy = CLI.replace("try:\n", SPY_PRELUDE + "try:\n", 1).replace(
        "    bad = sorted(", "    print('reached:', sorted(_hits), file=sys.stderr)\n"
        "    bad = sorted(", 1)
    assert "_hits" in spy and "reached" in spy
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-c", spy, "--device", "cpu", "--dataset", "synthetic", "--frames", "3",
         "--json", "--distortion", "--clahe", "--detector", "fast", "--keypoint-nms",
         "--debug-dir", str(dbg), "--debug-every", "2"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["frames"] == 3 and np.isfinite(out["final_err_mo_m"])
    assert ("reached: ['bucket_nms', 'clahe', 'fast_response', 'pose_apply_interp']"
            in res.stderr), res.stderr[-2000:]
    assert {"keypoints_000000.png", "keypoints_000002.png", "flow_000002.png"} <= set(
        os.listdir(dbg))


def test_cli_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a GPU")
    res = run_cli("--dataset", "synthetic", "--frames", "1", "--json")
    assert res.returncode != 0 and "torch.cuda.is_available() is false" in res.stderr
