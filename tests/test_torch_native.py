"""The port's binding of the C++ host library (``runtime/native.py``) against
the port's NumPy host path, with the cases of ``tests/test_native.py``.

Tolerances are that file's: loaders exact; ring grids' masks and counts
exact, points within 1e-5; depth-bucket counts exact, means within 2e-3;
less-flat tables' slots and run counts exact, sums within rtol 1e-5 / atol
1e-4.  The library is built into ``vloam_tpu_torch/_build/`` and nothing is
written under ``native/``; on a machine without ``png.h`` it is built from
the port's libpng declarations against Pillow's libpng16, and that build is
checked here too.  ``run_kitti`` through the prefetcher is held to the NumPy
loader loop on the 4-frame raw drive of ``tests/test_kitti_loader.py``
(exported rows within 5e-3: native and NumPy buckets differ by up to 2e-3 px).
"""

import os

import numpy as np
import pytest
from PIL import Image

from test_torch_runtime import few_threads  # noqa: F401  (two threads a worker)
from test_kitti_loader import write_bin, write_png, write_raw_calib
from vloam_tpu_torch import config as tconfig
from vloam_tpu_torch.data import gridding, kitti, synthetic
from vloam_tpu_torch.models import frame_graph as tfg
from vloam_tpu_torch.runtime import native
from vloam_tpu_torch.runtime.driver import run_kitti


@pytest.fixture(scope="module", autouse=True)
def library():
    assert native.available(), native.toolchain_missing()


@pytest.fixture
def bin_files(tmp_path, rng):
    paths, arrays = [], []
    for i in range(5):
        pts = rng.normal(size=(100 + 17 * i, 4)).astype(np.float32)
        p = tmp_path / f"{i:06d}.bin"
        pts.tofile(p)
        paths.append(str(p))
        arrays.append(pts[:, :3])
    return paths, arrays


def test_load_bin_matches_numpy(bin_files):
    paths, arrays = bin_files
    out, n = native.load_bin(paths[0], 4096)
    assert n == len(arrays[0])
    np.testing.assert_array_equal(out[:n], kitti.load_bin(paths[0]))
    assert (out[n:] == 0).all()


def test_load_bin_truncates(bin_files):
    paths, arrays = bin_files
    out, n = native.load_bin(paths[1], 50)
    assert n == 50
    np.testing.assert_array_equal(out, arrays[1][:50])


def test_load_png_gray(tmp_path, rng):
    img = rng.integers(0, 255, size=(60, 80), dtype=np.uint8)
    p = tmp_path / "img.png"
    Image.fromarray(img, "L").save(p)
    out = native.load_png_gray(str(p), 64, 96)  # padded target
    np.testing.assert_array_equal(out[:60, :80], kitti.load_image(str(p)))
    assert (out[60:, :] == 0).all() and (out[:, 80:] == 0).all()


def _write_images(tmp_path, rng, n=5, shape=(40, 50)):
    paths, imgs = [], []
    for i in range(n):
        img = rng.integers(0, 255, size=shape, dtype=np.uint8)
        p = tmp_path / f"img{i}.png"
        Image.fromarray(img, "L").save(p)
        paths.append(str(p))
        imgs.append(img)
    return paths, imgs


def test_prefetcher_ordered_stream(bin_files, tmp_path, rng):
    paths, arrays = bin_files
    img_paths, imgs = _write_images(tmp_path, rng)
    with native.NativePrefetcher(paths, img_paths, max_points=512, height=40, width=50,
                                 depth=2) as pf:
        assert len(pf) == 5
        seen = 0
        for i, (cloud, n, img) in enumerate(pf):
            assert n == len(arrays[i])
            np.testing.assert_array_equal(cloud[:n], arrays[i])
            np.testing.assert_array_equal(img, imgs[i].astype(np.float32))
            seen += 1
    assert seen == 5 and pf._h is None


def test_prefetcher_lidar_only(bin_files):
    paths, arrays = bin_files
    with native.NativePrefetcher(paths, None, max_points=512) as pf:
        got = list(pf)
    assert len(got) == 5
    for (cloud, n, img), want in zip(got, arrays):
        assert img is None
        np.testing.assert_array_equal(cloud[:n], want)


def test_prefetcher_closed_before_drained(bin_files):
    """Closing a prefetcher whose worker threads are still ahead joins them."""
    paths, _ = bin_files
    pf = native.NativePrefetcher(paths * 20, None, max_points=512, depth=2)
    next(iter(pf))
    pf.close()
    assert pf._h is None
    pf.close()          # idempotent; __del__ calls it again


def _lidar_scan(seed=0):
    return synthetic.simulate_scan(np.eye(3), np.zeros(3), synthetic.default_scene(),
                                   n_azimuth=600, noise=0.01, seed=seed).astype(np.float32)


def test_grid_cloud_matches_numpy():
    cfg = tconfig.ScanConfig(ring_cap=512, max_points=32768, less_flat_cap=8192)
    pts = _lidar_scan()
    g_py, m_py, n_py = gridding.grid_cloud(pts, cfg)
    g_c, m_c, n_c = native.grid_cloud_native(pts, cfg)
    np.testing.assert_array_equal(m_py, m_c)
    np.testing.assert_array_equal(n_py, n_c)
    np.testing.assert_allclose(g_py, g_c, atol=1e-5)


def test_prefetcher_grid_mode(tmp_path):
    cfg = tconfig.ScanConfig(ring_cap=512, max_points=65536, less_flat_cap=8192)
    paths, grids = [], []
    for i in range(4):
        pts = _lidar_scan(seed=i)
        p = tmp_path / f"{i:06d}.bin"
        np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1).tofile(p)
        paths.append(str(p))
        grids.append(gridding.grid_cloud(pts, cfg))
    with native.NativePrefetcher(paths, None, max_points=cfg.max_points, scan_cfg=cfg) as pf:
        for (grid, gmask, npr, img), (g_py, m_py, n_py) in zip(pf.iter_grids(), grids):
            assert img is None
            np.testing.assert_array_equal(gmask, m_py)
            np.testing.assert_array_equal(npr, n_py)
            np.testing.assert_allclose(grid, g_py, atol=1e-5)


def test_depth_buckets_match_numpy():
    vc = tconfig.VisualConfig()
    ext = tfg.kitti_default_extrinsics("cpu")
    proj = (ext.P_rect0 @ ext.R_rect0 @ ext.cam_T_velo).numpy()
    rng = np.random.default_rng(4)
    pts = rng.normal(0, 25, (20000, 3)).astype(np.float32)
    mask = rng.random(20000) < 0.8
    nu, nv, nz, nc = native.depth_buckets_native(pts, mask, proj, vc)
    pu, pv, pz, pc = gridding.depth_buckets(pts, mask, proj, vc)
    np.testing.assert_array_equal(nc, pc)
    assert nc.sum() > 500
    for a, b in ((nu, pu), (nv, pv), (nz, pz)):
        np.testing.assert_allclose(a, b, atol=2e-3)


def test_lf_voxel_table_matches_numpy():
    cfg = tconfig.ScanConfig(ring_cap=512, max_points=32768, less_flat_cap=8192)
    pts = synthetic.simulate_scan(np.eye(3), np.zeros(3), synthetic.default_scene(),
                                  n_azimuth=600, seed=2)
    g, m, _ = gridding.grid_cloud(pts, cfg)
    ns, nb, nn = native.lf_voxel_table_native(g, m, cfg)
    ps, pb, pn = gridding.less_flat_voxel_table(g, m, cfg)
    assert nn == pn > 1000
    np.testing.assert_array_equal(ns, ps)
    np.testing.assert_allclose(nb, pb, rtol=1e-5, atol=1e-4)


def _tree_state(path):
    return sorted((f, os.stat(os.path.join(path, f)).st_mtime_ns) for f in os.listdir(path))


@pytest.mark.parametrize("system_png", [True, False], ids=["png.h", "declarations"])
def test_build_lands_in_build_dir(tmp_path, monkeypatch, system_png):
    """A fresh build goes to the build directory through a temporary name,
    leaves nothing else there and writes nothing under native/.  Without
    the system's png.h it compiles the port's libpng declarations against
    Pillow's libpng16, and that library decodes a PNG."""
    if not system_png and native._pillow_libpng() is None:
        pytest.skip("no libpng16 runtime beside Pillow on this machine")
    native_dir = os.path.dirname(native.SOURCE)
    before = _tree_state(native_dir)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    if not system_png:
        monkeypatch.setattr(native, "_system_png_h", lambda gxx: False)
    route = native.png_route()
    assert ("-lpng" in route[0]) == system_png
    out = native.build()
    assert out.parent == tmp_path / "_build" and os.listdir(out.parent) == [out.name]
    assert native.library_path() == out and native.build() == out
    assert _tree_state(native_dir) == before
    assert native.available() and native._lib._name == str(out)
    img = np.random.default_rng(1).integers(0, 255, size=(30, 40), dtype=np.uint8)
    Image.fromarray(img, "L").save(tmp_path / "a.png")
    np.testing.assert_array_equal(native.load_png_gray(str(tmp_path / "a.png"), 30, 40), img)


def test_unavailable_without_gxx(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert native.toolchain_missing() == "g++ not found"
    assert not native.available()
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()
    with pytest.raises(RuntimeError, match="not available"):
        native.NativePrefetcher([], None, max_points=16)


def test_run_kitti_native_vs_numpy(tmp_path, monkeypatch):
    """``run_kitti`` over a 4-frame raw drive (the fixture of
    tests/test_kitti_loader.py): through the prefetcher and the library's
    host stages, and through the NumPy loaders and host stages."""
    H, W = 128, 256
    K = np.array([[150.0, 0.0, 128.0], [0.0, 150.0, 64.0], [0.0, 0.0, 1.0]])
    cfg = tconfig.kitti_hdl64().replace(
        scan=tconfig.ScanConfig(ring_cap=512, max_points=32768, less_flat_cap=8192),
        mapping=tconfig.MappingConfig(grid_w=7, grid_h=7, grid_d=3, corner_cube_cap=1024,
                                      surf_cube_cap=2048, corner_stack_cap=2048,
                                      surf_stack_cap=4096, submap_corner_cap=4096,
                                      submap_surf_cap=8192),
        visual=tconfig.VisualConfig(img_height=H, img_width=W), verbose_level=0)
    p_rect = np.zeros((3, 4))
    p_rect[:, :3] = K
    scene = synthetic.default_scene()
    poses = synthetic.straight_trajectory(4, speed=0.8, yaw_rate=0.01)
    rng = np.random.default_rng(4)
    uv0 = np.stack([rng.uniform(20, W - 20, 500), rng.uniform(15, H - 15, 500)], -1)
    R_wc0 = poses[0][0] @ synthetic.CAM_R_WORLD.T
    pc0, hit = synthetic.raycast_camera(R_wc0, poses[0][1], scene, K, uv0)
    blob_world = (pc0[hit] @ R_wc0.T) + poses[0][1]

    root = str(tmp_path / "kitti")
    date, seqno = "2026_03_15", "0011"
    date_dir = os.path.join(root, date)
    write_raw_calib(date_dir, cam_R_velo=synthetic.CAM_R_WORLD, cam_t_velo=np.zeros(3),
                    r_rect=np.eye(3), p_rect=p_rect)
    drive = os.path.join(date_dir, f"{date}_drive_{seqno}_sync")
    velo = os.path.join(drive, "velodyne_points", "data")
    imgd = os.path.join(drive, "image_00", "data")
    os.makedirs(velo), os.makedirs(imgd)
    for i, (R, t) in enumerate(poses):
        write_bin(os.path.join(velo, f"{i:010d}.bin"),
                  synthetic.simulate_scan(R, t, scene, n_azimuth=500, noise=0.005, seed=i))
        R_wc = R @ synthetic.CAM_R_WORLD.T
        write_png(os.path.join(imgd, f"{i:010d}.png"),
                  synthetic.render_blob_image((blob_world - t) @ R_wc, K, H - 8, W - 6))

    opened = []
    prefetcher = native.NativePrefetcher

    def tracked(*a, **kw):
        opened.append(prefetcher(*a, **kw))
        return opened[-1]

    def run(out, force_numpy):
        with monkeypatch.context() as mp:
            mp.setattr(native, "NativePrefetcher", tracked)
            if force_numpy:
                mp.setattr(native, "available", lambda: False)
            run_kitti(cfg, kitti.RawSequence(root, date, seqno), out_dir=out, verbose=False,
                      device="cpu")
        return {k: np.loadtxt(os.path.join(out, f"{k}1.txt")) for k in ("VO", "LO", "MO")}

    traj_native = run(str(tmp_path / "out_native"), force_numpy=False)
    assert len(opened) == 1 and opened[0]._h is None     # used, and closed
    traj_numpy = run(str(tmp_path / "out_numpy"), force_numpy=True)
    assert len(opened) == 1
    for k in ("VO", "LO", "MO"):
        assert traj_numpy[k].shape == (4, 12), k
        np.testing.assert_allclose(traj_native[k], traj_numpy[k], atol=5e-3, err_msg=k)
    assert traj_numpy["MO"][-1, 11] > 1.5      # ~0.8 m a frame along cam z (velo x)
