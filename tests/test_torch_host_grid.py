"""The port's threaded C++ ring gridder (``native.grid_cloud_threaded``, the
source ``vloam_tpu_torch/csrc/host_grid.cpp``) against the NumPy
``data/gridding.grid_cloud``, and ``VloamDriver.process`` on it.

The gridder's contract with NumPy is ``tests/test_torch_native.py``'s for the
library's other gridder: masks and ring counts equal, xyz bit-equal, w within
1e-5 (NumPy may take atan2 from a vector library, so w's last bits may
differ).  Its output is the same bit for bit on 1 to 8 threads.  The driver
fed raw clouds steps as it does fed NumPy's grids, counts every natively
gridded frame in the ``grid.native`` span, falls back to NumPy without the
library, and leaves no cell of an earlier frame behind.
"""

import dataclasses
import sys
import threading

import numpy as np
import pytest

from test_torch_runtime import MC, SC, few_threads, make_frames  # noqa: F401
from vloam_tpu_torch import config as tconfig
from vloam_tpu_torch.data import gridding, synthetic
from vloam_tpu_torch.models import frame_graph as tfg
from vloam_tpu_torch.runtime import native
from vloam_tpu_torch.runtime.driver import HOST_POSE_FIELDS, VloamDriver

SMALL = tconfig.ScanConfig(ring_cap=512, max_points=32768, less_flat_cap=8192)


@pytest.fixture(scope="module", autouse=True)
def library():
    assert native.available(), native.toolchain_missing()


def _lidar_scan(seed):
    return synthetic.simulate_scan(np.eye(3), np.zeros(3), synthetic.default_scene(),
                                   n_azimuth=600, noise=0.01, seed=seed).astype(np.float32)


def _beams(elev_deg, n_azimuth, seed, r_min=3.0, r_max=80.0):
    """A spinning lidar's scan, azimuth-major (the scan order): every beam of
    ``elev_deg`` at ``n_azimuth`` azimuths, ranges uniform in [r_min, r_max],
    1 cm noise."""
    rng = np.random.default_rng(seed)
    az = np.linspace(np.pi, -np.pi, n_azimuth, endpoint=False)
    azg, elg = np.meshgrid(az, np.radians(elev_deg), indexing="ij")
    r = rng.uniform(r_min, r_max, azg.shape)
    pts = np.stack([r * np.cos(elg) * np.cos(azg), r * np.cos(elg) * np.sin(azg),
                    r * np.sin(elg)], -1).reshape(-1, 3)
    return (pts + rng.normal(0.0, 0.01, pts.shape)).astype(np.float32)


def _hdl64_hard(seed=7):
    """115,200 points of the HDL-64E (64 beams × 1800 azimuths) with NaNs,
    infinities, points under ``minimum_range``, points above and below the
    64-beam band; at ``ring_cap`` 1024 the rings overflow."""
    pts = _beams(synthetic.hdl64_ring_angles(), 1800, seed)
    rng = np.random.default_rng(seed + 1)
    idx = rng.permutation(len(pts))
    pts[idx[:500], rng.integers(0, 3, 500)] = np.nan
    pts[idx[500:600], 0] = np.inf
    pts[idx[600:2600]] *= 0.04                                   # 0.12-3.2 m: under 5 m
    out = idx[2600:4600]
    up = rng.random(len(out)) < 0.5                              # above +2 and below -24.33 deg
    elev = np.radians(np.where(up, rng.uniform(2.5, 40.0, len(out)),
                               rng.uniform(-60.0, -25.0, len(out))))
    r = np.linalg.norm(pts[out], axis=1)
    az = np.arctan2(pts[out, 1], pts[out, 0])
    pts[out] = np.stack([r * np.cos(elev) * np.cos(az), r * np.cos(elev) * np.sin(az),
                         r * np.sin(elev)], -1)
    return pts


def _case(name):
    """(cloud, ScanConfig) of one case."""
    hdl64 = tconfig.kitti_hdl64().scan
    if name.startswith("lidar_scan"):
        return _lidar_scan(int(name[-1])), SMALL
    if name == "hdl64_hard":
        return _hdl64_hard(), dataclasses.replace(hdl64, ring_cap=1024)
    if name == "hdl64_xyzi":          # KITTI's (N, 4) rows
        pts = _beams(synthetic.hdl64_ring_angles(), 900, 3)
        return np.concatenate([pts, np.ones((len(pts), 1), np.float32)], 1), hdl64
    if name == "vlp16":               # 16 beams every 2 deg over +-15, and 6 beams outside
        elev = np.concatenate([np.arange(-15.0, 16.0, 2.0), [-25.0, -19.0, 17.0, 24.0, 35.0, 50.0]])
        return _beams(elev, 1800, 4), dataclasses.replace(hdl64, n_scans=16)
    if name == "hdl32":               # 32 beams every 4/3 deg from -30.67 to +10.67, and 4 outside
        elev = np.concatenate([-92.0 / 3.0 + np.arange(32) * 4.0 / 3.0, [-40.0, -33.0, 13.0, 20.0]])
        return _beams(elev, 1800, 5), dataclasses.replace(hdl64, n_scans=32)
    if name == "empty":
        return np.zeros((0, 3), np.float32), hdl64
    if name == "no_valid_point":      # NaNs and points under minimum_range only
        pts = _beams(synthetic.hdl64_ring_angles(), 100, 6, r_min=0.5, r_max=4.5)
        pts[::7] = np.nan
        return pts, hdl64
    raise KeyError(name)


CASES = ("lidar_scan0", "lidar_scan1", "lidar_scan2", "hdl64_hard", "hdl64_xyzi", "vlp16",
         "hdl32", "empty", "no_valid_point")


@pytest.mark.parametrize("name", CASES)
def test_matches_numpy(name):
    pts, cfg = _case(name)
    g_py, m_py, n_py = gridding.grid_cloud(pts, cfg)
    g_c, m_c, n_c = native.grid_cloud_threaded(pts, cfg)
    assert g_c.shape == g_py.shape and m_c.dtype == np.bool_ and n_c.dtype == np.int32
    np.testing.assert_array_equal(m_c, m_py)
    np.testing.assert_array_equal(n_c, n_py)
    np.testing.assert_array_equal(g_c[..., :3].view(np.uint32), g_py[..., :3].view(np.uint32))
    np.testing.assert_allclose(g_c[..., 3], g_py[..., 3], rtol=0, atol=1e-5)
    assert not g_c[~m_c].any()
    if name == "hdl64_hard":
        # rings 1-50 overflow; ring 0 loses the top beam's points above +2 deg; 51-63 stay empty
        assert (n_py[1:51] == cfg.ring_cap).all() and 0 < n_py[0] and not n_py[51:].any()
    elif name in ("empty", "no_valid_point"):
        assert not m_py.any()
    else:
        assert m_py.sum() > 10000 and len(np.unique(np.nonzero(n_py)[0])) > 10


def _grid_into_garbage(pts, cfg, threads):
    """The library's call on outputs filled with NaN bits, true and -1: what
    it leaves unwritten shows."""
    R, C = cfg.n_scans, cfg.ring_cap
    grid = np.full((R, C, 4), np.nan, np.float32)
    mask = np.ones((R, C), np.bool_)
    npr = np.full((R,), -1, np.int32)
    rc = native._load().vh_grid_cloud_threaded(
        native._ptr(pts, native._FP), pts.shape[0], pts.shape[1], R, C, cfg.minimum_range,
        cfg.scan_period, threads, native._ptr(grid, native._FP), native._ptr(mask, native._UP),
        native._ptr(npr, native._IP))
    assert rc == npr.sum()
    return grid, mask, npr


@pytest.mark.parametrize("threads", range(1, 9))
def test_same_output_on_any_thread_count(threads):
    """Bit for bit the same grid on 1-8 threads, every cell written."""
    pts, cfg = _case("hdl64_hard")
    g1, m1, n1 = native._grid_cloud_threads(pts, cfg, 1)
    for g, m, n in (native._grid_cloud_threads(pts, cfg, threads),
                    _grid_into_garbage(pts, cfg, threads)):
        np.testing.assert_array_equal(g.view(np.uint32), g1.view(np.uint32))
        np.testing.assert_array_equal(m, m1)
        np.testing.assert_array_equal(n, n1)


def test_concurrent_calls():
    """Sixteen Python threads gridding at once (the binding releases the
    interpreter lock) on up to 8 workers each: the library runs one call at a
    time, and every call returns the single-threaded grid."""
    pts, cfg = _case("lidar_scan1")
    want = native._grid_cloud_threads(pts, cfg, 1)
    bad, done = [], []

    def work(k):
        for _ in range(6):
            g, m, n = native._grid_cloud_threads(pts, cfg, 1 + (k % 8))
            if not (np.array_equal(g.view(np.uint32), want[0].view(np.uint32))
                    and np.array_equal(m, want[1]) and np.array_equal(n, want[2])):
                bad.append(k)
        done.append(k)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sorted(done) == list(range(16)) and not bad


def test_rejects_what_it_cannot_grid():
    pts, cfg = _case("lidar_scan0")
    with pytest.raises(ValueError, match="rc=-1"):
        native.grid_cloud_threaded(pts, dataclasses.replace(cfg, n_scans=40))
    with pytest.raises(ValueError, match="a cloud is"):
        native.grid_cloud_threaded(pts[:, :2], cfg)


def _driver():
    cfg = tconfig.kitti_hdl64().replace(scan=tconfig.ScanConfig(**SC),
                                        mapping=tconfig.MappingConfig(**MC), verbose_level=0)
    return cfg, VloamDriver(cfg, tfg.kitti_default_extrinsics("cpu"), device="cpu")


def test_process_steps_as_numpy_grids_do():
    """Twelve frames: ``process`` on the native path against ``process_grid``
    fed NumPy's grids; the two grids share masks and xyz, so the poses the
    host reads are equal."""
    cfg, native_drv = _driver()
    _, numpy_drv = _driver()
    frames, _ = make_frames(cfg, 12, n_azimuth=500)
    for i, (img, cloud) in enumerate(frames):
        native_drv.process(img, cloud)
        numpy_drv.process_grid(img, *gridding.grid_cloud(cloud, cfg.scan)[:2])
        for name in HOST_POSE_FIELDS:
            np.testing.assert_array_equal(getattr(native_drv.host_out, name),
                                          getattr(numpy_drv.host_out, name),
                                          err_msg=f"frame {i} {name}")
        np.testing.assert_array_equal(native_drv.host_out.lo_corr, numpy_drv.host_out.lo_corr)
    assert native_drv.timer.count["grid.native"] == native_drv.timer.count["host_grid"] == 12


def _fed_grids(drv):
    """Replace the driver's step by a recorder of the grids ``process`` feeds."""
    fed = []
    drv.process_grid = lambda image, grid, gmask: fed.append((grid, gmask))
    return fed


def test_process_falls_back_to_numpy(monkeypatch):
    cfg, drv = _driver()
    fed = _fed_grids(drv)
    monkeypatch.setattr(native, "available", lambda: False)
    cloud = _lidar_scan(3)
    drv.process(None, cloud.astype(np.float64))
    grid, gmask, _ = gridding.grid_cloud(cloud, cfg.scan)
    np.testing.assert_array_equal(fed[0][0].view(np.uint32), grid.view(np.uint32))
    np.testing.assert_array_equal(fed[0][1], gmask)
    assert drv.timer.count["host_grid"] == 1 and "grid.native" not in drv.timer.count


def test_fewer_points_leave_no_stale_cells():
    """A sparse frame after a dense one: every cell past a ring's count is
    zero and unmasked, and each frame's grid is an array of its own (a
    loop-closure keyframe holds it)."""
    cfg, drv = _driver()
    fed = _fed_grids(drv)
    dense = _beams(synthetic.hdl64_ring_angles(), 500, 8)
    sparse = dense[::5]
    want = gridding.grid_cloud(sparse, cfg.scan)
    for cloud in (dense, sparse, dense, sparse):
        drv.process(None, cloud)
    assert drv.timer.count["grid.native"] == 4
    ids = {id(a) for g, m in fed for a in (g, m)}
    assert len(ids) == 8 and not any(np.shares_memory(fed[i][0], fed[i + 1][0]) for i in range(3))
    for (g0, m0), (g1, m1) in (fed[0:2], fed[2:4]):
        n0, n1 = m0.sum(axis=1), m1.sum(axis=1)
        assert (n1 < n0).sum() > 40
        past = np.arange(cfg.scan.ring_cap)[None, :] >= n1[:, None]
        assert not m1[past].any() and not g1[past].any()
        np.testing.assert_array_equal(m1, want[1])
        np.testing.assert_array_equal(g1[..., :3], want[0][..., :3])
