"""The comparison's own arithmetic and the plain reference's host tables,
on the CPU: the truth rows as the driver exports them, the drift against
them, and the reference's less-flat table and depth buckets equal to the
host library's bit for bit."""

import numpy as np
import pytest

from conftest import ROOT
from vbench import judge, spec, traffic


def test_truth_rows_of_a_straight_course_are_the_camera_s():
    n = 5
    R = np.repeat(np.eye(3)[None], n, 0)
    t = np.stack([np.arange(n, dtype=float), np.zeros(n), np.zeros(n)], 1) + [3.0, 2.0, 1.0]
    from vbench.main import cam_T_base
    rows = judge.truth_rows(R, t, cam_T_base())
    # forward along the lidar's x is forward along the camera's z
    assert np.allclose(rows[:, :, :3], np.eye(3)[None], atol=1e-6)
    assert np.allclose(rows[:, :, 3], np.stack([np.zeros(n), np.zeros(n), np.arange(n)], 1),
                       atol=1e-6)


def test_drift_reads_the_widest_error_over_the_distance():
    truth = np.zeros((101, 3, 4))
    truth[:, :, :3] = np.eye(3)
    truth[:, 2, 3] = np.arange(101)
    est = truth.copy()
    est[:, 0, 3] = 0.01 * np.arange(101)        # 1 % sideways
    est[60, 0, 3] = 3.0                         # 5 % at 60 m
    rows = {0: {"vo": est, "lo": truth, "mo": est[:40]}}
    d = judge.drift(rows, truth, 50.0)
    assert d["vo_drift_pct"] == pytest.approx(5.0)
    assert d["lo_drift_pct"] == 0.0 and d["mo_drift_pct"] == 0.0   # MO never reached 50 m
    stale = {0: {c: np.repeat(truth[:1], 101, 0) for c in judge.CHAINS}}
    assert judge.drift(stale, truth, 50.0)["mo_drift_pct"] == pytest.approx(100.0)


def test_gaps_start_at_frame_zero():
    a = np.zeros((4, 3, 4))
    b = a.copy()
    b[1, 0, 3] = 0.5
    numbers, problems = judge.gaps({c: a for c in judge.CHAINS},
                                   {c: b for c in judge.CHAINS}, 4)
    assert not problems and numbers["vo_gap_m"] == 0.5
    numbers, problems = judge.gaps({c: a[:2] for c in judge.CHAINS},
                                   {c: b for c in judge.CHAINS}, 4)
    assert len(problems) == 3


@pytest.mark.parametrize("seed", [2**31 + 77, 3])
def test_reference_tables_equal_the_host_library(seed):
    from plainref.data import gridding as ref_gridding
    from vloam_tpu_torch import config as port_config
    from vloam_tpu_torch.data import gridding
    from vloam_tpu_torch.models import frame_graph as fg
    from vloam_tpu_torch.runtime import native
    if not native.available():
        pytest.skip("the host library cannot be built here")
    tr = spec.load_cell(ROOT, "klt.street1").traffic
    tr = dict(tr, lidar=dict(tr["lidar"], n_azimuth=900))
    cfg = port_config.kitti_hdl64()
    ext = fg.kitti_default_extrinsics("cpu")
    proj = (ext.P_rect0 @ ext.R_rect0 @ ext.cam_T_velo).numpy()
    K = ext.P_rect0[:, :3].numpy().astype(np.float64)
    frames, _ = traffic.make_drive(tr, 376, 1248, K, seed, 0, "cpu", n_frames=4)
    for _, cloud in frames:
        g, m, _ = gridding.grid_cloud(cloud, cfg.scan)
        want = native.lf_voxel_table_native(g, m, cfg.scan)
        got = ref_gridding.less_flat_voxel_table(g, m, cfg.scan)
        assert got[2] == want[2] > 1000
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        want = native.depth_buckets_native(g.reshape(-1, 4), m.reshape(-1), proj, cfg.visual)
        got = ref_gridding.depth_buckets(g.reshape(-1, 4), m.reshape(-1), proj, cfg.visual)
        assert want[3].sum() > 1000
        for a, b in zip(got, want):
            assert a.dtype == np.float32 and np.array_equal(a, b)
