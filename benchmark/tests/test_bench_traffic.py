"""The traffic generator: deterministic per (seed, drive), different across
drive indices and seeds, and the same rays and hits as the port's NumPy world."""

import numpy as np
import pytest
import torch

from conftest import ROOT  # noqa: F401  (puts the benchmark on sys.path)
from vbench import spec, traffic

K = np.array([[718.856, 0.0, 624.0], [0.0, 718.856, 188.0], [0.0, 0.0, 1.0]])


def small_traffic():
    tr = spec.load_cell(ROOT, "klt.street1").traffic
    tr = dict(tr, lidar=dict(tr["lidar"], n_azimuth=300))
    return tr


def drive(seed, d, n=9):
    return traffic.make_drive(small_traffic(), 376, 1248, K, seed, d, "cpu", n_frames=n)


def test_same_seed_same_frames():
    a, (ra, ta) = drive(2**31 + 7, 1)
    b, (rb, tb) = drive(2**31 + 7, 1)
    assert np.array_equal(ra, rb) and np.array_equal(ta, tb)
    for (ia, ca), (ib, cb) in zip(a, b):
        assert np.array_equal(ia, ib) and np.array_equal(ca, cb)
        assert ia.dtype == np.float32 and ca.dtype == np.float32 and ca.shape[1] == 3


@pytest.mark.parametrize("other", [(2**31 + 7, 2), (2**31 + 8, 1)])
def test_drive_and_seed_change_the_frames(other):
    a, _ = drive(2**31 + 7, 1, n=2)
    b, _ = drive(*other, n=2)
    assert not np.array_equal(a[0][1][:100], b[0][1][:100])


def test_frames_have_texture_and_structure():
    frames, (R, t) = drive(5, 0)
    assert np.allclose(np.linalg.norm(np.diff(t, axis=0), axis=1), 1.0)
    for img, cloud in frames:
        assert 0.0 <= img.min() and img.max() <= 255.0 and (img > 50).sum() > 500
        r = np.linalg.norm(cloud, axis=1)
        assert r.max() < 80.1 and len(cloud) > 0.5 * 64 * 300
        # the ground plane: the lowest returns lie 1.73 m below the sensor
        assert abs(np.percentile(cloud[:, 2], 1) + 1.73) < 0.05


def test_ray_hits_match_numpy_world():
    from vloam_tpu_torch.data import synthetic
    boxes = synthetic.default_scene()
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(2000, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    origin = np.array([30.0, 0.5, 0.0])
    got = traffic.ray_hits(torch.tensor(origin), torch.tensor(dirs), torch.tensor(boxes),
                           -1.73, 80.0).numpy()
    t_box = synthetic._ray_aabb(np.broadcast_to(origin, dirs.shape), dirs, boxes)
    dz = dirs[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t_gnd = np.where(dz < -1e-6, (-1.73 - origin[2]) / dz, np.inf)
    want = np.minimum(t_box, t_gnd)
    want = np.where(want < 80.0, want, np.inf)
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert np.allclose(got[fin], want[fin], rtol=0, atol=1e-9)


def test_ring_angles_are_the_port_s():
    from vloam_tpu_torch.data import synthetic
    assert np.array_equal(traffic.hdl64_ring_angles(), synthetic.hdl64_ring_angles())
