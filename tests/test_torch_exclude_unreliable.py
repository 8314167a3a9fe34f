"""The port's unreliable-point exclusion (``ScanConfig.exclude_unreliable``)
against the JAX reference and against the contract of
``tests/test_exclude_unreliable.py``.

The contract cases (a known occlusion silhouette, a known grazing stretch,
the corridor's far artifacts) run on the port alone, with the reference
test's bounds.  ``unreliable_mask`` is held to the JAX function on a street
scan's ring grid with its masks compared exactly: its gates compare float
expressions against 0.1 and 0.0002 r^2, and a cell where the two packages
disagree must lie within float32 rounding (a relative 1e-5) of one of them.
``extract_features_from_grid(exclude_unreliable=True)`` is held to JAX with
and without the host less-flat table: masks equal, points to 1e-5,
less-flat centroids to 1e-4 (the tolerances of
``test_torch_scan_registration.py``).  The JAX side runs op by op
(``jax.disable_jit``), as there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_runtime import few_threads  # noqa: F401  (two threads a worker)
from vloam_tpu.config import ScanConfig
from vloam_tpu.data import synthetic
from vloam_tpu.data.gridding import grid_cloud, less_flat_voxel_table
from vloam_tpu.ops import scan_registration as jsr
from vloam_tpu_torch import config as tconfig
from vloam_tpu_torch.data import scenarios as tsc
from vloam_tpu_torch.data import synthetic as tsyn
from vloam_tpu_torch.ops import scan_registration as tsr

SC = dict(ring_cap=512, max_points=32768, less_flat_cap=8192, exclude_unreliable=True)
JCFG = ScanConfig(**SC)
TCFG = tconfig.ScanConfig(**SC)


def _unreliable(grid, gmask):
    return tsr.unreliable_mask(torch.tensor(grid), torch.tensor(gmask),
                               tconfig.kitti_hdl64().scan).numpy()


def test_occlusion_silhouette_marked():
    # one ring: a near wall (5 m) in front of a far wall (20 m); the far
    # side's 6 points flanking each jump are marked, the near wall is not
    C = 256
    az = np.linspace(-0.5, 0.5, C)
    r = np.where(np.abs(az) < 0.15, 5.0, 20.0)
    grid = np.zeros((1, C, 4), np.float32)
    grid[0, :, :3] = np.stack([r * np.cos(az), r * np.sin(az), np.zeros(C)], -1)
    un = _unreliable(grid, np.ones((1, C), bool))[0]
    for e in np.where(np.abs(np.diff(r)) > 1.0)[0]:
        far = e if r[e] > r[e + 1] else e + 1
        sgn = -1 if far == e else 1
        assert un[[far + sgn * l for l in range(6)]].all(), (e, un[max(0, e - 6):e + 7])
    mid = np.argmin(np.abs(az))
    assert not un[mid - 2:mid + 3].any()


def test_grazing_stretch_marked():
    # flat ground far away: consecutive samples metres apart -> parallel beam
    C = 48
    az = np.linspace(-0.1, 0.1, C)
    r = 60.0 + 120.0 * np.abs(az)
    pts = np.stack([r * np.cos(az), r * np.sin(az), np.full(C, -1.7)], -1)
    grid = np.zeros((1, C, 4), np.float32)
    grid[0, :, :3] = pts
    un = _unreliable(grid, np.ones((1, C), bool))[0]
    gaps = np.sum(np.diff(pts, axis=0) ** 2, axis=-1)
    both_big = (gaps[:-1] > 0.0002 * r[1:-1] ** 2) & (gaps[1:] > 0.0002 * r[1:-1] ** 2)
    assert un[1:-1][both_big].all()


def test_corridor_sharp_features_are_artifacts():
    """On the corridor the flag removes the far, sensor-relative sharp picks
    and keeps the wall-ground junctions; a street keeps most of its picks
    (the bounds of the reference test)."""
    cfg = tconfig.kitti_hdl64()

    def sharp(boxes, flag):
        pts = tsyn.simulate_scan(np.eye(3), np.zeros(3), boxes, n_azimuth=900, noise=0.005,
                                 seed=0)
        p, m = tsyn.pad_cloud(pts, cfg.scan.max_points)
        f = tsr.extract_features(torch.tensor(p), torch.tensor(m),
                                 dataclasses.replace(cfg.scan, exclude_unreliable=flag))
        return f.sharp[f.sharp_mask].numpy()

    walls = tsc.corridor_scene(120.0)
    s_off, s_on = sharp(walls, False), sharp(walls, True)
    far_off = np.mean(np.linalg.norm(s_off[:, :3], axis=1) > 25.0)
    far_on = np.mean(np.linalg.norm(s_on[:, :3], axis=1) > 25.0)
    assert far_off > 0.25, far_off
    assert far_on < 0.05, far_on
    assert len(s_on) > 100 and np.median(np.abs(s_on[:, 1])) > 6.5

    street = tsyn.default_scene()
    n_off, n_on = len(sharp(street, False)), len(sharp(street, True))
    assert n_on > 0.45 * n_off, (n_off, n_on)


@pytest.fixture(scope="module")
def street_grid():
    R, t = synthetic.straight_trajectory(3, speed=0.8, yaw_rate=0.005)[2]
    pts = synthetic.simulate_scan(R, t, synthetic.default_scene(), n_azimuth=500, noise=0.005,
                                  seed=2)
    return grid_cloud(pts, JCFG)


def _near_threshold(grid, gmask, cells, rtol=1e-5):
    """For each (ring, col) cell: does one of unreliable_mask's gates, in
    float64, sit within ``rtol`` of its threshold at the cell or at a ring
    neighbour whose marks reach it?"""
    xyz = grid[..., :3].astype(np.float64)
    r = np.linalg.norm(xyz, axis=-1)
    nxt, r_nxt = np.roll(xyz, -1, 1), np.roll(r, -1, 1)
    d_next = np.sum((nxt - xyz) ** 2, -1)
    sr, srn = np.maximum(r, 1e-6), np.maximum(r_nxt, 1e-6)
    gates = [
        (d_next, np.full_like(d_next, 0.1)),
        (np.linalg.norm(nxt * (r / srn)[..., None] - xyz, axis=-1) / sr, np.full_like(r, 0.1)),
        (np.linalg.norm(nxt - xyz * (r_nxt / sr)[..., None], axis=-1) / srn, np.full_like(r, 0.1)),
        (r, r_nxt),
        (d_next, 0.0002 * r * r),
        (np.roll(d_next, 1, 1), 0.0002 * r * r),
    ]
    near = np.zeros(gmask.shape, bool)
    for v, thr in gates:
        near |= np.abs(v - thr) <= rtol * np.maximum(np.abs(thr), 1e-12)
    reach = np.zeros_like(near)
    for l in range(-7, 8):          # a mark reaches 6 cells either way of its edge
        reach |= np.roll(near, l, 1)
    return [bool(reach[i, j]) for i, j in cells]


def test_unreliable_mask_matches_reference(street_grid):
    grid, gmask, _ = street_grid
    with jax.disable_jit():
        want = np.asarray(jsr.unreliable_mask(jnp.array(grid), jnp.array(gmask), JCFG))
    got = tsr.unreliable_mask(torch.tensor(grid), torch.tensor(gmask), TCFG).numpy()
    assert want.sum() > 100
    differ = np.argwhere(got != want)
    # equal here; a cell that ever differs must sit on a threshold
    assert all(_near_threshold(grid, gmask, differ)), differ
    assert len(differ) <= 2, f"{len(differ)} cells differ"


@pytest.mark.parametrize("with_table", [False, True], ids=["lf_table=None", "lf_table"])
@pytest.mark.parametrize("cloud,atol", [("sharp", 1e-5), ("less_sharp", 1e-5), ("flat", 1e-5),
                                        ("less_flat", 1e-4)])
def test_excluded_features_match_reference(street_grid, with_table, cloud, atol):
    grid, gmask, npr = street_grid
    jt = tt = None
    if with_table:
        sg, bs, nr = less_flat_voxel_table(grid, gmask, JCFG)
        jt = (jnp.array(sg), jnp.array(bs), jnp.int32(nr))
        tt = (torch.tensor(sg), torch.tensor(bs), nr)
    with jax.disable_jit():
        want = jsr.extract_features_from_grid(jnp.array(grid), jnp.array(gmask), jnp.array(npr),
                                              JCFG, lf_table=jt)
    got = tsr.extract_features_from_grid(torch.tensor(grid), torch.tensor(gmask),
                                         torch.tensor(npr), TCFG, lf_table=tt)
    mask = np.asarray(getattr(want, cloud + "_mask"))
    np.testing.assert_array_equal(getattr(got, cloud + "_mask").numpy(), mask)
    assert mask.sum() > 50
    np.testing.assert_allclose(getattr(got, cloud).numpy(), np.asarray(getattr(want, cloud)),
                               atol=atol, rtol=0)
    # the flag is live here: it drops picks against the unflagged extraction
    if cloud == "sharp":
        off = tsr.extract_features_from_grid(
            torch.tensor(grid), torch.tensor(gmask), torch.tensor(npr),
            dataclasses.replace(TCFG, exclude_unreliable=False), lf_table=tt)
        assert int(off.sharp_mask.sum()) > int(got.sharp_mask.sum())
