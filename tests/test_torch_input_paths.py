"""The port's device-side input paths against the JAX reference: the raw
padded cloud gridded on the device (``assign_rings``, ``relative_times``,
``organize_scan``, ``extract_features``) and the depth buckets built on the
device (``project_cloud``, ``build_buckets``), then the raw-input frame step
(``vloam_step(pre_gridded=False, pre_buckets=None)``).

Tolerances: ring ids, validity, relative times, the ring grid and its mask
equal to JAX's (ring assignment truncates ``degrees(atan2(...))`` toward
zero, so a one-ulp difference would move a point to another ring: any
mismatch is reported with the points' angles); the device grid also equal
to the port's host ``grid_cloud`` within 1e-5 m (its relative times come
from a float64 unwrap); features as in ``test_torch_scan_registration.py``
(masks equal, points 1e-5, less-flat centroids 1e-4).  Projection: the
validity mask equal, z and, inside the image, (u, v) within a relative
1e-5.  Buckets: counts
exact (sums of ones), means within 1e-3 px or m (float sums in another
order; the host's own bound against the device is 2e-3,
``tests/test_gridding.py``).  The raw step against the pre-gridded step:
4 mm / 1e-3 rad per frame.  The JAX side runs op by op (``jax.disable_jit``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_runtime import few_threads  # noqa: F401  (two threads a worker)
from vloam_tpu.config import MappingConfig, ScanConfig, VisualConfig, kitti_hdl64
from vloam_tpu.data import synthetic
from vloam_tpu.models import frame_graph as jfg
from vloam_tpu.models.vloam import init_vloam_state as jinit
from vloam_tpu.models.vloam import vloam_step as jstep
from vloam_tpu.ops import depth_map as jdm
from vloam_tpu.ops import scan_registration as jsr
from vloam_tpu_torch import config as tconfig
from vloam_tpu_torch.data import gridding, stream
from vloam_tpu_torch.data import synthetic as tsyn
from vloam_tpu_torch.models import frame_graph as tfg
from vloam_tpu_torch.models.vloam import init_vloam_state, vloam_step
from vloam_tpu_torch.ops import depth_map as tdm
from vloam_tpu_torch.ops import scan_registration as tsr

SC = dict(ring_cap=512, max_points=32768, less_flat_cap=8192)
MC = dict(grid_w=7, grid_h=7, grid_d=3, corner_cube_cap=1024, surf_cube_cap=2048,
          corner_stack_cap=2048, surf_stack_cap=4096,
          submap_corner_cap=4096, submap_surf_cap=8192)
N_AZIMUTH = 500          # 64 x 500 rays fit max_points and a ring fits ring_cap
T_TOL, R_TOL = 4e-3, 1e-3
N_STEP = 3


@pytest.fixture(scope="module", params=[0, 3])
def scan(request):
    """A padded street scan (the sensor 8 m along a turning course)."""
    R, t = synthetic.straight_trajectory(11, speed=0.8, yaw_rate=0.005)[10]
    pts = synthetic.simulate_scan(R, t, synthetic.default_scene(), n_azimuth=N_AZIMUTH,
                                  noise=0.005, seed=request.param)
    p, m = synthetic.pad_cloud(pts, SC["max_points"])
    return pts, p, m


def _ring_report(p, jr, tr, valid):
    bad = np.flatnonzero((jr != tr) & valid)
    x, y, z = (p[bad, k].astype(np.float64) for k in range(3))
    ang = np.degrees(np.arctan2(z, np.hypot(x, y)))
    return f"{len(bad)} points on other rings; angles {ang[:8]} deg, JAX {jr[bad][:8]}, port {tr[bad][:8]}"


def test_organize_scan_matches_reference(scan):
    pts, p, m = scan
    J, T = ScanConfig(**SC), tconfig.ScanConfig(**SC)
    with jax.disable_jit():
        jr, jv = jsr.assign_rings(jnp.array(p), jnp.array(m), J)
        jrel = jsr.relative_times(jnp.array(p), jv)
        jg, jm, jn = (np.asarray(a) for a in jsr.organize_scan(jnp.array(p), jnp.array(m), J))
    tr, tv = tsr.assign_rings(torch.tensor(p), torch.tensor(m), T)
    trel = tsr.relative_times(torch.tensor(p), tv)
    tg, tm, tn = (a.numpy() for a in tsr.organize_scan(torch.tensor(p), torch.tensor(m), T))
    jr, jv = np.asarray(jr), np.asarray(jv)
    assert np.array_equal(jr[m], tr.numpy()[m]), _ring_report(p, jr, tr.numpy(), m)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(trel.numpy()[jv], np.asarray(jrel)[jv])
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tg, jg)
    # the 13 lowest synthetic rings lie past ring 50, which the HDL-64 formula drops
    assert tm.sum() > 0.7 * m.sum()

    hg, hm, hn = gridding.grid_cloud(pts, T)
    np.testing.assert_array_equal(tm, hm)
    np.testing.assert_array_equal(tn, hn)
    np.testing.assert_allclose(tg, hg, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def features(scan):
    _, p, m = scan
    with jax.disable_jit():
        want = jsr.extract_features(jnp.array(p), jnp.array(m), ScanConfig(**SC))
    return tsr.extract_features(torch.tensor(p), torch.tensor(m), tconfig.ScanConfig(**SC)), want


@pytest.mark.parametrize("cloud,atol", [("sharp", 1e-5), ("less_sharp", 1e-5), ("flat", 1e-5),
                                        ("less_flat", 1e-4)])
def test_extract_features_matches_reference(features, cloud, atol):
    got, want = features
    mask = np.asarray(getattr(want, cloud + "_mask"))
    np.testing.assert_array_equal(getattr(got, cloud + "_mask").numpy(), mask)
    assert mask.sum() > 50
    np.testing.assert_allclose(getattr(got, cloud).numpy(), np.asarray(getattr(want, cloud)),
                               atol=atol, rtol=0)


def test_project_and_buckets_match_reference(scan):
    _, p, m = scan
    vc, tvc = VisualConfig(), tconfig.VisualConfig()
    ext = jfg.kitti_default_extrinsics()
    proj = np.asarray(ext.P_rect0 @ ext.R_rect0 @ ext.cam_T_velo)
    with jax.disable_jit():
        uvz, ok = jdm.project_cloud(jnp.array(p), jnp.array(m), jnp.array(proj), vc)
        want = jdm.build_buckets(uvz, ok, vc)
    tuvz, tok = tdm.project_cloud(torch.tensor(p), torch.tensor(m), torch.tensor(proj), tvc)
    got = tdm.build_buckets(tuvz, tok, tvc)
    ok = np.asarray(ok)
    np.testing.assert_array_equal(tok.numpy(), ok)
    uvz, tuvz = np.asarray(uvz), tuvz.numpy()
    np.testing.assert_allclose(tuvz[ok, 2], uvz[ok, 2], rtol=1e-5, atol=1e-5)
    # u and v divide by z, so a point just in front of the camera far outside
    # the image carries the matmul's rounding times 1/z: held in the image
    img = ok & (uvz[:, 0] >= 0) & (uvz[:, 0] < vc.img_width) & (uvz[:, 1] >= 0) \
        & (uvz[:, 1] < vc.img_height)
    np.testing.assert_allclose(tuvz[img, :2], uvz[img, :2], rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    assert want.count.sum() > 1000
    for k in ("u", "v", "z"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   atol=1e-3, rtol=0, err_msg=k)


def _configs():
    j = kitti_hdl64().replace(scan=ScanConfig(**SC), mapping=MappingConfig(**MC))
    t = tconfig.kitti_hdl64().replace(scan=tconfig.ScanConfig(**SC),
                                      mapping=tconfig.MappingConfig(**MC))
    return j, t


@pytest.fixture(scope="module")
def raw_frames():
    _, tcfg = _configs()
    raw, poses = stream.gen_raw(tcfg, tfg.kitti_default_extrinsics("cpu"), N_STEP,
                                n_azimuth=N_AZIMUTH)
    return [(img, *tsyn.pad_cloud(cloud, SC["max_points"])) for img, cloud in raw]


def run_raw(tcfg, raw_frames):
    ext = tfg.kitti_default_extrinsics("cpu")
    state, outs = init_vloam_state(tcfg, "cpu"), []
    for img, p, m in raw_frames:
        state, out = vloam_step(state, torch.tensor(img), torch.tensor(p), torch.tensor(m), ext,
                                tcfg, pre_gridded=False, pre_buckets=None)
        outs.append({k: v.numpy() for k, v in out._asdict().items()})
    return outs


def assert_pose_close(got, want, what):
    dt = np.abs(got[4:] - want[4:]).max()
    ang = 2.0 * np.arccos(min(1.0, abs(float(np.dot(got[:4], want[:4])))))
    assert dt < T_TOL and ang < R_TOL, (what, dt, ang, got, want)


def test_raw_step_matches_pre_gridded_step(raw_frames):
    """The raw step against the pre-gridded step on the same frames, its
    inputs built by the host from the same raw clouds: the ring grid by
    ``grid_cloud``, the depth buckets by ``depth_buckets`` over the whole
    raw cloud (VO's buckets take every point of the cloud, the rings the
    grid drops included, as the reference's raw path does), and no less-flat
    table (the raw path reduces the less-flat cloud on the device, which
    differs from the table wherever an edge sits mid-run)."""
    _, tcfg = _configs()
    ext = tfg.kitti_default_extrinsics("cpu")
    proj = stream.camera_matrices(ext)[1]
    raw = run_raw(tcfg, raw_frames)
    state = init_vloam_state(tcfg, "cpu")
    for i, (img, p, m) in enumerate(raw_frames):
        grid, gmask, _ = gridding.grid_cloud(p[m], tcfg.scan)
        bk = gridding.depth_buckets(p, m, proj, tcfg.visual)
        state, out = vloam_step(state, torch.tensor(img), torch.tensor(grid), torch.tensor(gmask),
                                ext, tcfg, pre_gridded=True,
                                pre_buckets=tdm.DepthBuckets(*(torch.tensor(b) for b in bk)))
        for key in ("world_vo", "world_lo", "world_mo", "mo_pose"):
            assert_pose_close(raw[i][key], getattr(out, key).numpy(), f"frame {i} {key}")
    assert np.linalg.norm(raw[-1]["world_mo"][4:]) > 1.0     # the car moved


@pytest.mark.slow
def test_raw_step_matches_reference(raw_frames):
    """The port's raw step against the JAX raw step, op by op, per frame."""
    jcfg, tcfg = _configs()
    jext = jfg.kitti_default_extrinsics()
    state = jinit(jcfg)
    port = run_raw(tcfg, raw_frames)
    with jax.disable_jit():
        for i, (img, p, m) in enumerate(raw_frames):
            state, out = jstep(state, jnp.array(img), jnp.array(p), jnp.array(m), jext, jcfg,
                               pre_gridded=False)
            for key in ("world_vo", "world_lo", "world_mo", "vo_pose", "lo_pose", "mo_pose"):
                assert_pose_close(port[i][key], np.asarray(getattr(out, key)), f"frame {i} {key}")
