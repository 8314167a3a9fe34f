"""The port's lidar undistortion path (``OdometryConfig.distortion``) against
the JAX package: the slerp, the interpolated factors, the generic GN's
Jacobian at the identity, ``solve_f2f`` and two ``lo_step``s, the distorted
sweep simulator, and the end-to-end contract of ``tests/test_distortion.py``.

* ``quat_slerp_identity`` on the short and long arc (w < 0), at s = 0 and 1,
  and at a 1e-7 rad rotation (the lerp branch): within 1e-6.
* ``pose_apply_interp``, ``transform_to_end``, ``edge_residual_interp``,
  ``plane_residual_interp`` and ``distance_residual`` on points within 2 m:
  within 1e-5.
* The Jacobian of an interpolated residual through ``pose_plus`` at the
  identity (LO's first solve starts there, where arccos' derivative is
  infinite) and at a 0.1 rad pose: finite, and within 1e-4 of JAX's
  ``jax.jacfwd``; one generic GN solve from the identity within 1e-5.
* The sweep fraction s the three input paths give (the NumPy host grid, the
  native library's grid, the device's ``organize_scan``) agree within two
  float32 spacings of the w value and of the relative time it carries,
  over the scan period.
* ``solve_f2f`` and three ``lo_step``s with distortion on the same features
  (a rigid sweep, then two distorted ones) and seed: poses within the slice
  tests' 4 mm / 1e-3 rad; the stored (sweep-end) clouds within 4 mm plus
  1e-3 of each point's range.  The JAX side runs op by op.
* ``simulate_scan_distorted`` equals JAX's array for the same seed.
* The port alone on ``tests/test_distortion.py``'s drive (a rigid bootstrap
  sweep, then one distorted sweep): the interpolated solve recovers the
  true motion within 8 cm and at least halves the rigid-sweep solve's
  error.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_runtime import few_threads  # noqa: F401  (two threads a worker)
from vloam_tpu import geometry as jgeo
from vloam_tpu.config import ScanConfig, kitti_hdl64
from vloam_tpu.data import synthetic as jsyn
from vloam_tpu.models import lidar_odometry as jlo
from vloam_tpu.ops import gauss_newton as jgn
from vloam_tpu.ops import lidar_factors as jfac
from vloam_tpu.ops.scan_registration import ScanFeatures as JFeatures
from vloam_tpu_torch import config as tconfig
from vloam_tpu_torch import geometry as tgeo
from vloam_tpu_torch.data import gridding
from vloam_tpu_torch.data import synthetic as tsyn
from vloam_tpu_torch.models import lidar_odometry as tlo
from vloam_tpu_torch.ops import gauss_newton as tgn
from vloam_tpu_torch.ops import lidar_factors as tfac
from vloam_tpu_torch.ops import scan_registration as tsr
from vloam_tpu_torch.runtime import native

SC = dict(ring_cap=512, max_points=32768, less_flat_cap=8192)
N_AZIMUTH = 500
T_TOL, R_TOL = 4e-3, 1e-3


def _pose(aa, t):
    q = np.asarray(jgeo.angle_axis_to_quat(jnp.array(aa, jnp.float32)))
    return np.concatenate([q, np.asarray(t, np.float32)]).astype(np.float32)


def _pose_close(got, want, what):
    dt = np.abs(got[4:] - want[4:]).max()
    ang = 2.0 * np.arccos(min(1.0, abs(float(np.dot(got[:4], want[:4])))))
    assert np.isfinite(got).all() and dt < T_TOL and ang < R_TOL, (what, dt, ang, got, want)


# ---- slerp and the interpolated factors ---------------------------------------

SLERP_CASES = {
    "short_arc": [0.3, -0.2, 0.1],
    "long_arc_w_negative": [0.3, -0.2, 0.1],
    "tiny_1e-7_rad": [1e-7, 0.0, 0.0],
    "identity": [0.0, 0.0, 0.0],
}


@pytest.mark.parametrize("case", SLERP_CASES)
def test_quat_slerp_identity_matches_reference(case, rng):
    q = np.asarray(jgeo.angle_axis_to_quat(jnp.array(SLERP_CASES[case], jnp.float32)))
    if case == "long_arc_w_negative":
        q = -q
        assert q[3] < 0
    s = np.concatenate([[0.0, 1.0], rng.uniform(0, 1, 30)]).astype(np.float32)
    want = np.asarray(jgeo.quat_slerp_identity(jnp.array(q), jnp.array(s)))
    got = tgeo.quat_slerp_identity(torch.tensor(q), torch.tensor(s)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[0], [0, 0, 0, 1], atol=1e-6)      # s = 0: the identity
    np.testing.assert_allclose(got[1], q * np.sign(q[3] or 1.0), atol=1e-6)   # s = 1: q


def _factor_inputs(rng, n=200):
    pose = _pose(rng.normal(0, 0.1, 3), rng.normal(0, 0.5, 3))
    p, a, b, c = (rng.uniform(-2, 2, (n, 3)).astype(np.float32) for _ in range(4))
    nrm = rng.normal(0, 1, (n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    d = rng.uniform(-1, 1, n).astype(np.float32)
    s = rng.uniform(0, 1, n).astype(np.float32)
    return pose, p, a, b, c, nrm, d, s


@pytest.mark.parametrize("fn", ["pose_apply_interp", "transform_to_end", "edge_residual_interp",
                                "plane_residual_interp", "distance_residual"])
def test_interp_factors_match_reference(fn, rng):
    pose, p, a, b, c, nrm, d, s = _factor_inputs(rng)
    args = {"pose_apply_interp": (pose, p, s), "transform_to_end": (pose, p, s),
            "edge_residual_interp": (pose, p, a, b, s),
            "plane_residual_interp": (pose, p, nrm, d, s),
            "distance_residual": (pose, p, c)}[fn]
    want = np.asarray(getattr(jfac, fn)(*(jnp.array(x) for x in args)))
    got = getattr(tfac, fn)(*(torch.tensor(x) for x in args)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("at", ["identity", "0.1_rad"])
def test_interp_jacobian_matches_jax_jacfwd(at, rng):
    pose = (np.array([0, 0, 0, 1, 0, 0, 0], np.float32) if at == "identity"
            else _pose([0.1, 0.0, 0.0], [0.3, 0.1, 0.0]))
    _, p, a, b, _, nrm, d, s = _factor_inputs(rng)
    s[:3] = (0.0, 1.0, 0.5)
    for fn, args in (("edge_residual_interp", (p, a, b, s)),
                     ("plane_residual_interp", (p, nrm, d, s))):
        jargs, targs = [jnp.array(x) for x in args], [torch.tensor(x) for x in args]
        want = np.asarray(jax.jacfwd(
            lambda dl: getattr(jfac, fn)(jgn.pose_plus(jnp.array(pose), dl), *jargs))(jnp.zeros(6)))
        got = torch.func.jacfwd(
            lambda dl: getattr(tfac, fn)(tgn.pose_plus(torch.tensor(pose), dl), *targs))(
            torch.zeros(6)).numpy()
        assert np.isfinite(got).all(), (fn, at)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)

    # the generic GN on these residuals: finite normal equations, JAX's pose
    v = rng.random(len(s)) < 0.9

    def groups(fac, geo_, ten):
        def fn(pp):
            return ((fac.edge_residual_interp(pp, *(ten(x) for x in (p, a, b, s))), ten(v)),
                    (fac.plane_residual_interp(pp, *(ten(x) for x in (p, nrm, d, s))), ten(v)))
        return fn

    want = np.asarray(jgn.solve_pose_gn(groups(jfac, jgeo, jnp.array), jnp.array(pose), 2, 0.1, 1e-3))
    got = tgn.solve_pose_gn(groups(tfac, tgeo, torch.tensor), torch.tensor(pose), 2, 0.1,
                            1e-3).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ---- the sweep fraction from the three input paths -----------------------------

def _distorted(n_azimuth=N_AZIMUTH, speed=1.2, yaw_rate=0.02, seed=2):
    poses = tsyn.straight_trajectory(3, speed=speed, yaw_rate=yaw_rate)
    (R1, t1), (R2, t2) = poses[1], poses[2]
    scene = tsyn.default_scene()
    pts_a = tsyn.simulate_scan(R1, t1, scene, n_azimuth=n_azimuth, noise=0.004, seed=1)
    pts_b = tsyn.simulate_scan_distorted(R1, t1, R2, t2, scene, n_azimuth=n_azimuth,
                                         noise=0.004, seed=seed)
    return pts_a, pts_b, R1.T @ (t2 - t1)


def test_sweep_fraction_agrees_across_input_paths():
    cfg = tconfig.kitti_hdl64().replace(scan=tconfig.ScanConfig(**SC))
    _, pts, _ = _distorted()
    p, m = tsyn.pad_cloud(pts, SC["max_points"])
    grids = {"numpy": gridding.grid_cloud(pts, cfg.scan)[:2]}
    if native.available():
        grids["native"] = native.grid_cloud_native(pts, cfg.scan)[:2]
        grids["threaded"] = native.grid_cloud_threaded(pts, cfg.scan)[:2]
    g, gm, _ = tsr.organize_scan(torch.tensor(p), torch.tensor(m), cfg.scan)
    grids["device"] = (g.numpy(), gm.numpy())
    ref_g, ref_m = grids["numpy"]
    s_ref = tlo.sweep_fraction(torch.tensor(ref_g.reshape(-1, 4)), cfg).numpy()
    # two float32 spacings of w, and of the relative time in [0, 1] it carries
    sp = cfg.scan.scan_period
    bound = 2.0 * (np.spacing(np.abs(ref_g[..., 3]).reshape(-1)) + sp * np.spacing(np.float32(1))) / sp
    assert ref_m.sum() > 20000 and np.ptp(s_ref[ref_m.reshape(-1)]) > 0.99
    for name, (gg, mm) in grids.items():
        np.testing.assert_array_equal(mm, ref_m, err_msg=name)
        np.testing.assert_allclose(gg[..., :3][mm], ref_g[..., :3][ref_m], atol=1e-5, err_msg=name)
        s = tlo.sweep_fraction(torch.tensor(gg.reshape(-1, 4)), cfg).numpy()
        live = ref_m.reshape(-1)
        assert np.all(np.abs(s - s_ref)[live] <= bound[live]), (name, np.abs(s - s_ref)[live].max())


def test_simulate_scan_distorted_equals_reference():
    poses = tsyn.straight_trajectory(3, speed=1.2, yaw_rate=0.02)
    (R1, t1), (R2, t2) = poses[1], poses[2]
    scene = tsyn.default_scene()
    got = tsyn.simulate_scan_distorted(R1, t1, R2, t2, scene, n_azimuth=240, noise=0.004, seed=5)
    want = jsyn.simulate_scan_distorted(R1, t1, R2, t2, scene, n_azimuth=240, noise=0.004, seed=5)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tsyn._so3_exp(np.array([0.1, -0.2, 0.3])),
                                  jsyn._so3_exp(np.array([0.1, -0.2, 0.3])))
    np.testing.assert_array_equal(tsyn._so3_log(R2), jsyn._so3_log(R2))


# ---- solve_f2f and lo_step against JAX ------------------------------------------

def _configs(sc=SC):
    j = kitti_hdl64().replace(scan=ScanConfig(**sc))
    t = tconfig.kitti_hdl64().replace(scan=tconfig.ScanConfig(**sc))
    return (j.replace(odom=dataclasses.replace(j.odom, distortion=True)),
            t.replace(odom=dataclasses.replace(t.odom, distortion=True)))


def _features(pts, cfg):
    p, m = tsyn.pad_cloud(pts, cfg.scan.max_points)
    return tsr.extract_features(torch.tensor(p), torch.tensor(m), cfg.scan)


def _jfeats(f):
    return JFeatures(*(jnp.array(x.numpy()) for x in f))


@pytest.fixture(scope="module")
def lo_runs():
    jcfg, tcfg = _configs()
    pts_a, pts_b, t_true = _distorted()
    # a third sweep, distorted over the next motion: its targets are the
    # second sweep's clouds moved to the sweep end through the solved delta
    (R2, t2), (R3, t3) = tsyn.straight_trajectory(4, speed=1.2, yaw_rate=0.02)[2:]
    pts_c = tsyn.simulate_scan_distorted(R2, t2, R3, t3, tsyn.default_scene(),
                                         n_azimuth=N_AZIMUTH, noise=0.004, seed=3)
    feats = [_features(pts, tcfg) for pts in (pts_a, pts_b, pts_c)]
    tstate, port = tlo.init_lo_state(tcfg, "cpu"), []
    for f in feats:
        tstate, delta, _, _ = tlo.lo_step(tstate, f, tcfg)
        port.append((delta.numpy(), tstate.last_corner.numpy(), tstate.last_surf.numpy()))
    jstate, ref = jlo.init_lo_state(jcfg), []
    with jax.disable_jit():
        for f in feats:
            jstate, delta, _, _ = jlo.lo_step(jstate, _jfeats(f), jcfg)
            ref.append((np.asarray(delta), np.asarray(jstate.last_corner),
                        np.asarray(jstate.last_surf)))
    # one solve from a seed off the truth, on frame A's raw clouds
    seed = _pose([0.0, 0.0, 0.01], t_true + 0.1)
    fa, fb = feats[:2]
    got, gcnt = tlo.solve_f2f(fb, fa.less_sharp, fa.less_sharp_mask, fa.less_flat,
                              fa.less_flat_mask, torch.tensor(seed), tcfg)
    with jax.disable_jit():
        want, wcnt = jlo.solve_f2f(_jfeats(fb), *(jnp.array(x.numpy()) for x in (
            fa.less_sharp, fa.less_sharp_mask, fa.less_flat, fa.less_flat_mask)),
            jnp.array(seed), jcfg)
    return dict(port=port, ref=ref, solve=(got.numpy(), gcnt.numpy(), np.asarray(want),
                                           np.asarray(wcnt)), t_true=t_true)


def test_solve_f2f_with_distortion_matches_reference(lo_runs):
    got, gcnt, want, wcnt = lo_runs["solve"]
    _pose_close(got, want, "solve_f2f")
    assert wcnt.min() > 50 and np.abs(gcnt - wcnt).max() <= 0.02 * wcnt.max(), (gcnt, wcnt)


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_lo_step_with_distortion_matches_reference(lo_runs, frame):
    (gd, gc, gs), (wd, wc, ws) = lo_runs["port"][frame], lo_runs["ref"][frame]
    _pose_close(gd, wd, f"lo_step {frame}")
    for got, want in ((gc, wc), (gs, ws)):
        rng_m = np.linalg.norm(want[:, :3], axis=-1, keepdims=True)
        assert np.all(np.abs(got[:, :3] - want[:, :3]) <= T_TOL + R_TOL * rng_m)
        np.testing.assert_array_equal(got[:, 3], want[:, 3])      # ring + time rides along
    if frame == 1:
        assert np.linalg.norm(gd[4:] - lo_runs["t_true"]) < 0.1
        assert np.abs(gc[:, :3] - lo_runs["port"][0][1][:, :3]).max() > 0.1   # moved to the end


def test_lo_distortion_flag_flips_behavior_and_recovers_motion():
    """The port alone on tests/test_distortion.py's drive and bounds."""
    sc = dict(ring_cap=1024, max_points=65536, less_flat_cap=16384)
    pts_a, pts_b, t_true = _distorted(n_azimuth=700)

    def run(distortion):
        _, cfg = _configs(sc)
        cfg = cfg.replace(odom=tconfig.OdometryConfig(distortion=distortion))
        state = tlo.init_lo_state(cfg, "cpu")
        for pts in (pts_a, pts_b):
            state, delta, _, _ = tlo.lo_step(state, _features(pts, cfg), cfg)
        return float(np.linalg.norm(delta.numpy()[4:] - t_true))

    err_on, err_off = run(True), run(False)
    assert err_on < 0.08, (err_on, err_off)
    assert err_on < 0.5 * err_off, (err_on, err_off)
