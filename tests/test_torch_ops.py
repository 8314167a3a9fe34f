"""The PyTorch port's config, geometry, 3x3 algebra, lidar factors, voxel
filter, compaction and NumPy host data layer against the JAX reference.

Inputs are made with NumPy from a fixed seed and fed to both packages.
Floating-point comparisons use atol 1e-5 (f32 rounding of ~1e1 values);
the NumPy copies must give equal arrays.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vloam_tpu import config as jconfig
from vloam_tpu import geometry as jgeo
from vloam_tpu.data import gridding as jgrid
from vloam_tpu.data import synthetic as jsyn
from vloam_tpu.ops import knn as jknn
from vloam_tpu.ops import lidar_factors as jfac
from vloam_tpu.ops import linalg3 as jlin
from vloam_tpu.ops import voxel as jvox
from vloam_tpu_torch import config as tconfig
from vloam_tpu_torch import geometry as tgeo
from vloam_tpu_torch.data import gridding as tgrid
from vloam_tpu_torch.data import synthetic as tsyn
from vloam_tpu_torch.ops import knn as tknn
from vloam_tpu_torch.ops import lidar_factors as tfac
from vloam_tpu_torch.ops import linalg3 as tlin
from vloam_tpu_torch.ops import voxel as tvox

ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=0)


@pytest.mark.parametrize("name", ["kitti_hdl64", "vlp16", "hdl32"])
def test_config_copy_equals_reference(name):
    assert dataclasses.asdict(getattr(tconfig, name)()) == dataclasses.asdict(
        getattr(jconfig, name)())


def _quats(rng, n):
    aa = rng.normal(0, 0.7, (n, 3)).astype(np.float32)
    return np.asarray(jgeo.angle_axis_to_quat(jnp.array(aa))), aa


def _poses(rng, n):
    q, _ = _quats(rng, n)
    t = rng.normal(0, 20, (n, 3)).astype(np.float32)
    return np.concatenate([q, t], axis=-1)


GEOMETRY_CASES = {
    "quat_mul": lambda r: (_quats(r, 64)[0], _quats(r, 64)[0]),
    "quat_to_matrix": lambda r: (_quats(r, 64)[0],),
    "angle_axis_to_quat": lambda r: (np.concatenate(
        [r.normal(0, 1, (60, 3)), np.zeros((4, 3))]).astype(np.float32),),
    "pose_compose": lambda r: (_poses(r, 64), _poses(r, 64)),
    "pose_inverse": lambda r: (_poses(r, 64),),
    "pose_apply": lambda r: (_poses(r, 1)[0], r.uniform(-60, 60, (256, 3)).astype(np.float32)),
}


@pytest.mark.parametrize("fn", sorted(GEOMETRY_CASES))
def test_geometry_matches_reference(fn, rng):
    args = GEOMETRY_CASES[fn](rng)
    want = getattr(jgeo, fn)(*(jnp.array(a) for a in args))
    got = getattr(tgeo, fn)(*(torch.tensor(a) for a in args))
    _close(got, want, atol=1e-4 if fn in ("pose_apply", "pose_compose", "pose_inverse") else ATOL)


def test_pose_identity_on_device():
    _close(tgeo.pose_identity("cpu"), jgeo.pose_identity())


def _sym3(rng, n):
    pts = rng.normal(0, 1, (n, 5, 3)).astype(np.float32) * np.array([3.0, 1.0, 0.1], np.float32)
    c = pts - pts.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", c, c).astype(np.float32)
    return [cov[:, 0, 0], cov[:, 1, 1], cov[:, 2, 2], cov[:, 0, 1], cov[:, 1, 2], cov[:, 0, 2]]


def test_eigh3x3_sym_matches_reference(rng):
    args = _sym3(rng, 256)
    (je, jv) = jlin.eigh3x3_sym(*(jnp.array(a) for a in args))
    (te, tv) = tlin.eigh3x3_sym(*(torch.tensor(a) for a in args))
    for a, b in zip(je, te):
        _close(b, a, atol=1e-4)
    for va, vb in zip(jv, tv):          # eigenvectors up to sign
        dot = sum(_np(x) * _np(y) for x, y in zip(va, vb))
        np.testing.assert_allclose(np.abs(dot), 1.0, atol=1e-4)


def test_solve3x3_sym_matches_reference(rng):
    args = _sym3(rng, 256)
    for i in range(3):
        args[i] = args[i] + 1.0       # well-conditioned
    rhs = list(rng.normal(0, 1, (3, 256)).astype(np.float32))
    want = jlin.solve3x3_sym(*(jnp.array(a) for a in args + rhs))
    got = tlin.solve3x3_sym(*(torch.tensor(a) for a in args + rhs))
    for a, b in zip(want, got):
        _close(b, a, atol=1e-4)


def test_solve_spd_small_matches_reference(rng):
    J = rng.normal(0, 1, (40, 6)).astype(np.float32)
    A = (J.T @ J + np.eye(6, dtype=np.float32)).astype(np.float32)
    b = rng.normal(0, 1, 6).astype(np.float32)
    _close(tlin.solve_spd_small(torch.tensor(A), torch.tensor(b)),
           jlin.solve_spd_small(jnp.array(A), jnp.array(b)), atol=1e-4)


def _factor_inputs(rng, n=128):
    pose = _poses(rng, 1)[0]
    p, a, b = (rng.uniform(-30, 30, (n, 3)).astype(np.float32) for _ in range(3))
    nrm = rng.normal(0, 1, (n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    d = rng.uniform(-5, 5, n).astype(np.float32)
    return pose, p, a, b, nrm, d


@pytest.mark.parametrize("fn", ["edge_residual", "plane_residual", "plane_from_three_points"])
def test_lidar_factors_match_reference(fn, rng):
    pose, p, a, b, nrm, d = _factor_inputs(rng)
    args = {"edge_residual": (pose, p, a, b), "plane_residual": (pose, p, nrm, d),
            "plane_from_three_points": (p, a, b)}[fn]
    want = getattr(jfac, fn)(*(jnp.array(x) for x in args))
    got = getattr(tfac, fn)(*(torch.tensor(x) for x in args))
    for w, g in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        _close(g, w, atol=1e-3)   # residuals of ~1e2-1e3 magnitude


@pytest.mark.parametrize("leaf,cap", [(0.4, 512), (0.8, 2048)])
def test_voxel_downsample_matches_reference(leaf, cap, rng):
    """Run-merge path on a scan-ordered cloud with interleaved invalid rows
    (the segment ids must run on through them)."""
    n = 1500
    walk = np.cumsum(rng.normal(0, 0.15, (n, 3)), axis=0).astype(np.float32)
    pts = np.concatenate([walk, rng.uniform(0, 64, (n, 1)).astype(np.float32)], axis=1)
    mask = rng.random(n) < 0.8
    jp, jm = jvox.voxel_downsample(jnp.array(pts), jnp.array(mask), leaf, cap, presorted=True)
    tp, tm = tvox.voxel_downsample(torch.tensor(pts), torch.tensor(mask), leaf, cap)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    _close(tp, jp, atol=1e-4)


def test_compact_rows_and_masked_argmin_match_reference(rng):
    pts = rng.normal(0, 1, (6, 40, 4)).astype(np.float32)
    counts = np.array([0, 40, 7, 13, 40, 2], np.int32)
    jo, jmk = jknn.compact_rows(jnp.array(pts), jnp.array(counts), 100)
    to, tmk = tknn.compact_rows(torch.tensor(pts), torch.tensor(counts).long(), 100)
    np.testing.assert_array_equal(tmk.numpy(), np.asarray(jmk))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))

    d2 = rng.uniform(0, 10, (64, 8)).astype(np.float32)
    valid = rng.random((64, 8)) < 0.5
    jd, ji = jknn.masked_argmin(jnp.array(d2), jnp.array(valid))
    td, ti = tknn.masked_argmin(torch.tensor(d2), torch.tensor(valid))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_synthetic_copy_equals_reference():
    np.testing.assert_array_equal(tsyn.default_scene(), jsyn.default_scene())
    for a, b in zip(tsyn.straight_trajectory(5, 0.8, 0.01), jsyn.straight_trajectory(5, 0.8, 0.01)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    R, t = jsyn.straight_trajectory(3, 0.8, 0.01)[2]
    scene = jsyn.default_scene()
    pts = tsyn.simulate_scan(R, t, scene, n_azimuth=300, noise=0.005, seed=4)
    np.testing.assert_array_equal(pts, jsyn.simulate_scan(R, t, scene, n_azimuth=300,
                                                          noise=0.005, seed=4))
    for a, b in zip(tsyn.pad_cloud(pts, 30000), jsyn.pad_cloud(pts, 30000)):
        np.testing.assert_array_equal(a, b)


def test_gridding_copy_equals_reference():
    cfg = jconfig.ScanConfig(ring_cap=512, max_points=32768, less_flat_cap=8192)
    pts = jsyn.simulate_scan(np.eye(3), np.zeros(3), jsyn.default_scene(), n_azimuth=400,
                             noise=0.005, seed=1)
    want = jgrid.grid_cloud(pts, cfg)
    got = tgrid.grid_cloud(pts, tconfig.ScanConfig(ring_cap=512, max_points=32768,
                                                   less_flat_cap=8192))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    lf_want = jgrid.less_flat_voxel_table(want[0], want[1], cfg)
    lf_got = tgrid.less_flat_voxel_table(got[0], got[1], cfg)
    for a, b in zip(lf_got, lf_want):
        np.testing.assert_array_equal(a, b)


def test_port_never_imports_jax():
    """Importing the port and running a small slice (two frames, so LO and
    MO both solve), two frames of the full step, the runtime entry point
    (VloamDriver with a checkpoint, keyframes, trajectory export and the
    CLI's ``main`` with --refine --loop-closure), the close() epilogue's
    modules (keyframe features, a loop registration, a banded pose-graph
    solve), the native host library's binding, the scenario worlds, the
    raw-cloud step, the validation-drive tool, the epipolar solvers (a RANSAC
    solve) and the sharded step (two frames on a one-rank gloo mesh) loads
    no jax module."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import vloam_tpu_torch
        from vloam_tpu_torch import config as C
        from vloam_tpu_torch.data import gridding, stream, synthetic
        from vloam_tpu_torch.models import frame_graph, vloam
        from vloam_tpu_torch.models.lidar_slice import frame_to_device, init_lidar_state, lidar_step
        cfg = C.kitti_hdl64().replace(
            scan=C.ScanConfig(ring_cap=256, max_points=16384, less_flat_cap=4096),
            mapping=C.MappingConfig(grid_w=5, grid_h=5, grid_d=3, corner_cube_cap=256,
                                    surf_cube_cap=512, corner_stack_cap=512, surf_stack_cap=1024,
                                    submap_corner_cap=1024, submap_surf_cap=2048))
        state = init_lidar_state(cfg, "cpu")
        scene = synthetic.default_scene()
        for i, (R, t) in enumerate(synthetic.straight_trajectory(2, speed=0.5)):
            g, m, _ = gridding.grid_cloud(synthetic.simulate_scan(R, t, scene, n_azimuth=200), cfg.scan)
            lf = gridding.less_flat_voxel_table(g, m, cfg.scan)
            state, out = lidar_step(state, *frame_to_device(g, m, lf, "cpu"), cfg)
        assert np.isfinite(out.world_mo.numpy()).all()
        ext = frame_graph.kitti_default_extrinsics("cpu")
        frames, _ = stream.gen_frames(cfg, ext, 2, n_azimuth=200)
        vstate = vloam.init_vloam_state(cfg, "cpu")
        for f in frames:
            img, g, m, bk, lf = vloam.frame_to_device(*f, "cpu")
            vstate, vout = vloam.vloam_step(vstate, img, g, m, ext, cfg, pre_gridded=True,
                                            pre_buckets=bk, pre_lf_table=lf)
        assert all(np.isfinite(v.numpy()).all() for v in vout)
        import tempfile
        from vloam_tpu_torch.data import kitti
        from vloam_tpu_torch.runtime import __main__ as cli, driver
        from vloam_tpu_torch.utils import kitti_eval, trajectory
        with tempfile.TemporaryDirectory() as tmp:
            drv = driver.VloamDriver(cfg, ext, out_dir=tmp, checkpoint_dir=tmp + "/ck",
                                     checkpoint_every=2, refine=True, loop_closure=True,
                                     keyframe_every=1, device="cpu")
            for img, g, m, _, _ in frames:
                drv.process_grid(img, g, m)
            drv.close()
            assert drv.restore_checkpoint(tmp + "/ck/ckpt_000002") == 2
            assert sorted(drv._keyframes) == [0, 1]
            assert trajectory.load_kitti_trajectory(tmp + "/MO1.txt").shape == (2, 3, 4)
            import torch
            from vloam_tpu_torch.parallel import loop_closure, pose_graph
            f0, f1 = drv._keyframe_features(0), drv._keyframe_features(1)
            z, _, _ = loop_closure.register_loop(f0, f1, torch.tensor([0, 0, 0, 1.0, 0.5, 0, 0]),
                                                 cfg, outer_iters=1)
            assert np.isfinite(z).all()
            steps = torch.tensor([[0, 0, 0, 1.0, 0.5, 0, 0]] * 3)
            chain = pose_graph.odometry_factors(steps)
            loop = loop_closure.loop_factors([(0, 3)], [np.array([0, 0, 0, 1.0, 1.6, 0, 0])])
            start = torch.tensor([[0, 0, 0, 1.0, 0.5 * k, 0, 0] for k in range(4)])
            assert torch.isfinite(pose_graph.optimize_pose_graph_banded(start, chain, loop)).all()
        from vloam_tpu_torch.data import scenarios
        from vloam_tpu_torch.runtime import native
        from vloam_tpu_torch.tools import validate_drive
        assert native.available() or native.toolchain_missing()
        assert scenarios.corridor_scene(50.0).shape == (2, 6)
        p, m = synthetic.pad_cloud(synthetic.simulate_scan(np.eye(3), np.zeros(3), scene,
                                                           n_azimuth=200), cfg.scan.max_points)
        _, rout = vloam.vloam_step(vloam.init_vloam_state(cfg, "cpu"), torch.tensor(frames[0][0]),
                                   torch.tensor(p), torch.tensor(m), ext, cfg, pre_gridded=False)
        assert all(np.isfinite(v.numpy()).all() for v in rout)
        snake, snake_poses = stream.gen_frames(cfg, ext, 2, n_azimuth=200, snake=True, hard=True)
        rec = validate_drive.drive(cfg, ext, snake, snake_poses, hard=True)
        assert rec["mode"] == "hard_decoupled_D" and np.isfinite(rec["final_err_m"])
        from vloam_tpu_torch.models import visual_odometry
        from vloam_tpu_torch.ops import epipolar, threefry, vo_factors  # noqa: F401
        from vloam_tpu_torch.parallel import mapping_shard, mesh, vloam_shard  # noqa: F401
        uv = torch.rand(64, 2) * 500
        K = torch.tensor([[718.0, 0, 607], [0, 718, 185], [0, 0, 1]])
        rpose, _ = visual_odometry.solve_ransac(uv, uv + 1.0, torch.ones(64, dtype=torch.bool), K,
                                                n_hypotheses=16)
        assert torch.isfinite(rpose).all()
        with tempfile.TemporaryDirectory() as tmp:
            mesh.init_distributed("gloo", f"file://{tmp}/store", 1, 0)
            mmesh = mesh.map_mesh(1, device="cpu")
            sstep = vloam_shard.make_sharded_vloam_step(cfg, ext, mmesh)
            sstate = vloam_shard.shard_vloam_state(vloam.init_vloam_state(cfg, "cpu"), mmesh)
            for f in frames:
                img, g, gm, bk, lf = vloam.frame_to_device(*f, "cpu")
                sstate, sout = sstep(sstate, img, g, gm, pre_gridded=True, pre_buckets=bk,
                                     pre_lf_table=lf)
            assert all(np.isfinite(v.numpy()).all() for v in sout)
        C.kitti_hdl64 = lambda: cfg
        cli.main(["--device", "cpu", "--frames", "2", "--json"])
        cli.main(["--device", "cpu", "--frames", "3", "--json", "--refine", "--loop-closure"])
        bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
        assert not bad, bad
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    # two threads, as the suite's workers run torch: eight in each process
    # beside five busy workers only fight over the cores
    env["OMP_NUM_THREADS"] = "2"
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]


def test_kernel_wrappers_never_fall_back():
    """A tensor that is not on the CPU goes to the kernel or raises: it is
    never quietly given to the plain version."""
    from vloam_tpu_torch.ops import fused_gn, fused_knn, patch_gather

    q = torch.zeros((8, 3), device="meta")
    m = torch.zeros((16,), dtype=torch.bool, device="meta")
    c = torch.zeros((16, 3), device="meta")
    with pytest.raises(ValueError):
        fused_knn.knn_pair(q, c, m, 5, q, c, m, 5)
    pose = torch.zeros((7,), device="meta")
    v = torch.zeros((8,), device="meta")
    with pytest.raises(ValueError):
        fused_gn.solve_pose_gn_lidar(pose, (q, q, q, v), (q, q, v, v), 4, 0.1, 1e-4)
    with pytest.raises(ValueError):
        fused_gn.solve_pose_gn_vo(pose, q, q[:, :2], q[:, :2], v.bool(), v.bool(), 10, 0.1, 1e-4)
    img = torch.zeros((64, 64), device="meta")
    corners = torch.zeros((8, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        patch_gather.gather_patches_pair(img, img, corners, corners, 32)
    assert fused_knn.LAUNCHES == 0 and fused_gn.LAUNCHES == 0
    assert fused_gn.LAUNCHES_VO == 0 and patch_gather.LAUNCHES == 0
