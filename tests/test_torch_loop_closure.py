"""The port's loop closure (``vloam_tpu_torch.parallel.loop_closure``), the
batched registration under it and the keyframe feature path, against the
JAX package on the CPU.  Inputs: the ring course of
tests/test_driver_loop_closure.py (the port's ``synthetic`` and
``gridding`` copies make the scans), at its small caps.

* ``path_cumlen``, ``effective_radius`` and ``detect_revisits``: equal.
* ``voxel_downsample(group_key=...)`` (the run-merge, JAX's
  ``presorted=True``): masks equal,
  centroids within 1e-4 (the existing voxel test's bound), interleaved
  invalid rows included (the running segment id, trap C4).
* ``extract_features_from_grid(lf_table=None)``: against the JAX function
  run op by op, as tests/test_torch_scan_registration.py runs it (compiled,
  XLA contracts multiply-adds and moves curvature by an ulp): masks equal,
  points within 1e-5, less-flat centroids within 1e-4.
* ``coarse_align`` on two keyframes a known SE(2) offset apart, both sides
  given the same features: the occupancy grids of the unrotated clouds
  equal; at most 0.1 % of the 128 x 33 x 33 correlation scores differ (a
  rotated point can cross a cell edge by an ulp: 0 differed when this was
  written); the top-6 poses within one cell and one yaw bin of JAX's and the
  first within one cell and one yaw bin of the truth.
* ``tight_inlier_frac`` on seven poses in one call: within 2/2048 of JAX's
  per-pose values (the k-NN's difference form after rebasing can move a
  distance at the 0.5 m gate by an ulp).
* ``register_loop`` from the chain seed alone, two outer iterations
  (``use_coarse=False, outer_iters=2``: the JAX side's CPU solves cost ~3 s
  each; test_torch_driver_refine.py runs the driver's five): ``accepted``
  equal, z within 1e-3 m / 1e-3 rad.
* ``solve_f2f_batched`` against S calls of the port's ``solve_f2f``: within
  B3's bound of its plain version (1.1e-6 m or 4 float32 eps of |t|, 1e-6
  in the quaternion); on the CPU both run the same plain solves, and the
  stacked k-NN gives each seed's rows as the unbatched call does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_driver_loop_closure import _ring_scene
from vloam_tpu import geometry as jgeo
from vloam_tpu.config import ScanConfig, kitti_hdl64
from vloam_tpu.ops import voxel as jvox
from vloam_tpu.ops.scan_registration import extract_features_from_grid as jax_extract
from vloam_tpu.parallel import loop_closure as jlc
from vloam_tpu_torch import config as tconfig
from vloam_tpu_torch import geometry as tgeo
from vloam_tpu_torch.data import gridding, synthetic
from vloam_tpu_torch.models.lidar_odometry import solve_f2f, solve_f2f_batched
from vloam_tpu_torch.ops import voxel as tvox
from vloam_tpu_torch.ops.scan_registration import ScanFeatures, extract_features_from_grid
from vloam_tpu_torch.parallel import loop_closure as tlc

SC = dict(ring_cap=512, max_points=32768, less_flat_cap=8192)
JCFG = kitti_hdl64().replace(scan=ScanConfig(**SC), verbose_level=0)
TCFG = tconfig.kitti_hdl64().replace(scan=tconfig.ScanConfig(**SC), verbose_level=0)
N, SPEED = 56, 1.1
YAW_RATE = 2 * np.pi / N
T_TOL, T_EPS, Q_TOL = 1.1e-6, 4, 1e-6    # B3 against its plain version (tools/gn_check)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def course():
    """Ground-truth poses of the ring course and the ring grids of frames
    0, 3 and 55 (the last closes the loop 1.1 m short of the first)."""
    poses = synthetic.straight_trajectory(N, speed=SPEED, yaw_rate=YAW_RATE)
    scene = _ring_scene(SPEED / YAW_RATE)
    grids = {}
    for fid in (0, 3, 55):
        R, t = poses[fid]
        cloud = synthetic.simulate_scan(R, t, scene, n_azimuth=500, noise=0.01, seed=fid)
        grids[fid] = gridding.grid_cloud(cloud, TCFG.scan)[:2]
    return poses, grids


@pytest.fixture(scope="module")
def feats(course):
    """The JAX package's keyframe features (compiled, as its driver makes
    them) of frames 0, 3 and 55: NumPy ScanFeatures, given to both sides."""
    _, grids = course
    fn = jax.jit(lambda g, m: jax_extract(g, m, jnp.sum(m, axis=1).astype(jnp.int32), JCFG.scan))
    return {fid: jax.tree.map(np.asarray, fn(jnp.array(g), jnp.array(m)))
            for fid, (g, m) in grids.items()}


def jfeats(f):
    return jax.tree.map(jnp.asarray, f)


def tfeats(f):
    return ScanFeatures(*[torch.tensor(x) for x in f])


def gt_rel(poses, j, k):
    """Ground-truth j_T_k as a float32 7-vector."""
    (Rj, tj), (Rk, tk) = poses[j], poses[k]
    R, t = Rj.T @ Rk, Rj.T @ (tk - tj)
    q = np.asarray(tgeo.matrix_to_quat(torch.tensor(R, dtype=torch.float32)))
    return np.concatenate([q, t]).astype(np.float32)


def yaw_of(pose):
    return 2.0 * np.arctan2(pose[2], pose[3])


# ---------------------------------------------------------------------------
# host control plane
# ---------------------------------------------------------------------------

def _position_cases():
    rng = np.random.default_rng(3)
    line = np.stack([np.arange(50.0), np.zeros(50), np.zeros(50)], -1)
    loop = np.concatenate([line[:40], line[:5][::-1]])
    stopped = np.concatenate([line[:10], np.repeat(line[9:10], 30, axis=0)
                              + rng.normal(scale=0.05, size=(30, 3))])
    th = np.linspace(0, 2 * np.pi, 80)
    circle = np.stack([100 * np.sin(th), 100 * (1 - np.cos(th)), np.zeros(80)], -1)
    circle = circle + np.linspace(0, 1, 80)[:, None] ** 2 * np.array([8.0, 9.0, 0.0])
    walk = np.cumsum(rng.normal(0, 2.0, (120, 3)), axis=0)
    return {"line": line, "loop": loop, "stopped": stopped, "circle": circle, "walk": walk}


@pytest.mark.parametrize("case", sorted(_position_cases()))
@pytest.mark.parametrize("gates", [
    dict(min_gap=20, radius=1.5),
    dict(min_gap=5, radius=3.0, min_spacing=2),
    dict(min_gap=5, radius=3.0, min_spacing=2, min_travel=15.0),
    dict(min_gap=40, radius=6.0, min_spacing=5, min_travel=100.0, drift_rate=0.02),
])
def test_detect_revisits_equals_reference(case, gates):
    pos = _position_cases()[case]
    assert tlc.detect_revisits(pos, **gates) == jlc.detect_revisits(pos, **gates)
    cum = tlc.path_cumlen(pos)
    np.testing.assert_array_equal(cum, jlc.path_cumlen(pos))
    n = len(pos)
    for j, k in ((0, n - 1), (n // 3, n // 2)):
        assert (tlc.effective_radius(cum, j, k, 6.0, 0.02)
                == jlc.effective_radius(cum, j, k, 6.0, 0.02))


# ---------------------------------------------------------------------------
# the keyframe feature path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("leaf,cap", [(0.2, 4096), (0.8, 512)])
def test_voxel_group_key_matches_reference(leaf, cap, rng):
    """Scan-ordered rings with interleaved invalid rows, a ring id as the
    group key."""
    rings, per = 6, 400
    walk = np.cumsum(rng.normal(0, 0.08, (rings * per, 3)), axis=0).astype(np.float32)
    pts = np.concatenate([walk, rng.uniform(0, 64, (rings * per, 1)).astype(np.float32)], 1)
    mask = rng.random(rings * per) < 0.8
    ring = np.repeat(np.arange(rings, dtype=np.int32), per)
    jp, jm = jvox.voxel_downsample(jnp.array(pts), jnp.array(mask), leaf, cap,
                                   group_key=jnp.array(ring), presorted=True)
    tp, tm = tvox.voxel_downsample(torch.tensor(pts), torch.tensor(mask), leaf, cap,
                                   group_key=torch.tensor(ring))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert int(tm.sum()) > 50
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def features_no_table(course):
    _, grids = course
    grid, gmask = grids[0]
    n_per_ring = gmask.sum(axis=1).astype(np.int32)
    with jax.disable_jit():
        want = jax_extract(jnp.array(grid), jnp.array(gmask), jnp.array(n_per_ring), JCFG.scan)
    got = extract_features_from_grid(torch.tensor(grid), torch.tensor(gmask),
                                     torch.tensor(n_per_ring), TCFG.scan)
    return got, jax.tree.map(np.asarray, want)


@pytest.mark.parametrize("cloud,atol", [("sharp", 1e-5), ("less_sharp", 1e-5), ("flat", 1e-5),
                                        ("less_flat", 1e-4)])
def test_features_without_table_match_reference(features_no_table, cloud, atol):
    got, want = features_no_table
    mask = getattr(want, cloud + "_mask")
    np.testing.assert_array_equal(getattr(got, cloud + "_mask").numpy(), mask)
    assert mask.sum() > 50
    np.testing.assert_allclose(getattr(got, cloud).numpy(), getattr(want, cloud), atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# coarse alignment and the arbiter
# ---------------------------------------------------------------------------

def jax_scores(fj, fk, n_yaw=128, cell=4.0, half=96.0, search=16):
    """The correlation inside the reference's coarse_align (a nested
    function there), written out: (occupancy of j, scores (n_yaw, w * w))."""
    def cloud(f):
        pts = jnp.concatenate([f.less_flat[:, :3], f.less_sharp[:, :3]])
        msk = jnp.concatenate([f.less_flat_mask, f.less_sharp_mask])
        r = jnp.linalg.norm(pts[:, :2], axis=1)
        return pts, msk & (r > 3.0) & (r < half) & (pts[:, 2] > -1.0)

    G = int(2 * half / cell)

    def occ(p, m):
        ix = jnp.clip(((p[:, 0] + half) / cell).astype(jnp.int32), 0, G - 1)
        iy = jnp.clip(((p[:, 1] + half) / cell).astype(jnp.int32), 0, G - 1)
        g = jnp.zeros((G, G), jnp.float32).at[ix, iy].add(jnp.where(m, 1.0, 0.0))
        return jnp.minimum(g, 4.0)

    @jax.jit
    def run(fj, fk):
        pj, mj = cloud(fj)
        pk, mk = cloud(fk)
        gj = occ(pj, mj)
        pad = jnp.pad(gj, search)[None, None]
        yaws = 2 * jnp.pi * jnp.arange(n_yaw, dtype=jnp.float32) / n_yaw

        def score_full(yaw):
            cy, sy = jnp.cos(yaw), jnp.sin(yaw)
            rot = jnp.stack([cy * pk[:, 0] - sy * pk[:, 1], sy * pk[:, 0] + cy * pk[:, 1],
                             pk[:, 2]], -1)
            return jax.lax.conv_general_dilated(
                pad, occ(rot, mk)[None, None], (1, 1), "VALID",
                dimension_numbers=("NCHW", "OIHW", "NCHW"))[0, 0].reshape(-1)

        return gj, jax.vmap(score_full)(yaws)

    return jax.tree.map(np.asarray, run(fj, fk))


def test_coarse_align_matches_reference(course, feats):
    poses, _ = course
    fj, fk = feats[0], feats[3]
    gj_want, scores_want = jax_scores(jfeats(fj), jfeats(fk))
    tj, tk = tfeats(fj), tfeats(fk)
    pts, msk = tlc._clouds(tj)
    r = torch.linalg.vector_norm(pts[:, :2], dim=1)
    gj = tlc.occupancy(pts, msk & (r > 3.0) & (r < 96.0) & (pts[:, 2] > -1.0), 4.0, 96.0)
    np.testing.assert_array_equal(gj.numpy(), gj_want)
    scores, _, _ = tlc.coarse_scores(tj, tk)
    differ = int(np.sum(scores.reshape(128, -1).numpy() != scores_want))
    print(f"coarse_align: {differ} of {scores_want.size} scores differ from the reference")
    assert differ <= scores_want.size // 1000

    want = np.asarray(jlc.coarse_align(jfeats(fj), jfeats(fk), top_k=6))
    got = tlc.coarse_align(tj, tk, top_k=6).numpy()
    assert got.shape == want.shape == (6, 7)
    bin_rad = 2 * np.pi / 128
    for g, w in zip(got, want):
        assert np.abs(g[4:6] - w[4:6]).max() <= 4.0 + 1e-6, (g, w)
        dyaw = np.angle(np.exp(1j * (yaw_of(g) - yaw_of(w))))
        assert abs(dyaw) <= bin_rad + 1e-6, (g, w)
        assert abs(g[6] - w[6]) < 1e-5
    truth = gt_rel(poses, 0, 3)
    assert np.abs(got[0][4:6] - truth[4:6]).max() <= 4.0
    assert abs(np.angle(np.exp(1j * (yaw_of(got[0]) - yaw_of(truth))))) <= bin_rad


def test_tight_inlier_frac_matches_reference(course, feats):
    poses, _ = course
    fj, fk = feats[0], feats[55]
    rng = np.random.default_rng(7)
    truth = gt_rel(poses, 0, 55)
    seeds = []
    for s in range(7):
        aa = np.array([0.0, 0.0, rng.normal(0, 0.02 * s)], np.float32)
        dq = np.asarray(tgeo.angle_axis_to_quat(torch.tensor(aa)))
        seeds.append(np.asarray(tgeo.pose_compose(
            torch.tensor(np.concatenate([dq, rng.normal(0, 0.15 * s, 3)]).astype(np.float32)),
            torch.tensor(truth))))
    seeds = np.stack(seeds).astype(np.float32)
    got = tlc.tight_inlier_frac(tfeats(fj), tfeats(fk), torch.tensor(seeds)).numpy()
    want = np.array([float(jlc.tight_inlier_frac(jfeats(fj), jfeats(fk), jnp.array(s)))
                     for s in seeds])
    assert got.shape == (7,)
    np.testing.assert_allclose(got, want, atol=2 / 2048 + 1e-7, rtol=0)
    assert want[0] > 0.3   # the truth scores as a loop


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------

def test_register_loop_matches_reference(course, feats):
    poses, _ = course
    fj, fk = feats[0], feats[55]
    truth = gt_rel(poses, 0, 55)
    seed = np.asarray(tgeo.pose_compose(
        torch.tensor([0.0, 0.0, 0.02, float(np.sqrt(1 - 0.02**2)), 0.6, -0.4, 0.05]),
        torch.tensor(truth))).astype(np.float32)
    zj, nj, okj = jlc.register_loop(jfeats(fj), jfeats(fk), jnp.array(seed), JCFG,
                                    use_coarse=False, outer_iters=2)
    zt, nt, okt = tlc.register_loop(tfeats(fj), tfeats(fk), torch.tensor(seed), TCFG,
                                    use_coarse=False, outer_iters=2)
    assert okt == okj and okt, (nt, nj)
    assert abs(nt - nj) <= 2
    np.testing.assert_allclose(zt[4:], zj[4:], atol=1e-3, rtol=0)
    sign = 1.0 if float(np.dot(zt[:4], zj[:4])) >= 0 else -1.0
    np.testing.assert_allclose(zt[:4] * sign, zj[:4], atol=5e-4, rtol=0)   # ~1e-3 rad
    assert np.linalg.norm(zt[4:] - truth[4:]) < 0.1


def test_solve_f2f_batched_equals_unbatched(course, feats):
    """Three seeds at once against three unbatched calls (two outer
    iterations, the loop configuration otherwise)."""
    poses, _ = course
    fj, fk = tfeats(feats[0]), tfeats(feats[3])
    cfg = dataclasses.replace(TCFG, odom=dataclasses.replace(TCFG.odom, outer_iters=2))
    truth = torch.tensor(gt_rel(poses, 0, 3))
    seeds = torch.stack([truth, tgeo.pose_compose(torch.tensor([0, 0, 0.01, 0.99995, 0.3, 0, 0]), truth),
                         tgeo.pose_compose(torch.tensor([0, 0, -0.02, 0.9998, -0.2, 0.4, 0]), truth)])
    args = (fk, fj.less_sharp, fj.less_sharp_mask, fj.less_flat, fj.less_flat_mask)
    got, counts = solve_f2f_batched(*args, seeds, cfg)
    assert got.shape == (3, 7) and counts.shape == (3, 2) and counts.dtype == torch.int32
    for s in range(3):
        want, want_counts = solve_f2f(*args, seeds[s], cfg)
        assert torch.equal(counts[s], want_counts)
        t_tol = max(T_TOL, T_EPS * float(torch.finfo(torch.float32).eps)
                    * float(want[4:].abs().max()))
        assert float((got[s, 4:] - want[4:]).abs().max()) <= t_tol
        sign = 1.0 if float(torch.dot(got[s, :4], want[:4])) >= 0 else -1.0
        assert float((got[s, :4] * sign - want[:4]).abs().max()) <= Q_TOL
        assert float((got[s, 4:] - truth[4:]).abs().max()) < 0.05
