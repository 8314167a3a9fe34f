"""The port's epipolar VO solvers (``vloam_tpu_torch.ops.epipolar``,
``models.visual_odometry.solve_ransac`` / ``solve_nls_2d_only``) and the
two dead-code VO factors, on the CPU, against the JAX package.

* The four contracts of ``tests/test_epipolar.py`` on the port, with its
  bounds: RANSAC's rotation within 5e-3 and translation direction cos > 0.99
  of the truth under 25 % outliers, its inliers excluding gross outliers,
  masked matches never sampled; the 2D-only NLS within 2e-3 / cos > 0.999.
* Parity on the same seeded inputs:
  - ``eight_point`` up to sign on the RANSAC draw's samples.  The reference
    normalises by K alone, so AᵀA's two smallest eigenvalues lie 1e-11 ..
    1e-5 of its largest apart; an eigenvector then moves by about
    eps * λmax / gap under rounding.  Hypotheses with a relative gap of
    1e-6 or more are compared, each within 1e-7 / gap (float32's epsilon
    times the condition of the null vector);
  - ``sampson_error`` on the same E: 1e-5 relative and 1e-10 absolute
    (5e-5 of the 1 px threshold); ``recover_pose`` on it: the same vote,
    the pose within 1e-4;
  - ``find_essential_ransac`` / ``solve_ransac``: the winner's inlier count
    within 3 % of the reference's (the same sample can score a few matches
    apart: its E is ill-conditioned as above) and the pose within the
    ground-truth bounds of each other (rotation 5e-3, direction cos 0.99);
  - ``solve_nls_2d_only``: within 1e-4 of the reference's pose;
  - ``point_33_residual`` / ``inverse_23_residual``: 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_epipolar import _two_view
from vloam_tpu import geometry as jgeo
from vloam_tpu.config import kitti_hdl64
from vloam_tpu.models import visual_odometry as jvo
from vloam_tpu.ops import epipolar as je
from vloam_tpu.ops import vo_factors as jvf
from vloam_tpu_torch import config as tconfig
from vloam_tpu_torch import geometry as tgeo
from vloam_tpu_torch.models import visual_odometry as tvo
from vloam_tpu_torch.ops import epipolar as te
from vloam_tpu_torch.ops import vo_factors as tvf

ROT_TOL, COS_MIN = 5e-3, 0.99          # tests/test_epipolar.py:44-48
NLS_ROT_TOL, NLS_COS_MIN = 2e-3, 0.999
COUNT_REL_TOL = 0.03
POSE_TOL = 1e-4
# 5e-5 of the 1 px inlier threshold (1 / 718)^2: the residual x1^T E x0 cancels
SAMPSON_ATOL = 1e-10


def f32(x):
    return np.asarray(x, np.float32)


def t(x):
    return torch.tensor(f32(x)) if np.asarray(x).dtype != bool else torch.tensor(x)


def outlier_view(seed, p_masked=0.0):
    rng = np.random.default_rng(seed)
    K, uv0, uv1, R, tr = _two_view(rng)
    n = uv0.shape[0]
    bad = rng.random(n) < 0.25
    uv1 = uv1.copy()
    uv1[bad] += rng.uniform(30, 80, (bad.sum(), 2))
    mask = rng.random(n) >= p_masked
    return K, uv0, uv1, mask, bad, R, tr


def rot_of(pose):
    return tgeo.quat_to_matrix(torch.tensor(np.array(pose))[:4]).numpy()


# ---- the reference's contracts, on the port -----------------------------------

def test_ransac_recovers_pose_with_outliers(rng):
    K, uv0, uv1, R, tr = _two_view(rng)
    n = uv0.shape[0]
    bad = rng.random(n) < 0.25
    uv1 = uv1.copy()
    uv1[bad] += rng.uniform(30, 80, (bad.sum(), 2))
    pose, n_inl = tvo.solve_ransac(t(uv0), t(uv1), torch.ones(n, dtype=torch.bool), t(K))
    assert np.abs(rot_of(pose) - R).max() < ROT_TOL
    assert pose[4:].numpy() @ tr / np.linalg.norm(tr) > COS_MIN
    assert int(n_inl) > 0.6 * (~bad).sum()


def test_ransac_inliers_exclude_outliers(rng):
    K, uv0, uv1, _, _ = _two_view(rng, n=300)
    bad = np.zeros(300, bool)
    bad[:60] = True
    uv1 = uv1.copy()
    uv1[bad] += 50.0
    _, inl = te.find_essential_ransac(t(uv0), t(uv1), torch.ones(300, dtype=torch.bool), t(K))
    inl = inl.numpy()
    assert inl[bad].sum() == 0
    assert inl[~bad].sum() > 0.8 * (~bad).sum()


def test_masked_matches_never_sampled(rng):
    K, uv0, uv1, R, _ = _two_view(rng, n=200)
    uv1 = uv1.copy()
    uv1[100:] = rng.uniform(0, 1000, (100, 2))
    mask = np.arange(200) < 100
    assert bool((te.ransac_samples(torch.tensor(mask), 256, 0) < 100).all())
    pose, _ = tvo.solve_ransac(t(uv0), t(uv1), torch.tensor(mask), t(K))
    assert np.abs(rot_of(pose) - R).max() < ROT_TOL


def nls_inputs(rng):
    K, uv0, uv1, R, tr = _two_view(rng, n=500, yaw=0.015, t=(0.8, 0.0, 0.05))
    q0 = jgeo.matrix_to_quat(jnp.array(R, jnp.float32))
    pose0 = np.asarray(jgeo.pose_from_qt(q0, jnp.array(tr * 1.1, jnp.float32)))
    return K, uv0, uv1, R, tr, pose0


def test_nls_2d_only_rotation_and_parity(rng):
    K, uv0, uv1, R, tr, pose0 = nls_inputs(rng)
    mask = np.ones(500, bool)
    pose = tvo.solve_nls_2d_only(t(uv0), t(uv1), torch.tensor(mask), t(K),
                                 tconfig.kitti_hdl64(), torch.tensor(pose0)).numpy()
    assert np.abs(rot_of(pose) - R).max() < NLS_ROT_TOL
    assert pose[4:] @ tr / (np.linalg.norm(pose[4:]) * np.linalg.norm(tr)) > NLS_COS_MIN
    want = np.asarray(jvo.solve_nls_2d_only(
        jnp.array(f32(uv0)), jnp.array(f32(uv1)), jnp.array(mask), jnp.array(f32(K)),
        kitti_hdl64(), jnp.array(pose0)))
    np.testing.assert_allclose(pose * np.sign(pose[:4] @ want[:4]), want, atol=POSE_TOL)


def test_nls_2d_only_from_identity_matches_reference(rng):
    """No seed: the port starts from the identity, as the reference does."""
    K, uv0, uv1, _, _, _ = nls_inputs(rng)
    mask = rng.random(500) < 0.8
    got = tvo.solve_nls_2d_only(t(uv0), t(uv1), torch.tensor(mask), t(K),
                                tconfig.kitti_hdl64()).numpy()
    want = np.asarray(jvo.solve_nls_2d_only(
        jnp.array(f32(uv0)), jnp.array(f32(uv1)), jnp.array(mask), jnp.array(f32(K)),
        kitti_hdl64()))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got * np.sign(got[:4] @ want[:4]), want, atol=POSE_TOL)


# ---- parity with the reference's functions ---------------------------------------

def normalised(K, uv0, uv1):
    K_inv = jnp.linalg.inv(jnp.array(f32(K)))
    return (np.asarray(je._normalize(jnp.array(f32(uv0)), K_inv)),
            np.asarray(je._normalize(jnp.array(f32(uv1)), K_inv)))


@pytest.mark.parametrize("seed", [0, 1])
def test_eight_point_matches_reference_up_to_sign(seed):
    K, uv0, uv1, mask, _, _, _ = outlier_view(seed)
    x0, x1 = normalised(K, uv0, uv1)
    np.testing.assert_allclose(
        te._normalize(t(uv0), tvo.inv3(t(K))).numpy(), x0, rtol=1e-5, atol=1e-7)
    idx = te.ransac_samples(torch.tensor(mask), 256, seed).numpy()
    got = te.eight_point(torch.tensor(x0[idx]), torch.tensor(x1[idx])).numpy()
    want = np.asarray(je.eight_point(jnp.array(x0[idx]), jnp.array(x1[idx])))
    d = np.minimum(np.abs(got - want).max((1, 2)), np.abs(got + want).max((1, 2)))
    a0, b0, a1, b1 = x0[idx][..., 0], x0[idx][..., 1], x1[idx][..., 0], x1[idx][..., 1]
    A = np.stack([a1 * a0, a1 * b0, a1, b1 * a0, b1 * b0, b1, a0, b0, np.ones_like(a0)], -1)
    ev = np.linalg.eigvalsh(np.einsum("hni,hnj->hij", A.astype(np.float64), A))
    gap = (ev[:, 1] - ev[:, 0]) / ev[:, -1]
    well = gap >= 1e-6
    assert well.sum() >= 32, well.sum()
    assert (d[well] <= 1e-7 / gap[well]).all(), (d[well] * gap[well]).max()
    # every hypothesis lies on the essential manifold (singular values 1, 1, 0)
    s = np.linalg.svd(got.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(s, np.broadcast_to([1.0, 1.0, 0.0], s.shape), atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_sampson_and_recover_pose_match_reference(seed):
    K, uv0, uv1, mask, bad, _, _ = outlier_view(seed)
    x0, x1 = normalised(K, uv0, uv1)
    E, inl = je.find_essential_ransac(jnp.array(f32(uv0)), jnp.array(f32(uv1)),
                                      jnp.array(mask), jnp.array(f32(K)))
    Es = np.stack([np.asarray(E), -np.asarray(E), np.eye(3, dtype=np.float32)])
    got = te.sampson_error(torch.tensor(Es), torch.tensor(x0), torch.tensor(x1)).numpy()
    want = np.asarray(je.sampson_error(jnp.array(Es), jnp.array(x0), jnp.array(x1)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=SAMPSON_ATOL)
    inl = np.asarray(inl)
    pose, n_good = te.recover_pose(torch.tensor(np.asarray(E)), torch.tensor(x0),
                                   torch.tensor(x1), torch.tensor(inl))
    jpose, jn = je.recover_pose(E, jnp.array(x0), jnp.array(x1), jnp.array(inl))
    jpose = np.asarray(jpose)
    pose = pose.numpy()
    assert int(n_good) == int(jn)
    np.testing.assert_allclose(pose * np.sign(pose[:4] @ jpose[:4]), jpose, atol=POSE_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ransac_winner_matches_reference(seed):
    K, uv0, uv1, mask, _, R, tr = outlier_view(seed, p_masked=0.1)
    args_t = (t(uv0), t(uv1), torch.tensor(mask), t(K))
    args_j = (jnp.array(f32(uv0)), jnp.array(f32(uv1)), jnp.array(mask), jnp.array(f32(K)))
    _, inl = te.find_essential_ransac(*args_t)
    _, jinl = je.find_essential_ransac(*args_j)
    n, jn = int(inl.sum()), int(np.asarray(jinl).sum())
    assert abs(n - jn) <= COUNT_REL_TOL * jn, (n, jn)
    assert not inl.numpy()[~mask].any()
    pose, n_inl = tvo.solve_ransac(*args_t)
    jpose, jn_inl = jvo.solve_ransac(*args_j)
    assert int(n_inl) == n and int(jn_inl) == jn
    jpose, pose = np.asarray(jpose), pose.numpy()
    assert np.abs(rot_of(pose) - rot_of(jpose)).max() < ROT_TOL
    assert pose[4:] @ jpose[4:] > COS_MIN
    assert np.abs(rot_of(pose) - R).max() < ROT_TOL
    assert pose[4:] @ tr / np.linalg.norm(tr) > COS_MIN


# ---- the dead-code factors -------------------------------------------------------

def test_point_33_and_inverse_23_match_reference(rng):
    q = rng.normal(size=4)
    pose = f32(np.concatenate([q / np.linalg.norm(q), rng.normal(size=3)]))
    X0, X1 = f32(rng.normal(size=(64, 3)) * 5), f32(rng.normal(size=(64, 3)) * 5)
    xb0 = f32(rng.normal(size=(64, 2)) * 0.3)
    for tf_, jf, a, b in ((tvf.point_33_residual, jvf.point_33_residual, X0, X1),
                          (tvf.inverse_23_residual, jvf.inverse_23_residual, xb0, X1)):
        got = tf_(torch.tensor(pose), torch.tensor(a), torch.tensor(b)).numpy()
        want = np.asarray(jf(jnp.array(pose), jnp.array(a), jnp.array(b)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
