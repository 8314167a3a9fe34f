"""The port's plain lidar GN solve (the CUDA GN kernel's plain version)
against the JAX reference: the jacfwd ``solve_pose_gn`` on the CPU path,
and the Pallas GN kernel in interpret mode.

Same problem and bounds as tests/test_pallas_gn.py: translation atol 2e-3
and |q.q'| > 1 - 1e-5 (same math, different op order and analytic vs
forward-mode Jacobians).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vloam_tpu import geometry as geo
from vloam_tpu.ops import lidar_factors
from vloam_tpu.ops.gauss_newton import solve_pose_gn
from vloam_tpu.ops.pallas_gn import solve_pose_gn_lidar
from vloam_tpu_torch.ops import fused_gn

ITERS, HUBER, LM = 4, 0.1, 1e-4


def _problem(rng, be=1024, bs=2048, noise=0.01):
    """Random rigid registration: points on lines/planes observed from a
    perturbed pose (tests/test_pallas_gn.py:25-56)."""
    aa = rng.normal(0, 0.02, 3)
    t_true = rng.normal(0, 0.3, 3)
    pose_true = geo.pose_from_qt(
        geo.angle_axis_to_quat(jnp.array(aa, jnp.float32)), jnp.array(t_true, jnp.float32))
    a = rng.uniform(-20, 20, (be, 3)).astype(np.float32)
    u = rng.normal(0, 1, (be, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    s = rng.uniform(-0.5, 0.5, (be, 1)).astype(np.float32)
    pts_w = a + s * u + rng.normal(0, noise, (be, 3)).astype(np.float32)
    inv = geo.pose_inverse(pose_true)
    ep = np.asarray(geo.pose_apply(inv, jnp.array(pts_w)))
    ea, eb = a + 0.1 * u, a - 0.1 * u
    ev = rng.random(be) < 0.9
    n = rng.normal(0, 1, (bs, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = rng.uniform(-5, 5, bs).astype(np.float32)
    q0 = rng.uniform(-20, 20, (bs, 3)).astype(np.float32)
    pw = q0 - (np.sum(n * q0, -1) + d)[:, None] * n
    pw += rng.normal(0, noise, (bs, 3)).astype(np.float32)
    ppl = np.asarray(geo.pose_apply(inv, jnp.array(pw)))
    pv = rng.random(bs) < 0.9
    return np.asarray(pose_true), (ep, ea, eb, ev), (ppl, n, d, pv)


def _jax_solve(pose0, edge, plane):
    ep, ea, eb, ev = (jnp.array(x) for x in edge)
    pp, pn, pd, pv = (jnp.array(x) for x in plane)

    def residuals(p):
        return ((lidar_factors.edge_residual(p, ep, ea, eb), ev),
                (lidar_factors.plane_residual(p, pp, pn, pd), pv))

    return np.asarray(solve_pose_gn(residuals, jnp.array(pose0), ITERS, HUBER, LM))


def _pallas_solve(pose0, edge, plane):
    with pltpu.force_tpu_interpret_mode():
        out = solve_pose_gn_lidar(jnp.array(pose0), tuple(jnp.array(x) for x in edge),
                                  tuple(jnp.array(x) for x in plane), ITERS, HUBER, LM,
                                  _force_tpu_path=True)
    return np.asarray(out)


def _port_solve(pose0, edge, plane, plain=False):
    t = lambda xs: tuple(torch.tensor(np.asarray(x)) for x in xs)  # noqa: E731
    fn = fused_gn.solve_pose_gn_lidar_reference if plain else fused_gn.solve_pose_gn_lidar
    return fn(torch.tensor(np.asarray(pose0)), t(edge), t(plane), ITERS, HUBER, LM).numpy()


def _assert_same_pose(got, want):
    np.testing.assert_allclose(got[4:], want[4:], atol=2e-3)
    assert abs(float(np.sum(got[:4] * want[:4]))) > 1.0 - 1e-5, (got, want)


@pytest.mark.parametrize("trial", range(3))
def test_plain_matches_jax_cpu_path(trial):
    rng = np.random.default_rng(100 + trial)
    _, edge, plane = _problem(rng)
    pose0 = np.asarray(geo.pose_identity())
    _assert_same_pose(_port_solve(pose0, edge, plane, plain=True), _jax_solve(pose0, edge, plane))


@pytest.mark.parametrize("be,bs", [(1024, 2048), (768, 1536)])
def test_plain_matches_pallas_interpret(be, bs, rng):
    _, edge, plane = _problem(rng, be=be, bs=bs)
    pose0 = np.asarray(geo.pose_identity())
    _assert_same_pose(_port_solve(pose0, edge, plane), _pallas_solve(pose0, edge, plane))


def test_wrapper_on_cpu_is_the_plain_version(rng):
    _, edge, plane = _problem(rng, be=256, bs=512)
    pose0 = np.asarray(geo.pose_identity())
    np.testing.assert_array_equal(_port_solve(pose0, edge, plane),
                                  _port_solve(pose0, edge, plane, plain=True))
    assert fused_gn.LAUNCHES == 0


def test_converges_to_truth(rng):
    pose_true, edge, plane = _problem(rng, noise=0.002)
    got = _port_solve(np.asarray(geo.pose_identity()), edge, plane)
    np.testing.assert_allclose(got[4:], pose_true[4:], atol=0.02)
    assert abs(float(np.sum(got[:4] * pose_true[:4]))) > 1.0 - 1e-4


def test_all_invalid_keeps_pose(rng):
    _, edge, plane = _problem(rng)
    edge = edge[:3] + (np.zeros_like(edge[3]),)
    plane = plane[:3] + (np.zeros_like(plane[3]),)
    pose0 = np.asarray(geo.pose_from_qt(
        geo.angle_axis_to_quat(jnp.array([0.01, 0.02, -0.01])), jnp.array([1.0, -2.0, 0.5])))
    got = _port_solve(pose0, edge, plane)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, pose0, atol=1e-3)
    _assert_same_pose(got, _jax_solve(pose0, edge, plane))
