"""The port's pose graph (``vloam_tpu_torch.parallel.pose_graph``) against
the JAX package's, on the CPU (the JAX side compiled, as its own tests run).

* ``geometry.quat_to_angle_axis`` on random rotations and on rotations
  below and at the small-angle branch: within 1e-6.
* ``_eval_factors``: residuals and Jacobians (12 columns a factor) at a
  perturbed graph and at a converged one (residuals ~0, the small-angle
  branch of quat_to_angle_axis): within 1e-5, and finite.
* ``optimize_pose_graph`` and ``optimize_pose_graph_banded`` on the drifted
  square of tests/test_pose_graph.py with loop factors: within 1e-4 m and
  1e-4 in each quaternion component of their JAX twins.
* Inside the port, banded against dense as ``test_banded_matches_dense``
  holds the reference (5e-4), with and without loop factors and with an
  empty loop set.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pose_graph import _make_square
from vloam_tpu import geometry as jgeo
from vloam_tpu.parallel import pose_graph as jpg
from vloam_tpu_torch import geometry as tgeo
from vloam_tpu_torch.parallel import pose_graph as tpg
from vloam_tpu_torch.parallel.loop_closure import loop_factors

POSE_T_TOL = 1e-4   # m
POSE_Q_TOL = 1e-4   # per quaternion component (~rad / 2)
EVAL_TOL = 1e-5


def to_torch(f) -> tpg.PoseGraphFactors:
    return tpg.PoseGraphFactors(*[torch.tensor(np.asarray(x)) for x in f])


@pytest.fixture(scope="module")
def square():
    """(initial poses, chain factors, loop factors), JAX arrays: the drifted
    square, two odometry chains and two loop factors."""
    gt, deltas_gt, noisy = _make_square()
    W = gt.shape[0]
    poses = [jgeo.pose_identity()]
    for d in noisy:
        poses.append(jgeo.pose_compose(poses[-1], d))
    chain = jpg.concat_factors(jpg.odometry_factors(noisy, weight=1.0),
                               jpg.odometry_factors(deltas_gt, weight=0.2))
    loop = jpg.PoseGraphFactors(
        i=jnp.array([0, 3], jnp.int32), j=jnp.array([W - 1, W - 5], jnp.int32),
        z=jnp.stack([jgeo.pose_compose(jgeo.pose_inverse(gt[0]), gt[W - 1]),
                     jgeo.pose_compose(jgeo.pose_inverse(gt[3]), gt[W - 5])]),
        weight=jnp.array([10.0, 4.0], jnp.float32), valid=jnp.ones(2, bool))
    return jnp.stack(poses), chain, loop


def assert_poses_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:, 4:], want[:, 4:], atol=POSE_T_TOL, rtol=0)
    sign = np.sign(np.sum(got[:, :4] * want[:, :4], axis=1, keepdims=True))
    np.testing.assert_allclose(got[:, :4] * sign, want[:, :4], atol=POSE_Q_TOL, rtol=0)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e-7, 1e-9, 0.0])
def test_quat_to_angle_axis_matches_reference(scale, rng):
    aa = rng.normal(0, 1.0, (64, 3)).astype(np.float32) * np.float32(scale)
    q = np.array(jgeo.angle_axis_to_quat(jnp.array(aa)))
    q[::2] *= -1.0   # the other hemisphere
    want = np.asarray(jgeo.quat_to_angle_axis(jnp.array(q)))
    got = tgeo.quat_to_angle_axis(torch.tensor(q)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("where", ["perturbed", "converged"])
def test_eval_factors_match_reference(square, where):
    poses, chain, loop = square
    factors = jpg.concat_factors(chain, loop)
    if where == "converged":
        poses = jpg.optimize_pose_graph(poses, factors, iters=8)
        # a factor whose measurement is exactly the graph's relative pose
        extra = jpg.PoseGraphFactors(
            i=jnp.array([2], jnp.int32), j=jnp.array([3], jnp.int32),
            z=jgeo.pose_compose(jgeo.pose_inverse(poses[2]), poses[3])[None],
            weight=jnp.ones(1, jnp.float32), valid=jnp.ones(1, bool))
        factors = jpg.concat_factors(factors, extra)
    Jw, rw = jax.jit(jpg._eval_factors, static_argnums=2)(poses, factors, 0.5)
    Jt, rt = tpg._eval_factors(torch.tensor(np.asarray(poses)), to_torch(factors), 0.5)
    assert Jt.dtype == torch.float32 and torch.isfinite(Jt).all() and torch.isfinite(rt).all()
    np.testing.assert_allclose(rt.numpy(), np.asarray(rw), atol=EVAL_TOL, rtol=0)
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jw), atol=EVAL_TOL, rtol=0)
    if where == "converged":   # the exact factor sits at (or next to) the small-angle branch
        assert float(np.abs(np.asarray(rw)[-1]).max()) < 1e-6


def test_dense_matches_reference(square):
    poses, chain, loop = square
    factors = jpg.concat_factors(chain, loop)
    want = jpg.optimize_pose_graph(poses, factors, iters=6)
    got = tpg.optimize_pose_graph(torch.tensor(np.asarray(poses)), to_torch(factors), iters=6)
    assert_poses_close(got, want)


@pytest.mark.parametrize("with_loop", [True, False])
def test_banded_matches_reference(square, with_loop):
    poses, chain, loop = square
    want = jpg.optimize_pose_graph_banded(poses, chain, loop if with_loop else None, iters=6)
    got = tpg.optimize_pose_graph_banded(torch.tensor(np.asarray(poses)), to_torch(chain),
                                         to_torch(loop) if with_loop else None, iters=6)
    assert_poses_close(got, want)


def test_banded_matches_dense_in_the_port(square):
    poses, chain, loop = (to_torch(x) if not hasattr(x, "shape") else torch.tensor(np.asarray(x))
                          for x in square)
    dense = tpg.optimize_pose_graph(poses, tpg.concat_factors(chain, loop), iters=6)
    banded = tpg.optimize_pose_graph_banded(poses, chain, loop, iters=6)
    np.testing.assert_allclose(banded.numpy(), dense.numpy(), atol=5e-4, rtol=0)
    dense_nl = tpg.optimize_pose_graph(poses, chain, iters=4)
    banded_nl = tpg.optimize_pose_graph_banded(poses, chain, None, iters=4)
    np.testing.assert_allclose(banded_nl.numpy(), dense_nl.numpy(), atol=5e-4, rtol=0)
    empty = tpg.optimize_pose_graph_banded(poses, chain, loop_factors([], []), iters=4)
    np.testing.assert_allclose(empty.numpy(), dense_nl.numpy(), atol=5e-4, rtol=0)


def test_loop_closure_reduces_drift(square):
    """The reference's own check (tests/test_pose_graph.py) on the port: one
    loop factor pulls the drifted square's end back to within 15 % of its
    error."""
    gt, _, noisy = _make_square()
    poses = torch.tensor(np.asarray(square[0]))
    W = poses.shape[0]
    gt = torch.tensor(np.asarray(gt))
    loop = tpg.PoseGraphFactors(
        i=torch.tensor([0]), j=torch.tensor([W - 1]),
        z=tgeo.pose_compose(tgeo.pose_inverse(gt[0]), gt[W - 1])[None],
        weight=torch.tensor([10.0]), valid=torch.ones(1, dtype=torch.bool))
    odo = tpg.odometry_factors(torch.tensor(np.asarray(noisy)))
    opt = tpg.optimize_pose_graph(poses, tpg.concat_factors(odo, loop), iters=8)
    before = float(torch.linalg.vector_norm(poses[-1, 4:] - gt[-1, 4:]))
    after = float(torch.linalg.vector_norm(opt[-1, 4:] - gt[-1, 4:]))
    assert after < 0.15 * before and torch.isfinite(opt).all()


@pytest.mark.parametrize("S", [2])
def test_sharded_factors_match_single_device(S, tmp_path):
    """The reference's sharded-factors check (tests/test_pose_graph.py) on
    the port: the drifted square's odometry factors split over S gloo ranks
    (padded with invalid factors, which weigh 0), JtJ and Jtr summed over the ranks, within
    2e-4 of the unsharded solve on every rank."""
    import torch_shard_ranks as ranks

    _, _, noisy = _make_square()
    poses = [tgeo.pose_identity()]
    for d in torch.tensor(np.asarray(noisy)):
        poses.append(tgeo.pose_compose(poses[-1], d))
    poses = torch.stack(poses)
    factors = tpg.odometry_factors(torch.tensor(np.asarray(noisy)))
    single = tpg.optimize_pose_graph(poses, factors, iters=4)
    F = factors.i.shape[0]
    n = F // S + 1                     # S invalid factors pad the last block
    pad = n * S - F

    def padded(x):
        return torch.cat([x, torch.zeros((pad,) + x.shape[1:], dtype=x.dtype)])

    full = tpg.PoseGraphFactors(*(padded(x) for x in factors))
    assert pad >= S and not bool(full.valid[F:].any())
    blocks = [tpg.PoseGraphFactors(*(x[r * n:(r + 1) * n] for x in full)) for r in range(S)]
    got = ranks.run_job(tmp_path, "pose_graph", S, dict(poses=poses, factors=blocks, iters=4))
    for r in got:
        np.testing.assert_allclose(r.numpy(), single.numpy(), atol=2e-4, rtol=0)
