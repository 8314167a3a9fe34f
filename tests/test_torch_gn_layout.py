"""How the GN kernels B3 and B4 take their inputs, checked on the CPU.

The wrappers ``fused_gn.solve_pose_gn_lidar`` / ``solve_pose_gn_vo`` hand the
kernels the factor arrays exactly as the call sites make them; the checks
and the row strides come from ``fused_gn.lidar_layout`` / ``vo_layout``,
which these tests call on CPU and ``meta`` tensors:

* the real call sites' layouts (the (B, 4)[:, :3] point views, bool masks)
  pass, and so do non-contiguous (B,) arrays;
* float64, a last dim whose stride is not 1, a float mask, mismatched
  lengths and mixed devices raise ValueError;
* the plain solves (what the kernels are held to on the card) give the same
  pose on strided views as on contiguous copies, and agree with the JAX
  ``solve_pose_gn_lidar`` / ``solve_pose_gn_vo`` on the CPU path within the
  bounds of tests/test_torch_gn.py (lidar translation 2e-3, VO 5e-3,
  |q.q'| > 1 - 1e-5);
* a row behind a cleared mask with finite values moves neither the plain
  nor the JAX result, and one with a NaN makes the plain result NaN (the
  kernels keep only the rows whose mask is set, and add 0 * the values of
  the others to their sums for that reason).
"""

import collections
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vloam_tpu import geometry as jgeo
from vloam_tpu.ops.pallas_gn import solve_pose_gn_lidar as jax_lidar
from vloam_tpu.ops.pallas_gn import solve_pose_gn_vo as jax_vo
from vloam_tpu_torch.ops import fused_gn

ITERS, VO_ITERS, HUBER, LM = 4, 10, 0.1, 1e-4
F32, F64 = torch.float32, torch.float64

jax_lidar_jit = jax.jit(jax_lidar, static_argnames=("iters", "huber_delta", "lm_lambda"))
jax_vo_jit = jax.jit(jax_vo, static_argnames=("iters", "huber_delta", "lm_lambda"))


def _lidar_problem(rng, be=256, bs=512, noise=0.01):
    """Points on lines and planes seen from a perturbed pose (the problem of
    tests/test_torch_gn.py at a smaller size), as NumPy."""
    pose_true = np.asarray(jgeo.pose_from_qt(
        jgeo.angle_axis_to_quat(jnp.array(rng.normal(0, 0.02, 3), jnp.float32)),
        jnp.array(rng.normal(0, 0.3, 3), jnp.float32)))
    inv = jgeo.pose_inverse(jnp.array(pose_true))
    a = rng.uniform(-20, 20, (be, 3)).astype(np.float32)
    u = rng.normal(0, 1, (be, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    on_line = a + rng.uniform(-0.5, 0.5, (be, 1)) * u + rng.normal(0, noise, (be, 3))
    ep = np.asarray(jgeo.pose_apply(inv, jnp.array(on_line, jnp.float32)))
    n = rng.normal(0, 1, (bs, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = rng.uniform(-5, 5, bs).astype(np.float32)
    q0 = rng.uniform(-20, 20, (bs, 3))
    on_plane = q0 - (np.sum(n * q0, -1) + d)[:, None] * n + rng.normal(0, noise, (bs, 3))
    pp = np.asarray(jgeo.pose_apply(inv, jnp.array(on_plane, jnp.float32)))
    edge = (ep, (a + 0.1 * u).astype(np.float32), (a - 0.1 * u).astype(np.float32),
            rng.random(be) < 0.9)
    return edge, (pp, n, d, rng.random(bs) < 0.9)


def _vo_problem(rng, m=256, noise=0.001):
    """Two cameras a small known motion apart, 60 % of the matches with depth."""
    pose_true = jgeo.pose_from_qt(
        jgeo.angle_axis_to_quat(jnp.array(rng.normal(0, 0.02, 3), jnp.float32)),
        jnp.array(np.array([0.1, -0.05, 0.8]) + rng.normal(0, 0.05, 3), jnp.float32))
    X0 = np.stack([rng.uniform(-10, 10, m), rng.uniform(-3, 3, m), rng.uniform(5, 40, m)],
                  -1).astype(np.float32)
    X1 = np.asarray(jgeo.pose_apply(pose_true, jnp.array(X0)))
    xb0 = (X0[:, :2] / X0[:, 2:3] + rng.normal(0, noise, (m, 2))).astype(np.float32)
    xb1 = (X1[:, :2] / X1[:, 2:3] + rng.normal(0, noise, (m, 2))).astype(np.float32)
    hd = rng.random(m) < 0.6
    return X0, xb0, xb1, hd, ~hd


def _view(x, device="cpu"):
    """x as the call sites pass it: a (B, w) array as the first w columns of
    a (B, 4) buffer, a (B,) array as a column of a (B, 2) one."""
    x = torch.as_tensor(np.array(x), device=device)
    if x.dim() == 2:
        buf = torch.zeros((x.shape[0], 4), dtype=x.dtype, device=device)
        buf[:, :x.shape[1]] = x
        return buf[:, :x.shape[1]]
    buf = torch.zeros((x.shape[0], 2), dtype=x.dtype, device=device)
    buf[:, 1] = x
    return buf[:, 1]


def _identity(device="cpu"):
    return torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0], device=device)


def _lidar_args(edge, plane, make=torch.as_tensor, device="cpu"):
    return (_identity(device), tuple(make(np.array(x), device=device) for x in edge),
            tuple(make(np.array(x), device=device) for x in plane))


def _assert_same_pose(got, want, t_tol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[4:], want[4:], atol=t_tol)
    assert abs(float(np.sum(got[:4] * want[:4]))) > 1.0 - 1e-5, (got, want)


# ---------------------------------------------------------------------------
# the layout helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_layout_takes_the_call_site_views(rng, device):
    edge, plane = _lidar_problem(rng, be=40, bs=70)
    arrays, strides, be, bs = fused_gn.lidar_layout(*_lidar_args(edge, plane, _view, device))
    assert (be, bs) == (40, 70)
    # pose0, ep, ea, eb, ev (a column of (B, 2)), pp, pn, pd, pv
    assert strides == [1, 4, 4, 4, 2, 4, 4, 2, 2]
    assert len(arrays) == 9 and arrays[4].dtype == torch.bool
    vo = _vo_problem(rng, m=30)
    arrays, strides, m = fused_gn.vo_layout(_identity(device), *(_view(x, device) for x in vo))
    assert m == 30 and strides == [1, 4, 4, 4, 2, 2]
    arrays, strides, m = fused_gn.vo_layout(
        _identity(device), *(torch.as_tensor(x, device=device) for x in vo))
    assert strides == [1, 3, 2, 2, 1, 1]


def _faults():
    """(name, which argument, replacement) for each fault the helpers refuse."""
    return [
        ("f64 points", "ep", lambda x: x.to(F64)),
        ("f64 pose", "pose", lambda x: x.to(F64)),
        ("f64 plane offset", "pd", lambda x: x.to(F64)),
        ("last dim strided", "pn", lambda x: torch.zeros((x.shape[0], 6), dtype=x.dtype,
                                                          device=x.device)[:, ::2]),
        ("float mask", "ev", lambda x: x.to(F32)),
        ("short edge mask", "ev", lambda x: x[:-1]),
        ("short plane offset", "pd", lambda x: x[1:]),
        ("long a", "ea", lambda x: torch.cat([x, x[:1]])),
        ("pose of 8", "pose", lambda x: torch.cat([x, x[:1]])),
    ]


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("fault", range(len(_faults())))
def test_lidar_layout_refuses(rng, device, fault):
    name, which, bad = _faults()[fault]
    edge, plane = _lidar_problem(rng, be=24, bs=40)
    pose, edge, plane = _lidar_args(edge, plane, torch.as_tensor, device)
    args = dict(zip(("ep", "ea", "eb", "ev"), edge)) | dict(zip(("pp", "pn", "pd", "pv"), plane))
    args["pose"] = pose
    args[which] = bad(args[which])
    with pytest.raises(ValueError):
        fused_gn.lidar_layout(args["pose"], (args["ep"], args["ea"], args["eb"], args["ev"]),
                              (args["pp"], args["pn"], args["pd"], args["pv"]))


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("fault", ["f64 X0", "strided xb1", "float mask", "short xb0",
                                   "short mask", "wide X0"])
def test_vo_layout_refuses(rng, device, fault):
    X0, xb0, xb1, hd, nd = (torch.as_tensor(x, device=device) for x in _vo_problem(rng, m=20))
    if fault == "f64 X0":
        X0 = X0.to(F64)
    elif fault == "strided xb1":
        xb1 = torch.zeros((20, 4), device=device)[:, ::2]
    elif fault == "float mask":
        hd = hd.to(F32)
    elif fault == "short xb0":
        xb0 = xb0[:-1]
    elif fault == "short mask":
        nd = nd[:-1]
    else:
        X0 = torch.zeros((20, 4), device=device)
    with pytest.raises(ValueError):
        fused_gn.vo_layout(_identity(device), X0, xb0, xb1, hd, nd)


def test_layout_refuses_mixed_devices(rng):
    edge, plane = _lidar_problem(rng, be=8, bs=8)
    pose, edge, plane = _lidar_args(edge, plane)
    with pytest.raises(ValueError):
        fused_gn.lidar_layout(pose, edge, (*plane[:3], plane[3].to("meta")))
    X0, xb0, xb1, hd, nd = (torch.as_tensor(x) for x in _vo_problem(rng, m=8))
    with pytest.raises(ValueError):
        fused_gn.vo_layout(_identity("meta"), X0, xb0, xb1, hd, nd)


def test_call_sites_pass_the_layout_helpers():
    """Two frames of the full step at a small config on the CPU: every LO, MO
    and VO solve's arguments are what the kernels take, with the points as
    (B, 4)[:, :3] views."""
    from vloam_tpu_torch import config as tconfig
    from vloam_tpu_torch.data import stream
    from vloam_tpu_torch.models import frame_graph, laser_mapping, lidar_odometry, visual_odometry
    from vloam_tpu_torch.models.vloam import frame_to_device, init_vloam_state, vloam_step

    cfg = tconfig.kitti_hdl64().replace(
        scan=tconfig.ScanConfig(ring_cap=512, max_points=32768, less_flat_cap=8192),
        mapping=tconfig.MappingConfig(grid_w=7, grid_h=7, grid_d=3, corner_cube_cap=1024,
                                      surf_cube_cap=2048, corner_stack_cap=2048,
                                      surf_stack_cap=4096, submap_corner_cap=4096,
                                      submap_surf_cap=8192))
    ext = frame_graph.kitti_default_extrinsics("cpu")
    frames, _ = stream.gen_frames(cfg, ext, 2, n_azimuth=700)
    calls = collections.defaultdict(list)

    def recorder(site, fn):
        def record(*args):
            calls[site].append(args)
            return fn(*args)
        return record

    state = init_vloam_state(cfg, "cpu")
    with mock.patch.object(lidar_odometry, "solve_pose_gn_lidar",
                           recorder("LO", fused_gn.solve_pose_gn_lidar)), \
            mock.patch.object(laser_mapping, "solve_pose_gn_lidar",
                              recorder("MO", fused_gn.solve_pose_gn_lidar)), \
            mock.patch.object(visual_odometry, "solve_pose_gn_vo",
                              recorder("VO", fused_gn.solve_pose_gn_vo)):
        for f in frames:
            img, grid, gmask, bk, lf = frame_to_device(*f, "cpu")
            state, _ = vloam_step(state, img, grid, gmask, ext, cfg, pre_gridded=True,
                                  pre_buckets=bk, pre_lf_table=lf)
    assert len(calls["LO"]) == len(calls["MO"]) == 2 and len(calls["VO"]) == 2
    for site in ("LO", "MO"):
        for args in calls[site]:
            _, strides, be, bs = fused_gn.lidar_layout(*args[:3])
            assert strides[1] == strides[5] == 4, (site, strides)  # the (B, 4) point buffers
    for args in calls["VO"]:
        fused_gn.vo_layout(*args[:6])


# ---------------------------------------------------------------------------
# the plain solves on the kernels' layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trial", range(2))
def test_lidar_plain_on_views_equals_copies_and_jax(trial):
    edge, plane = _lidar_problem(np.random.default_rng(300 + trial))
    views = fused_gn.solve_pose_gn_lidar_reference(*_lidar_args(edge, plane, _view), ITERS, HUBER,
                                                   LM)
    copies = fused_gn.solve_pose_gn_lidar_reference(*_lidar_args(edge, plane), ITERS, HUBER, LM)
    assert torch.equal(views, copies)
    want = jax_lidar_jit(jnp.array(_identity().numpy()), tuple(jnp.array(x) for x in edge),
                         tuple(jnp.array(x) for x in plane), iters=ITERS, huber_delta=HUBER,
                         lm_lambda=LM)
    _assert_same_pose(views.numpy(), want, 2e-3)


@pytest.mark.parametrize("trial", range(2))
def test_vo_plain_on_views_equals_copies_and_jax(trial):
    prob = _vo_problem(np.random.default_rng(400 + trial))
    views = fused_gn.solve_pose_gn_vo_reference(_identity(), *(_view(x) for x in prob), VO_ITERS,
                                                HUBER, LM)
    copies = fused_gn.solve_pose_gn_vo_reference(_identity(), *(torch.as_tensor(x) for x in prob),
                                                 VO_ITERS, HUBER, LM)
    assert torch.equal(views, copies)
    want = jax_vo_jit(jnp.array(_identity().numpy()), *(jnp.array(x) for x in prob),
                      iters=VO_ITERS, huber_delta=HUBER, lm_lambda=LM)
    _assert_same_pose(views.numpy(), want, 5e-3)


def _with_dropped_row(x, value, mask=False):
    """x with one more row: ``value`` everywhere (``mask`` for a bool array)."""
    x = np.asarray(x)
    extra = np.full((1,) + x.shape[1:], mask if x.dtype == bool else value, dtype=x.dtype)
    return np.concatenate([x, extra])


@pytest.mark.parametrize("kind", ["lidar", "vo"])
def test_masked_rows_move_nothing(rng, kind):
    """Finite values behind a cleared mask leave the plain and the JAX pose
    as they were; a NaN there makes the plain pose NaN."""
    if kind == "lidar":
        edge, plane = _lidar_problem(rng)

        def solve(edge, plane):
            return fused_gn.solve_pose_gn_lidar_reference(*_lidar_args(edge, plane), ITERS,
                                                          HUBER, LM)

        def solve_jax(edge, plane):
            return jax_lidar_jit(jnp.array(_identity().numpy()), tuple(map(jnp.array, edge)),
                                 tuple(map(jnp.array, plane)), iters=ITERS, huber_delta=HUBER,
                                 lm_lambda=LM)

        base, base_jax = solve(edge, plane), solve_jax(edge, plane)
        grown = [(tuple(_with_dropped_row(x, v) for x in edge),
                  tuple(_with_dropped_row(x, v) for x in plane)) for v in (7.5, np.nan)]
        finite, nan = solve(*grown[0]), solve(*grown[1])
        finite_jax = solve_jax(*grown[0])
    else:
        prob = _vo_problem(rng)

        def solve(prob):
            return fused_gn.solve_pose_gn_vo_reference(
                _identity(), *(torch.as_tensor(x) for x in prob), VO_ITERS, HUBER, LM)

        def solve_jax(prob):
            return jax_vo_jit(jnp.array(_identity().numpy()), *map(jnp.array, prob),
                              iters=VO_ITERS, huber_delta=HUBER, lm_lambda=LM)

        base, base_jax = solve(prob), solve_jax(prob)
        finite = solve(tuple(_with_dropped_row(x, 7.5) for x in prob))
        nan = solve(tuple(_with_dropped_row(x, np.nan) for x in prob))
        finite_jax = solve_jax(tuple(_with_dropped_row(x, 7.5) for x in prob))
    np.testing.assert_allclose(finite.numpy(), base.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.asarray(finite_jax), np.asarray(base_jax), atol=1e-6, rtol=0)
    assert bool(torch.isnan(nan).all()), nan
