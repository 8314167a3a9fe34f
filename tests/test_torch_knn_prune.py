"""The port's radius-clamped k-NN and the Morton order that makes its tile
pruning pay, on the CPU (plain versions), against the JAX package.

* ``morton_keys`` / ``morton_sort``: keys and row order equal to the JAX
  functions exactly.
* The radius rule (``ops/knn.clamp_radius``): the pruned plain version equals
  the unpruned one wherever d2 <= float32(r)^2 and is +inf / index 0
  elsewhere, on Morton-ordered and on shuffled rows and on every problem of
  ``tools/knn_check.cases`` (the problems the GPU run holds the kernels to).
* Against the Pallas pair kernel with ``prune_radius`` in interpret mode, on
  the inputs of ``tests/test_pallas_knn.py``'s pruned tests: every finite pair
  the kernel reports within the gate is in the port's result with d2 within
  2e-3 m^2 (the kernel floor-rounds d2 by < 2^-14 relative), or the port
  holds k nearer ones (the kernel is approximate, the port exact); a query
  block far from every candidate is all +inf.
* ``mapping_step`` with the Morton-ordered association and the radius
  against the JAX ``mapping_step`` on the same feature clouds: poses within
  the slice's 4 mm / 1e-3 rad, map counts within 0.5 %.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vloam_tpu.config import MappingConfig, ScanConfig, kitti_hdl64
from vloam_tpu.models import laser_mapping as jmap
from vloam_tpu.ops import knn as jknn
from vloam_tpu.ops.pallas_knn import knn_lanemin_pair
from vloam_tpu_torch import config as tconfig
from vloam_tpu_torch.data import gridding, synthetic
from vloam_tpu_torch.models import laser_mapping as tmap
from vloam_tpu_torch.models.lidar_odometry import init_lo_state, lo_step
from vloam_tpu_torch.ops import fused_knn
from vloam_tpu_torch.ops import knn as tknn
from vloam_tpu_torch.ops.scan_registration import extract_features_from_grid
from vloam_tpu_torch.tools import knn_check

K = 5
D2_TOL = 2e-3
CASES = knn_check.cases()


# ---- Morton order -----------------------------------------------------------

MORTON = {
    "stack": dict(n=3000, spread=60.0, cell=2.0, origin=None, p_mask=0.8),
    "submap": dict(n=5000, spread=80.0, cell=4.0, origin=(150.0, -50.0, 0.0), p_mask=0.7),
    "clipped": dict(n=2000, spread=5000.0, cell=2.0, origin=(1.0, 2.0, 3.0), p_mask=0.9),
    "lattice": dict(n=4096, spread=None, cell=4.0, origin=(-8.0, 8.0, 0.0), p_mask=0.5),
}


def _morton_inputs(name, rng):
    c = MORTON[name]
    if c["spread"] is None:      # points on cell boundaries, many equal keys
        pts = (rng.integers(-6, 7, (c["n"], 3)) * 4.0).astype(np.float32)
    else:
        pts = rng.uniform(-c["spread"], c["spread"], (c["n"], 3)).astype(np.float32)
    pts = np.concatenate([pts, rng.random((c["n"], 1)).astype(np.float32)], axis=1)
    mask = rng.random(c["n"]) < c["p_mask"]
    origin = 0.0 if c["origin"] is None else np.asarray(c["origin"], np.float32)[None, :]
    return pts, mask, c["cell"], origin


@pytest.mark.parametrize("name", list(MORTON))
def test_morton_keys_equal_reference(name, rng):
    pts, _, cell, origin = _morton_inputs(name, rng)
    want = np.asarray(jknn.morton_keys(jnp.array(pts), cell, jnp.asarray(origin)))
    t_origin = origin if isinstance(origin, float) else torch.tensor(origin)
    got = tknn.morton_keys(torch.tensor(pts), cell, t_origin)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(MORTON))
def test_morton_sort_equals_reference(name, rng):
    pts, mask, cell, origin = _morton_inputs(name, rng)
    want_p, want_m = jknn.morton_sort(jnp.array(pts), jnp.array(mask), cell, jnp.asarray(origin))
    t_origin = origin if isinstance(origin, float) else torch.tensor(origin)
    got_p, got_m = tknn.morton_sort(torch.tensor(pts), torch.tensor(mask), cell, t_origin)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))   # the same stable order
    n = int(mask.sum())
    assert got_m[:n].all() and not got_m[n:].any()                     # a prefix mask
    order = tknn.morton_order(torch.tensor(pts), torch.tensor(mask), cell, t_origin)
    np.testing.assert_array_equal(torch.argsort(order)[order].numpy(), np.arange(len(pts)))


# ---- the radius rule --------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_cases_hold_on_the_plain_version(case):
    """Every problem the GPU run checks the kernels on: the wrapper on the
    CPU is the plain version, the single-problem search equals its group,
    and the radius rule holds."""
    knn_check.check_case(case, "cpu")
    assert fused_knn.LAUNCHES == 0 and tknn.LAUNCHES == 0


def _street(rng, m, n, sort):
    q = (rng.uniform(0, 1, (m, 1)) * np.array([80, 4, 2])).astype(np.float32)
    q += rng.normal(0, 1.0, (m, 3)).astype(np.float32)
    c = (rng.uniform(0, 1, (n, 1)) * np.array([80, 4, 2])).astype(np.float32)
    c += rng.normal(0, 1.2, (n, 3)).astype(np.float32)
    mask = rng.random(n) < 0.9
    q, c, mask = torch.tensor(q), torch.tensor(c), torch.tensor(mask)
    if sort:
        c, mask = tknn.morton_sort(c, mask, 2.0)
        q, _ = tknn.morton_sort(q, torch.ones(m, dtype=torch.bool), 2.0)
    return q, c, mask


@pytest.mark.parametrize("sort", [True, False], ids=["morton", "unsorted"])
@pytest.mark.parametrize("radius", [0.5, 1.001, 3.0])
def test_pruned_equals_unpruned_within_radius(sort, radius, rng):
    q, c, mask = _street(rng, 300, 4096, sort)
    args = (q, c, mask, K, q + 0.3, c, mask, K)
    counts = dict(a_counts=(torch.tensor(280), None), b_counts=(None, torch.tensor(3000)))
    free = fused_knn.knn_pair(*args, **counts)
    pruned = fused_knn.knn_pair(*args, **counts, prune_radius=(radius, radius))
    r2 = float(np.float32(radius) ** 2)
    assert tknn.radius_sq(radius) == r2
    for (fd, fi), (pd, pi) in zip(free, pruned):
        inside = fd <= r2
        assert bool(inside.any()) and (radius > 1.5 or not bool(inside.all()))
        assert torch.equal(pd[inside], fd[inside]) and torch.equal(pi[inside], fi[inside])
        assert torch.isinf(pd[~inside]).all() and (pi[~inside] == 0).all()
        assert not torch.isnan(pd).any()


def test_pruned_result_does_not_depend_on_the_row_order(rng):
    """The same problem on shuffled rows gives the same neighbours (by
    position) and the same distances, slot by slot."""
    q, c, mask = _street(rng, 256, 2048, sort=True)
    perm = torch.tensor(rng.permutation(2048))
    r = (1.001, 1.001)
    (d_s, i_s), _ = fused_knn.knn_pair(q, c, mask, K, q, c, mask, K, prune_radius=r)
    (d_u, i_u), _ = fused_knn.knn_pair(q, c[perm], mask[perm], K, q, c, mask, K, prune_radius=r)
    assert torch.equal(torch.isinf(d_s), torch.isinf(d_u))
    fin = torch.isfinite(d_s)
    # the rebase centre is the same box centre, so d2 is bit-equal; equal
    # distances may swap slots with the index order
    assert torch.equal(d_s, d_u)
    same = (c[i_s] == c[perm][i_u]).all(dim=-1)
    assert same[fin].float().mean() > 0.999


# ---- what the wrappers hand the kernels -------------------------------------

N_SM = 132   # an H100's multiprocessors
MAIN_PATH = {   # the frame step's knn_pair calls at kitti_hdl64: (m, n) per problem, pruned
    "lo": (((768, 7680), (1536, 32768)), False),
    "mo": (((4096, 16384), (8192, 49152)), True),
}


@pytest.mark.parametrize("site", list(MAIN_PATH))
def test_plan_fills_the_card_at_the_frame_steps_shapes(site):
    shapes, pruned = MAIN_PATH[site]
    blocks = 0
    for m, n in shapes:
        splits, step, pilot_splits = tknn.knn_plan(m, n, pruned=pruned)
        assert 1 <= splits <= n // tknn.MIN_SPLIT_ROWS
        blocks += -(-m // tknn.TILE_Q) * splits
        if pruned:
            assert step == 0 and splits == n // tknn.MIN_SPLIT_ROWS   # two tiles a split
        else:
            assert splits <= tknn.MAX_SPLITS and step == tknn.PILOT_STEP
            assert 1 <= pilot_splits <= max(1, -(-n // step) // tknn.MIN_SPLIT_ROWS)
    assert blocks >= N_SM


def test_plan_of_small_problems():
    assert tknn.knn_plan(64, 64) == (1, 0, 0)                 # one split, no pilot
    assert tknn.knn_plan(0, 0, pruned=True) == (1, 0, 0)
    assert tknn.knn_plan(1024, 8192)[1:] == (tknn.PILOT_STEP, 4)
    assert tknn.knn_plan(1024, 8192, pruned=True) == (16, 0, 0)


def test_count_and_row_arguments():
    assert tknn.count_arg(None, 7, "cpu") == (None, 7)
    assert tknn.count_arg(-2, 7, "cpu") == (None, 0) and tknn.count_arg(99, 7, "cpu") == (None, 7)
    t, host = tknn.count_arg(torch.tensor(5, dtype=torch.int32), 7, "cpu")
    assert t.dtype == torch.int64 and int(t) == 5 and host == 0   # the kernel clamps a tensor
    wide = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    x, stride = tknn.rows_arg(wide[:, :3])
    assert stride == 4 and x.data_ptr() == wide.data_ptr()        # a column slice passes as it is
    x, stride = tknn.rows_arg(wide[:, :3].to(torch.float64))      # another type is converted
    assert stride == 3 and x.dtype == torch.float32 and torch.equal(x, wide[:, :3])
    x, stride = tknn.rows_arg(wide.T[:3].T[:, [2, 0, 1]].T.T)         # so is another column stride
    assert x.stride(1) == 1 and stride >= 3
    x, stride = tknn.rows_arg(torch.zeros(3)[None, :].expand(5, 3))   # stride 0 rows are copied
    assert stride == 3 and x.is_contiguous()


# ---- against the Pallas kernel with prune_radius ----------------------------

def _pallas_pruned(qa, ca, ma, qb, cb, mb, r):
    with pltpu.force_tpu_interpret_mode():
        out = knn_lanemin_pair(jnp.array(qa), jnp.array(ca), jnp.array(ma), K,
                               jnp.array(qb), jnp.array(cb), jnp.array(mb), K,
                               prune_radius=(r, r), _force_tpu_path=True)
    return [(np.asarray(d), np.asarray(i)) for d, i in out]


def _port_pruned(qa, ca, ma, qb, cb, mb, r):
    t = torch.tensor
    out = fused_knn.knn_pair(t(qa), t(ca), t(ma), K, t(qb), t(cb), t(mb), K, prune_radius=(r, r))
    return [(d.numpy(), i.numpy()) for d, i in out]


def _assert_covers_kernel(port, kernel, gate):
    """Every finite pair the Pallas kernel reports within the gate is in the
    port's result, with d2 within D2_TOL, unless the port's k slots are all
    taken by nearer neighbours (the kernel keeps one neighbour per lane
    class, so its later slots may hold the true (k+1)-th or beyond)."""
    (pd, pi), (kd, ki) = port, kernel
    n_found = 0
    for row in range(len(kd)):
        for d, j in zip(kd[row], ki[row]):
            if np.isfinite(d) and d < gate:
                hit = np.flatnonzero((pi[row] == j) & np.isfinite(pd[row]))
                if hit.size:
                    assert abs(pd[row][hit[0]] - d) <= D2_TOL
                    n_found += 1
                else:
                    assert pd[row][-1] <= d + D2_TOL, (row, j, d, pd[row], pi[row])
    assert n_found > len(kd)      # the test saw real neighbours


def test_covers_pallas_pruned_kernel_within_radius(rng):
    """tests/test_pallas_knn.py::test_pair_pruned_matches_within_radius."""
    M, N, R = 256, 4096, 1.0
    qa = (rng.uniform(0, 1, (M, 1)) * np.array([80, 4, 2])).astype(np.float32)
    qa += rng.normal(0, 1.0, (M, 3)).astype(np.float32)
    ca = (rng.uniform(0, 1, (N, 1)) * np.array([80, 4, 2])).astype(np.float32)
    ca += rng.normal(0, 1.2, (N, 3)).astype(np.float32)
    ma = rng.random(N) < 0.9
    ca_s, ma_s = jknn.morton_sort(jnp.array(ca), jnp.array(ma), cell=2.0)
    qa_s, _ = jknn.morton_sort(jnp.array(qa), jnp.ones(M, bool), cell=2.0)
    qa_s, ca_s, ma_s = np.asarray(qa_s), np.asarray(ca_s), np.asarray(ma_s)
    inputs = (qa_s, ca_s, ma_s, qa_s + 1.5, ca_s.copy(), ma_s.copy(), R)
    for port, kernel in zip(_port_pruned(*inputs), _pallas_pruned(*inputs)):
        _assert_covers_kernel(port, kernel, R * R * 0.81)
        assert (port[0][np.isfinite(port[0])] <= np.float32(R) ** 2).all()


def test_isolated_block_is_inf_like_the_pallas_kernel(rng):
    """tests/test_pallas_knn.py::test_pair_pruned_isolated_query_gets_inf."""
    M, N = 512, 2048
    qa = rng.uniform(-5, 5, (M, 3)).astype(np.float32)
    qa[256:] = rng.uniform(395, 405, (256, 3)).astype(np.float32)
    ca = rng.uniform(-6, 6, (N, 3)).astype(np.float32)
    ma = np.ones(N, bool)
    inputs = (qa, ca, ma, qa + 0.1, ca, ma, 1.0)
    (pd, pi), _ = _port_pruned(*inputs)
    (kd, ki), _ = _pallas_pruned(*inputs)
    assert np.isinf(pd[256:]).all() and (pi[256:] == 0).all() and np.isinf(kd[256:]).all()
    assert not np.isnan(pd).any()
    _assert_covers_kernel((pd, pi), (kd, ki), 0.81)


def test_covers_pallas_pruned_kernel_within_gate(rng):
    """tests/test_pallas_knn.py::test_pair_pruned_equals_unpruned_within_gate."""
    M, N, R = 256, 2048, 1.0
    qa = (rng.uniform(0, 1, (M, 1)) * np.array([40, 6, 2])).astype(np.float32)
    ca = qa[rng.integers(0, M, N)] + rng.normal(0, 0.8, (N, 3)).astype(np.float32)
    ma = np.ones(N, bool)
    inputs = (qa, ca, ma, qa + 0.3, ca, ma, R)
    for port, kernel in zip(_port_pruned(*inputs), _pallas_pruned(*inputs)):
        _assert_covers_kernel(port, kernel, R * R * 0.9)


# ---- mapping_step -----------------------------------------------------------

N_FRAMES = 3
SC = dict(ring_cap=512, max_points=32768, less_flat_cap=8192)
MC = dict(grid_w=7, grid_h=7, grid_d=3, corner_cube_cap=1024, surf_cube_cap=2048,
          corner_stack_cap=2048, surf_stack_cap=4096,
          submap_corner_cap=4096, submap_surf_cap=8192)
JCFG = kitti_hdl64().replace(scan=ScanConfig(**SC), mapping=MappingConfig(**MC))
TCFG = tconfig.kitti_hdl64().replace(scan=tconfig.ScanConfig(**SC),
                                     mapping=tconfig.MappingConfig(**MC))
T_TOL, R_TOL, COUNT_TOL = 4e-3, 1e-3, 0.005


@pytest.fixture(scope="module")
def mapping_runs():
    """The port's scan registration and LO turn three synthetic scans into
    feature clouds and LO poses; both packages' ``mapping_step`` then map the
    same clouds (the JAX side op by op, as in the lidar slice's test)."""
    scene = synthetic.default_scene()
    lo = init_lo_state(TCFG, "cpu")
    feeds = []
    for i, (R, t) in enumerate(synthetic.straight_trajectory(N_FRAMES, speed=0.8, yaw_rate=0.005)):
        pts = synthetic.simulate_scan(R, t, scene, n_azimuth=700, noise=0.005, seed=i)
        grid, gmask, _ = gridding.grid_cloud(pts, TCFG.scan)
        lf = gridding.less_flat_voxel_table(grid, gmask, TCFG.scan)
        gmask_t = torch.tensor(gmask)
        feats = extract_features_from_grid(
            torch.tensor(grid), gmask_t, gmask_t.sum(dim=1).to(torch.int32), TCFG.scan,
            lf_table=(torch.tensor(lf[0]), torch.tensor(lf[1]), torch.tensor(lf[2])))
        lo, _, world_lo, _ = lo_step(lo, feats, TCFG)
        feeds.append((feats.less_sharp, feats.less_sharp_mask, feats.less_flat,
                      feats.less_flat_mask, world_lo))

    calls = []
    real = fused_knn.knn_pair

    def recorded(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    port, state = [], tmap.init_map_state(TCFG, "cpu")
    with mock.patch.object(tmap, "knn_pair", recorded):
        for feed in feeds:
            state, pose = tmap.mapping_step(state, *feed, TCFG)
            port.append(pose.numpy())
        # The drive never leaves its first cube, so its cache is the frames'
        # appended rows.  One more step from a state that has forgotten its
        # window centre takes the rebuild branch on the filled map.
        n_drive = len(calls)
        moved = state._replace(sub_center=torch.full_like(state.sub_center, tmap.INT32_MIN))
        rebuilt, _ = tmap.mapping_step(moved, *feeds[-1], TCFG)
    rebuild_call, calls = calls[n_drive], calls[:n_drive]

    ref, jstate = [], jmap.init_map_state(JCFG)
    with jax.disable_jit():
        for feed in feeds:
            jstate, pose = jmap.mapping_step(jstate, *(jnp.array(x.numpy()) for x in feed), JCFG)
            ref.append(np.asarray(pose))
    return dict(port=port, ref=ref, state=state, jstate=jax.tree.map(np.asarray, jstate),
                calls=calls, feeds=feeds, rebuild_call=rebuild_call, rebuilt=rebuilt)


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_mapping_step_pose_matches_reference(mapping_runs, frame):
    got, want = mapping_runs["port"][frame], mapping_runs["ref"][frame]
    dt = np.abs(got[4:] - want[4:]).max()
    ang = 2.0 * np.arccos(min(1.0, abs(float(np.dot(got[:4], want[:4])))))
    assert dt < T_TOL and ang < R_TOL, (frame, dt, ang, got, want)


def test_mapping_step_map_counts_match_reference(mapping_runs):
    state, jstate = mapping_runs["state"], mapping_runs["jstate"]
    for got, want in ((state.corner_cnt, jstate.corner_cnt), (state.surf_cnt, jstate.surf_cnt)):
        got, want = int(got.sum()), int(want.sum())
        assert want > 0 and abs(got - want) <= COUNT_TOL * want, (got, want)
    assert int(state.sub_c_n) > 0 and int(state.sub_s_n) > 0


def test_mapping_step_searches_in_morton_order_under_the_radius(mapping_runs):
    """Every association call of the run passes the mapping radius and its
    live queries in Morton order, and the rebuilt submap cache is sorted."""
    state, calls, feeds = mapping_runs["state"], mapping_runs["calls"], mapping_runs["feeds"]
    mc = TCFG.mapping
    assert len(calls) == (N_FRAMES - 1) * mc.outer_iters
    r = max(mc.neighbor_dist_sq ** 0.5,
            mc.insert_dedup_factor * max(mc.line_resolution, mc.plane_resolution)) * 1.001
    for args, kw in calls:
        assert kw["prune_radius"] == (r, r)
    # The first association runs at frame 1's initial guess, LO's world pose
    # (the correction is still the identity): taken back through it, the
    # queries are the stack rows, whose keys must not decrease (a row within
    # rounding of a cell face may flip).
    args, kw = calls[0]
    back = tmap.geo.pose_inverse(feeds[1][4])
    for q, count in ((args[0], kw["a_counts"][0]), (args[4], kw["b_counts"][0])):
        n = int(count)
        keys = tknn.morton_keys(tmap.geo.pose_apply(back, q[:n]), tmap.STACK_MORTON_CELL)
        assert n > 100 and float((keys[1:] >= keys[:-1]).float().mean()) > 0.995
    # the rebuilt cache is in Morton order about its window centre
    args, kw = mapping_runs["rebuild_call"]
    n0 = int(kw["a_counts"][1])
    org = (mapping_runs["rebuilt"].sub_center.to(torch.float32) * mc.cube_size)[None, :]
    keys = tknn.morton_keys(args[1][:n0], tmap.SUBMAP_MORTON_CELL, org)
    assert n0 > 1000 and bool((keys[1:] >= keys[:-1]).all())
