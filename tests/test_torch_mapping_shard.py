"""The port's map-sharded mapping step (``vloam_tpu_torch.parallel``) on the
CPU: gloo ranks spawned from the test (``torch_shard_ranks``), each with one
thread, joined through a file store under the test's temporary directory.

* The sharding hooks in one process: a shard's window and insertion take
  only its own slots (a negative local slot is dropped into the scrap slot,
  never wrapped); ``map_state_from_numpy(..., shard=)`` and
  ``shard_map_state`` cut the same block of the reference's global layout.
* ``_merge_topk`` on 4 ranks (the butterfly) and 3 (the all-gather):
  every rank holds the plain global top-k of all packets exactly (rank
  order breaks ties), and the finite slots equal JAX's ``_merge_topk``
  under ``shard_map`` on 4 and 3 of the 8 virtual CPU devices (JAX's
  butterfly orders ties by rank, so +inf slots may carry other rows); the
  bytes delivered equal ``merge_payload_bytes``.
* The rebase centre: the plain k-NN at 24 m from the origin, rebased to two
  centres, sends a near tie either way; rebased to the window's box
  (``_window_box``, two gloo ranks), every rank's distances and the merged
  top k are the single search's bit for bit.
* ``make_sharded_step`` at S = 2, 3 and 4 against the port's single-device
  ``mapping_step`` over three frames at small caps: poses within 5e-3 (the
  bound of ``tests/test_parallel_mapping.py``) and, on the CPU, equal to
  the single step's bit for bit, map counts within
  max(5, 0.5 %), each rank's counts within that of the single map's slots
  in its block, every rank's pose the same bit for bit, each rank holding
  only its block.  The drive starts with the map lifted by ``LIFT`` (the
  sensor 24 m below the map's origin), so the ground lies in the cube
  layer below the sensor's: a course in one layer fills only rank 0's
  block (ROADMAP C-l), this one fills two ranks' at S = 2 and 3 and three
  at S = 4, so the merges join real candidates from more than one rank.
* At S = 4 against JAX's ``make_sharded_step`` on ``map_mesh(4)``, block
  by block, from the identity map (ranks 0 and 1 hold points): poses within
  5e-3, each rank's corner and surf totals and each fresh slot's counts
  within max(5, 0.5 %) of the JAX block's.  The gap is the single-device
  steps' own (ROADMAP C-k).  From the lifted map the two packages' single
  steps lie farther apart than 5e-3 (ROADMAP C-m, ``torch_lift_gap.py``),
  so this comparison starts from the identity.
* ``map_mesh`` with no device asks for ``cuda:LOCAL_RANK`` and raises where
  there is no GPU.
* ``slow``: the full-size mirror of ``tests/test_parallel_mapping.py`` (its
  caps, four frames, S = 8): its contract on the port, and the map counts
  against the JAX sharded step on all 8 devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_shard_ranks as ranks
from vloam_tpu.config import MappingConfig, ScanConfig, kitti_hdl64
from vloam_tpu.models import laser_mapping as jmap
from vloam_tpu.parallel import mapping_shard as jshard
from vloam_tpu.parallel.mesh import map_mesh
from vloam_tpu_torch import config as tconfig
from vloam_tpu_torch.data import gridding, synthetic
from vloam_tpu_torch.models import laser_mapping as tmap
from vloam_tpu_torch.models.lidar_odometry import init_lo_state, lo_step
from vloam_tpu_torch.ops.knn import knn_reference
from vloam_tpu_torch.ops.scan_registration import extract_features_from_grid
from vloam_tpu_torch.parallel import mapping_shard as tshard
from vloam_tpu_torch.parallel import mesh as tmesh

POSE_TOL = 5e-3


def count_tol(n: int) -> int:
    return max(5, n // 200)


# the caps of the port's single-device mapping parity tests (test_torch_knn_prune.py)
SC = dict(ring_cap=512, max_points=32768, less_flat_cap=8192)
MC = dict(grid_w=7, grid_h=7, grid_d=3, corner_cube_cap=1024, surf_cube_cap=2048,
          corner_stack_cap=2048, surf_stack_cap=4096,
          submap_corner_cap=4096, submap_surf_cap=8192)
JCFG = kitti_hdl64().replace(scan=ScanConfig(**SC), mapping=MappingConfig(**MC))
TCFG = tconfig.kitti_hdl64().replace(scan=tconfig.ScanConfig(**SC),
                                     mapping=tconfig.MappingConfig(**MC))
N_FRAMES = 3
LIFT = torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, -24.0])   # wmap_wodom of frame 0


def make_feeds(tcfg, n_frames, n_azimuth):
    """Feature clouds and LO world poses from the port's host gridding, scan
    registration and LO over synthetic scans (the main path's inputs; one
    set, fed to every mapping step)."""
    scene = synthetic.default_scene()
    lo, feeds = init_lo_state(tcfg, "cpu"), []
    for i, (R, t) in enumerate(synthetic.straight_trajectory(n_frames, speed=0.8,
                                                             yaw_rate=0.01)):
        pts = synthetic.simulate_scan(R, t, scene, n_azimuth=n_azimuth, noise=0.005, seed=i)
        grid, gmask, _ = gridding.grid_cloud(pts, tcfg.scan)
        lf = gridding.less_flat_voxel_table(grid, gmask, tcfg.scan)
        gm = torch.tensor(gmask)
        feats = extract_features_from_grid(torch.tensor(grid), gm, gm.sum(dim=1).to(torch.int32),
                                           tcfg.scan, lf_table=tuple(torch.tensor(x) for x in lf))
        lo, _, world_lo, _ = lo_step(lo, feats, tcfg)
        feeds.append((feats.less_sharp, feats.less_sharp_mask, feats.less_flat,
                      feats.less_flat_mask, world_lo))
    return feeds


@pytest.fixture(scope="module")
def feeds():
    return make_feeds(TCFG, N_FRAMES, 600)


@pytest.fixture(scope="module")
def single(feeds):
    # one thread, as each rank runs, so no reduction splits differently
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state, poses = tmap.init_map_state(TCFG, "cpu")._replace(wmap_wodom=LIFT), []
        for feed in feeds:
            state, pose = tmap.mapping_step(state, *feed, TCFG)
            poses.append(pose)
    finally:
        torch.set_num_threads(threads)
    return torch.stack(poses), state


@pytest.fixture(scope="module")
def sharded(feeds, tmp_path_factory):
    """(S, lifted) -> every rank's result of the sharded drive, from the map
    lifted by ``LIFT`` or from the identity (run once per key)."""
    cache = {}

    def run(S, lifted=True):
        if (S, lifted) not in cache:
            payload = dict(cfg=TCFG, feeds=feeds)
            if lifted:
                payload["wmap_wodom"] = LIFT
            cache[S, lifted] = ranks.run_job(tmp_path_factory.mktemp(f"map{S}"), "mapping", S,
                                             payload)
        return cache[S, lifted]

    return run


# ---- the hooks, in one process --------------------------------------------------

def fake_mesh(rank, S):
    return tmesh.MapMesh(None, rank, S, torch.device("cpu"), "gloo")


def test_insert_drops_other_shards_points():
    """A point whose global slot lies below the shard's offset has a negative
    local slot: it is dropped, never wrapped into the block's last slots."""
    cfg = TCFG
    nc = tmap.n_cubes(cfg)
    S = 4
    nc_local = -(-nc // S)
    state = tmesh.shard_map_state(tmap.init_map_state(cfg, "cpu", n_shards=S), fake_mesh(2, S))
    assert state.cube_pts.shape[0] == nc_local + 1 and state.corner_cnt.shape == (nc_local,)
    assert state.sub_c_n.shape == (1,) and state.sub_c.shape[0] == cfg.mapping.submap_corner_cap
    # world cubes whose slots (7x7x3 grid) are 80, 10, 120, 79 and 100: shard 2 owns [74, 111)
    want_coord = torch.tensor([[3, 4, 1], [3, 1, 0], [1, 3, 2], [-5, 4, 1], [2, 0, 2]])
    pts = torch.cat([want_coord * cfg.mapping.cube_size + 0.5, torch.zeros(5, 1)], 1).float()
    coord = tmap.cube_coord_of(pts[:, :3], cfg.mapping.cube_size)
    assert torch.equal(coord, want_coord)
    slot = tmap.coord_to_slot(coord, cfg)
    offset = 2 * nc_local
    mine = (slot >= offset) & (slot < offset + nc_local)
    assert tmap.coord_to_slot(coord, cfg).tolist() == [80, 10, 120, 79, 100]
    mask = torch.ones(5, dtype=torch.bool)
    c_cnt, s_cnt, cube_coord, acc_c, acc_s = tmap._scatter_insert_pair(
        pts, mask, pts[:0], mask[:0], state.cube_pts, state.corner_cnt, state.surf_cnt,
        state.cube_coord, cfg, slot_offset=offset)
    assert torch.equal(acc_c, mine)
    want = torch.zeros(nc_local, dtype=torch.int64)
    want.index_add_(0, slot[mine] - offset, torch.ones(int(mine.sum()), dtype=torch.int64))
    assert torch.equal(c_cnt, want) and int(s_cnt.sum()) == 0
    assert torch.equal(cube_coord[slot[mine] - offset], coord[mine])
    # the window: own cubes only, other shards' slots come back as the scrap index
    (_, cm), (_, sm), local = tshard._local_window(
        state._replace(corner_cnt=c_cnt, cube_coord=cube_coord), coord, cfg, fake_mesh(2, S))
    assert torch.equal(local, torch.where(mine, slot - offset, nc_local))
    assert int(cm.sum()) == int(mine.sum()) and int(sm.sum()) == 0


def test_state_blocks_from_the_reference_layout():
    S, r = 4, 1
    jstate = jax.tree.map(np.asarray, jmap.init_map_state(JCFG, n_shards=S))
    rng = np.random.default_rng(0)
    jstate = jstate._replace(corner_cnt=rng.integers(0, 9, jstate.corner_cnt.shape, np.int32),
                             sub_c_n=np.arange(S, dtype=np.int32) + 3,
                             sub_c=rng.normal(size=jstate.sub_c.shape).astype(np.float32))
    got = tmap.map_state_from_numpy(jstate, "cpu", shard=(r, S))
    nl = jstate.corner_cnt.shape[0] // S
    cap = JCFG.mapping.submap_corner_cap
    assert got.cube_pts.shape[0] == nl + 1
    np.testing.assert_array_equal(got.corner_cnt.numpy(), jstate.corner_cnt[r * nl:(r + 1) * nl])
    np.testing.assert_array_equal(got.sub_c.numpy(), jstate.sub_c[r * cap:(r + 1) * cap])
    assert got.sub_c_n.tolist() == [4]
    port = tmap.init_map_state(TCFG, "cpu", n_shards=S)
    assert port.cube_pts.shape[0] == jstate.cube_pts.shape[0] + 1
    assert port.sub_c_n.shape == (S,) and port.sub_c.shape == jstate.sub_c.shape
    block = tmesh.shard_map_state(port._replace(
        corner_cnt=torch.tensor(jstate.corner_cnt, dtype=torch.int64),
        sub_c=torch.tensor(jstate.sub_c), sub_c_n=torch.tensor(jstate.sub_c_n,
                                                                dtype=torch.int64)),
        fake_mesh(r, S))
    for name in ("corner_cnt", "sub_c", "sub_c_n", "cube_coord"):
        assert torch.equal(getattr(block, name), getattr(got, name).to(getattr(block, name).dtype))
    assert tshard.map_state_specs().cube_pts == "sharded"
    assert tshard.map_state_specs().pose_map == "replicated"


# ---- the merge -------------------------------------------------------------------

def packets(S, M=40, k=5, seed=0):
    """S ranks' (M, k, 4) packets, d2 ascending per row and distinct, some
    rows short of candidates (+inf slots)."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(S, M, k, 4)).astype(np.float32)
    p[..., 3] = np.sort(rng.permutation(S * M * k).reshape(S, M, k) * 0.01, axis=-1)
    p[0, :8, 3:, 3] = np.inf
    p[S - 1, 4:12, 1:, 3] = np.inf
    p[1:, 20:26, :, 3] = np.inf     # rows with 2 finite candidates in all: 3 +inf slots merged
    p[0, 20:26, 2:, 3] = np.inf
    return p


def jax_merge(p, k):
    S = p.shape[0]
    mesh = Mesh(np.array(jax.devices()[:S]), ("map",))
    f = jax.jit(jax.shard_map(lambda x: jshard._merge_topk(x[0], k, "map"), mesh=mesh,
                              in_specs=P("map"), out_specs=(P(), P()), check_vma=False))
    nbr, d2 = f(jnp.array(p))
    return np.asarray(nbr), np.asarray(d2)


@pytest.mark.parametrize("S", [4, 3])
def test_merge_topk_matches_global_topk_and_jax(S, tmp_path):
    k = 5
    p = packets(S, k=k)
    got = ranks.run_job(tmp_path, "merge", S, dict(packets=torch.tensor(p), k=k))
    M = p.shape[1]
    allp = torch.tensor(p).permute(1, 0, 2, 3).reshape(M, S * k, 4)
    want = tshard._topk_rows(allp, k)
    jnbr, jd2 = jax_merge(p, k)
    fin = np.isfinite(jd2)
    for r in got:
        assert torch.equal(r["d2"], want[..., 3]) and torch.equal(r["nbr"], want[..., :3])
        assert r["bytes"] == tshard.merge_payload_bytes(S, M, k)
        np.testing.assert_array_equal(r["d2"].numpy(), jd2)
        np.testing.assert_array_equal(r["nbr"].numpy()[fin], jnbr[fin])
    assert (~fin).any() and fin.mean() > 0.9


def test_merge_payload_bytes_matches_reference():
    for S in (1, 2, 3, 4, 5, 8):
        assert tshard.merge_payload_bytes(S, 4096, 5) == jshard.merge_payload_bytes(S, 4096, 5)


# ---- the rebase centre ------------------------------------------------------------

def centred_nearest(query, cand, centre_rows):
    """The plain k-NN's nearest of two candidates, rebased to the centre of
    the box of ``cand`` and ``centre_rows`` (rows masked in past the count)."""
    rows = torch.cat([cand, centre_rows])
    mask = torch.ones(rows.shape[0], dtype=torch.bool)
    return knn_reference(query, rows, mask, 1, cand_count=cand.shape[0])[1][:, 0]


def test_rebase_centre_moves_near_ties():
    """The mechanism behind the sharded step's rebase centre: one query set
    straddling the bisector of two candidates 24 m below the origin, rebased
    to the centre of a window's box (near the candidates) and to that of a
    rank's slice (tens of metres off): a difference rebased to the far
    centre lands in a coarser binade and is rounded, so near ties go the
    other way on some queries."""
    rng = np.random.default_rng(3)
    a = torch.tensor([[3.71, -1.32, -24.6]])
    b = a + torch.tensor([[0.41, 0.23, -0.17]])
    mid, axis = (a + b) / 2, (b - a) / torch.linalg.norm(b - a)
    off = torch.tensor(rng.normal(0, 0.3, (20000, 3)), dtype=torch.float32)
    q = mid + off - axis * (off * axis).sum(1, keepdim=True)   # on the bisector plane, ...
    q = q + axis * torch.tensor(rng.normal(0, 2e-6, (20000, 1)), dtype=torch.float32)  # ... near
    cand = torch.cat([a, b])
    window = torch.tensor([[-29.3717, -30.1291, -27.0443], [30.0107, 27.7703, -21.4977]])
    own = torch.tensor([[-49.1, -12.2, -27.5], [8.3, 40.0, -24.3]])     # centre (-20.4, 13.9, ...)
    flips = int((centred_nearest(q, cand, window) != centred_nearest(q, cand, own)).sum())
    assert flips > 0


def test_window_box_gives_every_rank_the_single_search(tmp_path):
    """Two gloo ranks, each holding one slice of a window 24 m below the
    origin (rank 1 the ground layer, as on the lifted map): rebased to the
    window's box (``_window_box``), every rank's k-NN distances and the
    merged top k equal the single search's bit for bit; rebased to a rank's
    own box, some distances are rounded otherwise."""
    rng = np.random.default_rng(4)
    k, n = 5, 3000
    cand = torch.tensor(np.stack([rng.uniform(-25, 25, n), rng.uniform(-25, 25, n),
                                  rng.uniform(-27, -18, n)], -1), dtype=torch.float32)
    query = cand[rng.integers(0, n, 700)] + torch.tensor(rng.normal(0, 0.4, (700, 3)),
                                                         dtype=torch.float32)
    ground = cand[:, 2] < -24.0
    cap = int(max(ground.sum(), (~ground).sum())) + 7          # padded buffers, a count each
    bufs, masks, counts = [], [], []
    for part in (~ground, ground):
        rows = cand[part]
        bufs.append(torch.cat([rows, torch.full((cap - rows.shape[0], 3), 99.0)]))
        masks.append(torch.arange(cap) < rows.shape[0])
        counts.append(rows.shape[0])
    got = ranks.run_job(tmp_path, "window_box", 2, dict(query=query, cand=bufs, mask=masks,
                                                        count=counts, k=k))
    d2, idx = knn_reference(query, cand, torch.ones(n, dtype=torch.bool), k)
    want = torch.cat([cand[idx], d2[..., None]], dim=-1)

    def merged(key):
        packets = [torch.cat([bufs[r][got[r][key][1]], got[r][key][0][..., None]], dim=-1)
                   for r in range(2)]
        return tshard._topk_rows(torch.cat(packets, dim=1), k)

    box = torch.stack([cand.amin(dim=0), cand.amax(dim=0)])
    for r in got:
        assert torch.equal(r["box"], box)
    assert torch.equal(merged("window"), want)
    assert not torch.equal(merged("own")[..., 3], want[..., 3])


# ---- the sharded step ---------------------------------------------------------------

@pytest.mark.parametrize("S", [2, 3, 4])
def test_sharded_step_matches_single_device(S, single, sharded):
    poses, state = single
    res = sharded(S)
    for r in res:
        assert torch.equal(r["poses"], res[0]["poses"])      # replicated bit for bit
    np.testing.assert_allclose(res[0]["poses"].numpy(), poses.numpy(), atol=POSE_TOL)
    # on the CPU the merge returns the single search's neighbours, so the poses are equal
    assert torch.equal(res[0]["poses"], poses)
    for name in ("corner_cnt", "surf_cnt"):
        want = int(getattr(state, name).sum())
        got = sum(int(r["state"][name].sum()) for r in res)
        assert want > 0 and abs(got - want) <= count_tol(want), (name, got, want)
    nc_local = -(-tmap.n_cubes(TCFG) // S)
    holding = 0
    for r, x in enumerate(res):
        assert x["state"]["cube_pts"].shape[0] == nc_local + 1
        assert x["state"]["sub_c_n"].shape == (1,)
        for name in ("corner_cnt", "surf_cnt"):
            want = int(getattr(state, name)[r * nc_local:(r + 1) * nc_local].sum())
            got = int(x["state"][name].sum())
            assert abs(got - want) <= count_tol(want), (r, name, got, want)
        holding += int(x["state"]["corner_cnt"].sum() + x["state"]["surf_cnt"].sum()) > 0
    assert holding == {2: 2, 3: 2, 4: 3}[S], holding
    assert sum(int(r["state"]["sub_s_n"][0]) for r in res) > 0


def test_sharded_step_matches_jax_blocks(sharded, feeds):
    """S = 4 against JAX's sharded step on map_mesh(4), rank block by JAX block,
    from the identity map: ranks 0 and 1 hold points."""
    S = 4
    res = sharded(S, lifted=False)
    step = jshard.make_sharded_step(JCFG, map_mesh(S))
    jstate = jmap.init_map_state(JCFG, n_shards=S)
    jposes = []
    for feed in feeds:
        jstate, pose = step(jstate, *(jnp.array(x.numpy()) for x in feed))
        jposes.append(np.asarray(pose))
    np.testing.assert_allclose(res[0]["poses"].numpy(), np.stack(jposes), atol=POSE_TOL)
    n_fresh, holding = 0, 0
    for r, got in enumerate(res):
        want = tmap.map_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu", shard=(r, S))
        g, w = got["state"], want
        for name in ("corner_cnt", "surf_cnt"):
            a, b = int(g[name].sum()), int(getattr(w, name).sum())
            assert abs(a - b) <= count_tol(b), (r, name, a, b)
        fresh = torch.all(g["cube_coord"] == w.cube_coord, dim=-1) & (w.cube_coord[:, 0] > -2**30)
        n_fresh += int(fresh.sum())
        holding += int(w.corner_cnt.sum() + w.surf_cnt.sum()) > 0
        for name in ("corner_cnt", "surf_cnt"):
            a, b = g[name][fresh], getattr(w, name)[fresh]
            assert bool(((a - b).abs() <= torch.clamp(b // 200, min=5)).all()), (r, name)
        for name in ("sub_c_n", "sub_s_n"):
            a, b = int(g[name][0]), int(getattr(w, name)[0])
            assert abs(a - b) <= count_tol(b), (r, name, a, b)
    assert n_fresh > 0 and holding == 2


def test_map_mesh_defaults_to_the_gpu(tmp_path):
    got = ranks.run_job(tmp_path, "default_device", 1, {})[0]
    if torch.cuda.is_available():
        assert got == "cuda:0", got
    else:
        assert got.startswith("RuntimeError: map_mesh: device cuda:0 requested"), got


@pytest.mark.slow
def test_full_size_sharded_matches_single_device_and_jax_on_8_devices(tmp_path):
    """``tests/test_parallel_mapping.py``'s contract on the port, at its caps
    and drive, S = 8: the sharded poses within 5e-3 of the port's own
    single-device step, the map counts within max(5, 0.5 %); the counts also
    within that of JAX's sharded program on the 8 devices.  Its poses are
    not held to the port's: the port's single step lies 4.7 mm from JAX's
    op-by-op one on this drive and JAX's compiled step 6.1 mm from that, the
    other way (ROADMAP C-k and C), 10.8 mm in all."""
    sc = dict(ring_cap=1024, max_points=65536, less_flat_cap=16384)
    mc = dict(grid_w=7, grid_h=7, grid_d=3, corner_cube_cap=1024, surf_cube_cap=2048,
              corner_stack_cap=2048, surf_stack_cap=4096)
    jcfg = kitti_hdl64().replace(scan=ScanConfig(**sc), mapping=MappingConfig(**mc))
    tcfg = tconfig.kitti_hdl64().replace(scan=tconfig.ScanConfig(**sc),
                                         mapping=tconfig.MappingConfig(**mc))
    feeds = make_feeds(tcfg, 4, 700)
    S = 8
    res = ranks.run_job(tmp_path, "mapping", S, dict(cfg=tcfg, feeds=feeds))
    state, poses = tmap.init_map_state(tcfg, "cpu"), []
    for feed in feeds:
        state, pose = tmap.mapping_step(state, *feed, tcfg)
        poses.append(pose)
    np.testing.assert_allclose(res[0]["poses"].numpy(), torch.stack(poses).numpy(), atol=POSE_TOL)
    step = jshard.make_sharded_step(jcfg, map_mesh(S))
    jstate = jmap.init_map_state(jcfg, n_shards=S)
    for feed in feeds:
        jstate, _ = step(jstate, *(jnp.array(x.numpy()) for x in feed))
    for name in ("corner_cnt", "surf_cnt"):
        got = sum(int(r["state"][name].sum()) for r in res)
        for want in (int(getattr(state, name).sum()), int(np.asarray(getattr(jstate, name)).sum())):
            assert abs(got - want) <= count_tol(want), (name, got, want)
