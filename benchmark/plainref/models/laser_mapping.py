"""Scan-to-map lidar odometry (MO) — port of
``vloam_tpu/models/laser_mapping.py``.

The map is a block-cyclic grid of fixed-capacity cubes (slot = world cube
coordinate mod grid dims); each slot remembers which world cube it holds,
so moving on lets new cubes lazily evict stale slots.  Per frame:
voxel-downsample the input features, take the 5x5x3-cube submap, run two
outer iterations of fused 5-NN + line/plane fits + fused GN, update the
wmap_wodom correction, and insert the registered points.  Two map policies
(``MappingConfig.insert_dedup``):

* True (the default): the submap comes from the compacted-submap cache
  (rebuilt only when the centre cube changes), and only the registered
  points whose nearest map point is farther than half a voxel are inserted;
* False (the reference's own policy, laser_mapping.cpp:741-808): the submap
  is gathered afresh every frame, every registered point is inserted, and
  the window's cubes are re-voxelised after the insert (``_refilter_cubes``,
  the sorting path of ``voxel_downsample``).  The cache is left as it was.

A gathered submap is put into Morton order: the rebuilt cache on every
device, as the reference does on its accelerator, and on the
``insert_dedup=False`` path every frame's window too (the reference keeps
that one in slot order; the search is exact, so the order changes only
d2 ties and run time).  The 5-NN search sees the feature stacks
through a Morton-order permutation, and it is clamped to the radius every
consumer of its distances gates below: rows that lie together in space make
the k-NN kernel's tile boxes small, and it skips the tile pairs farther
apart than the radius.  The stacks themselves keep their scan order (the
reference sorts them in place): the order decides which points a full cube
drops, so sorting them would change the map wherever a cube overflows.

In place: the cube array (~477 MB at kitti_hdl64) is scattered into in
place every frame and never copied; the small count and coordinate arrays
and the submap caches are rebuilt out of place.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from plainref import geometry as geo
from plainref.config import VloamConfig
from plainref.ops.fused_gn import solve_pose_gn_lidar
from plainref.ops.fused_knn import knn_pair
from plainref.ops.knn import compact_rows, knn, morton_order, morton_sort
from plainref.ops.linalg3 import eigh3x3_sym, solve3x3_sym
from plainref.ops.voxel import div_exact, voxel_downsample, voxel_downsample_batched

INT32_MIN = -(2**31)
STACK_MORTON_CELL = 2.0    # m, feature stacks (sensor frame)
SUBMAP_MORTON_CELL = 4.0   # m, submap cache (world frame, about the window centre)


class MapState(NamedTuple):
    # Rows [0, corner_cap) of each slot hold its corner points, rows
    # [corner_cap, corner_cap + surf_cap) its surf points.  One extra slot
    # past the last real one is a scrap slot: rejected insert rows are
    # scattered there (the reference's out-of-bounds mode="drop").
    cube_pts: torch.Tensor     # (n_cubes + 1, corner_cap + surf_cap, 4)
    corner_cnt: torch.Tensor   # (n_cubes,) int64
    surf_cnt: torch.Tensor     # (n_cubes,) int64
    cube_coord: torch.Tensor   # (n_cubes, 3) int64 world cube coord per slot
    pose_map: torch.Tensor     # (7,) world_T_curr after mapping
    wmap_wodom: torch.Tensor   # (7,) map-world_T_odom-world correction
    initialized: bool
    # compacted-submap cache around sub_center
    sub_c: torch.Tensor        # (submap_corner_cap, 4)
    sub_c_n: torch.Tensor      # () int64 valid prefix
    sub_s: torch.Tensor        # (submap_surf_cap, 4)
    sub_s_n: torch.Tensor      # () int64
    sub_center: torch.Tensor   # (3,) int64


def n_cubes(cfg: VloamConfig) -> int:
    mc = cfg.mapping
    return mc.grid_w * mc.grid_h * mc.grid_d


def init_map_state(cfg: VloamConfig, device, n_shards: int = 1) -> MapState:
    """The map.  ``n_shards > 1`` pads the slot axis to a multiple of the
    shard count, so each rank of a map mesh owns an equal block of slots
    (pad slots hold the never-matching sentinel coordinate and are never
    addressed), and lays the submap cache out as one block a shard: sub_c
    and sub_s grow to (n_shards * cap, 4) and their valid-prefix counts
    become (n_shards,) vectors (``parallel/mapping_shard``).  The scrap
    slot stays last."""
    mc = cfg.mapping
    nc = -(-n_cubes(cfg) // n_shards) * n_shards
    i64 = dict(dtype=torch.int64, device=device)
    count_shape = (n_shards,) if n_shards > 1 else ()
    return MapState(
        cube_pts=torch.zeros((nc + 1, mc.corner_cube_cap + mc.surf_cube_cap, 4), device=device),
        corner_cnt=torch.zeros((nc,), **i64),
        surf_cnt=torch.zeros((nc,), **i64),
        cube_coord=torch.full((nc, 3), INT32_MIN, **i64),
        pose_map=geo.pose_identity(device),
        wmap_wodom=geo.pose_identity(device),
        initialized=False,
        sub_c=torch.zeros((n_shards * mc.submap_corner_cap, 4), device=device),
        sub_c_n=torch.zeros(count_shape, **i64),
        sub_s=torch.zeros((n_shards * mc.submap_surf_cap, 4), device=device),
        sub_s_n=torch.zeros(count_shape, **i64),
        sub_center=torch.full((3,), INT32_MIN, **i64),
    )


def map_state_from_numpy(state, device, shard: tuple[int, int] | None = None) -> MapState:
    """A reference ``MapState`` whose leaves are NumPy arrays -> this port's
    state on ``device`` (the scrap slot is appended).  With ``shard=(r, S)``
    the reference state is the global state of an S-shard mesh
    (``init_map_state(cfg, n_shards=S)``) and the result is rank r's block:
    slots [r * nc_local, (r + 1) * nc_local), cache block r, and the
    replicated poses and centre."""
    f = lambda x: torch.tensor(np.asarray(x), device=device)  # noqa: E731
    i = lambda x: f(x).to(torch.int64)  # noqa: E731

    def block(x):
        if shard is None:
            return x
        r, S = shard
        n = np.shape(x)[0] // S
        return np.asarray(x)[r * n:(r + 1) * n]

    cube = f(block(state.cube_pts))
    return MapState(
        cube_pts=torch.cat([cube, torch.zeros_like(cube[:1])]),
        corner_cnt=i(block(state.corner_cnt)), surf_cnt=i(block(state.surf_cnt)),
        cube_coord=i(block(state.cube_coord)),
        pose_map=f(state.pose_map), wmap_wodom=f(state.wmap_wodom),
        initialized=bool(np.asarray(state.initialized)),
        sub_c=f(block(state.sub_c)), sub_c_n=i(block(state.sub_c_n)),
        sub_s=f(block(state.sub_s)), sub_s_n=i(block(state.sub_s_n)),
        sub_center=i(state.sub_center),
    )


def cube_coord_of(points: torch.Tensor, cube_size: float) -> torch.Tensor:
    """World point -> integer cube coordinate (plain floor)."""
    return torch.floor(div_exact(points + cube_size / 2.0, cube_size)).to(torch.int64)


def coord_to_slot(coord: torch.Tensor, cfg: VloamConfig) -> torch.Tensor:
    """Block-cyclic slot index for a world cube coordinate."""
    mc = cfg.mapping
    dims = torch.tensor([mc.grid_w, mc.grid_h, mc.grid_d], dtype=torch.int64, device=coord.device)
    m = torch.remainder(coord, dims)  # result in [0, dims)
    return m[..., 0] + mc.grid_w * m[..., 1] + mc.grid_w * mc.grid_h * m[..., 2]


def _submap_coords(center_coord: torch.Tensor, cfg: VloamConfig) -> torch.Tensor:
    """(75, 3) world cube coords of the 5x5x3 neighbourhood."""
    mc = cfg.mapping
    dev = center_coord.device
    dx = torch.arange(-mc.submap_rx, mc.submap_rx + 1, device=dev)
    dz = torch.arange(-mc.submap_rz, mc.submap_rz + 1, device=dev)
    off = torch.stack(torch.meshgrid(dx, dx, dz, indexing="ij"), dim=-1).reshape(-1, 3)
    return center_coord[None, :] + off


def _gather_submap(state: MapState, coords: torch.Tensor, cfg: VloamConfig, slot_offset=None):
    """Gather the neighbourhood cubes' points, compacted into dense buffers.

    A ``slot_offset`` (one shard of the sharded step) shifts the global slot
    ids into this shard's block: cubes another shard owns gather nothing,
    and their slot comes back as the scrap index n_cubes_local."""
    mc = cfg.mapping
    slots = coord_to_slot(coords, cfg)
    if slot_offset is not None:
        nc = state.corner_cnt.shape[0]
        slots = slots - slot_offset
        own = (slots >= 0) & (slots < nc)
        slots = torch.where(own, slots, nc)
        read = torch.clamp(slots, max=nc - 1)
        fresh = torch.all(state.cube_coord[read] == coords, dim=-1) & own
    else:
        read = slots
        fresh = torch.all(state.cube_coord[slots] == coords, dim=-1)
    sub = state.cube_pts[read]                               # (75, capT, 4)
    c_counts = torch.where(fresh, state.corner_cnt[read], 0)
    s_counts = torch.where(fresh, state.surf_cnt[read], 0)
    c_pts, c_mask = compact_rows(sub[:, :mc.corner_cube_cap], c_counts, mc.submap_corner_cap)
    s_pts, s_mask = compact_rows(sub[:, mc.corner_cube_cap:], s_counts, mc.submap_surf_cap)
    return (c_pts, c_mask), (s_pts, s_mask), slots, fresh


def fit_corner_lines(stack, stack_mask, nbr, d2, cfg):
    """PCA line fit from the 5-NN neighbours (nbr (M, 5, 3), d2 (M, 5))."""
    mc = cfg.mapping
    x, y, z = nbr[..., 0], nbr[..., 1], nbr[..., 2]
    cx, cy, cz = x.mean(dim=1), y.mean(dim=1), z.mean(dim=1)
    zx, zy, zz = x - cx[:, None], y - cy[:, None], z - cz[:, None]
    a = torch.sum(zx * zx, dim=1)
    b = torch.sum(zy * zy, dim=1)
    c = torch.sum(zz * zz, dim=1)
    dd = torch.sum(zx * zy, dim=1)
    ee = torch.sum(zy * zz, dim=1)
    ff = torch.sum(zx * zz, dim=1)
    (_, e2, e3), (_, _, v3) = eigh3x3_sym(a, b, c, dd, ee, ff)
    is_line = e3 > mc.eigen_ratio * e2
    valid = stack_mask & (d2[:, -1] < mc.neighbor_dist_sq) & is_line
    span = mc.line_span
    pa = torch.stack([cx + span * v3[0], cy + span * v3[1], cz + span * v3[2]], dim=-1)
    pb = torch.stack([cx - span * v3[0], cy - span * v3[1], cz - span * v3[2]], dim=-1)
    return stack[:, :3], pa, pb, valid


def fit_surf_planes(stack, stack_mask, nbr, d2, cfg):
    """Least-squares plane fit A n = -1 from the 5-NN neighbours."""
    mc = cfg.mapping
    x, y, z = nbr[..., 0], nbr[..., 1], nbr[..., 2]
    a = torch.sum(x * x, dim=1)
    b = torch.sum(y * y, dim=1)
    c = torch.sum(z * z, dim=1)
    dd = torch.sum(x * y, dim=1)
    ee = torch.sum(y * z, dim=1)
    ff = torch.sum(x * z, dim=1)
    bx, by, bz = -torch.sum(x, dim=1), -torch.sum(y, dim=1), -torch.sum(z, dim=1)
    nx, ny, nz = solve3x3_sym(a, b, c, dd, ee, ff, bx, by, bz)
    inv_len = 1.0 / torch.clamp(torch.sqrt(nx * nx + ny * ny + nz * nz), min=1e-10)
    d = inv_len
    nx, ny, nz = nx * inv_len, ny * inv_len, nz * inv_len
    fit = torch.abs(x * nx[:, None] + y * ny[:, None] + z * nz[:, None] + d[:, None])
    plane_ok = torch.all(fit <= mc.plane_fit_tol, dim=-1)
    valid = stack_mask & (d2[:, -1] < mc.neighbor_dist_sq) & plane_ok
    return stack[:, :3], torch.stack([nx, ny, nz], dim=-1), d, valid


def _corner_correspondences(pose, stack, stack_mask, cand, cand_mask, cfg,
                            cand_count=None, query_count=None):
    """Map association of one feature type, one k-NN problem per launch:
    5-NN + PCA line fit -> virtual edge endpoints.  Also returns the 1-NN
    squared distance (d2[:, 0]) for the insert-dedup gate.  ``mapping_step``
    runs both feature types through one ``knn_pair`` launch instead."""
    q = geo.pose_apply(pose, stack[:, :3])
    d2, idx = knn(q, cand[:, :3], cand_mask, cfg.mapping.n_neighbors,
                  cand_count=cand_count, query_count=query_count)
    return fit_corner_lines(stack, stack_mask, cand[idx, :3], d2, cfg) + (d2[:, 0],)


def _surf_correspondences(pose, stack, stack_mask, cand, cand_mask, cfg,
                          cand_count=None, query_count=None):
    """5-NN + least-squares plane fit A n = -1, one k-NN problem per launch."""
    q = geo.pose_apply(pose, stack[:, :3])
    d2, idx = knn(q, cand[:, :3], cand_mask, cfg.mapping.n_neighbors,
                  cand_count=cand_count, query_count=query_count)
    return fit_surf_planes(stack, stack_mask, cand[idx, :3], d2, cfg) + (d2[:, 0],)


def _scatter_insert_pair(corner_w, c_mask, surf_w, s_mask,
                         cube_pts, corner_cnt, surf_cnt, cube_coord, cfg, slot_offset=None):
    """Append both feature types' world points into their cube slots with
    one stable sort, one point scatter and one count pass.  Stale slots
    (holding an evicted world cube) are reset first.  A ``slot_offset`` (one
    shard of the sharded step) shifts global slot ids into this shard's
    block: points whose local slot falls outside [0, n_cubes_local) belong
    to another shard and are dropped into the scrap slot (never wrapped).

    ``cube_pts`` is updated IN PLACE (rejects land in its scrap slot).
    Returns (corner_cnt, surf_cnt, cube_coord, accepted_corner, accepted_surf).
    """
    mc = cfg.mapping
    nc = corner_cnt.shape[0]
    capc, capT = mc.corner_cube_cap, mc.corner_cube_cap + mc.surf_cube_cap
    n_c, n = corner_w.shape[0], corner_w.shape[0] + surf_w.shape[0]
    dev = corner_w.device

    pts = torch.cat([corner_w, surf_w])
    mask = torch.cat([c_mask, s_mask])
    is_surf = (torch.arange(n, device=dev) >= n_c).to(torch.int64)
    coord = cube_coord_of(pts[:, :3], mc.cube_size)
    slot = coord_to_slot(coord, cfg)
    if slot_offset is not None:
        slot = slot - slot_offset
        mask = mask & (slot >= 0) & (slot < nc)
    slot = torch.where(mask, slot, nc)                       # invalid -> scrap index

    # reset stale slots touched by this insertion
    stored = cube_coord[torch.clamp(slot, max=nc - 1)]
    stale = torch.any(stored != coord, dim=-1) & mask
    touched = torch.zeros((nc + 1,), dtype=torch.bool, device=dev).index_put_((slot,), mask)[:nc]
    stale_slot = torch.zeros((nc + 1,), dtype=torch.int64, device=dev).index_add_(
        0, slot, stale.to(torch.int64))[:nc] > 0
    corner_cnt = torch.where(stale_slot, 0, corner_cnt)
    surf_cnt = torch.where(stale_slot, 0, surf_cnt)
    new_coord = torch.full((nc + 1, 3), INT32_MIN, dtype=torch.int64, device=dev)
    new_coord = new_coord.index_put_((slot,), coord)[:nc]
    cube_coord = torch.where(touched[:, None], new_coord, cube_coord)

    # rank within (slot, type) segments via one stable sort; rejects sort last
    key = torch.where(mask, slot * 2 + is_surf, 2 * nc)
    key_s, order = torch.sort(key, stable=True)
    pts_s = pts[order]
    idx = torch.arange(n, device=dev)
    is_start = torch.ones((n,), dtype=torch.bool, device=dev)
    is_start[1:] = key_s[1:] != key_s[:-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank = idx - seg_start

    slot_s = torch.clamp(key_s >> 1, max=nc - 1)
    surf_s = key_s & 1
    base = torch.where(surf_s == 1, capc + surf_cnt[slot_s], corner_cnt[slot_s])
    dest_row = base + rank
    ok = (key_s < 2 * nc) & (dest_row < torch.where(surf_s == 1, capT, capc))
    flat = torch.where(ok, slot_s * capT + dest_row, nc * capT)   # scrap slot row 0
    cube_pts.view(-1, 4).index_put_((flat,), pts_s)              # in place
    added = torch.zeros((2 * nc + 1,), dtype=torch.int64, device=dev).index_add_(
        0, torch.clamp(key_s, max=2 * nc), ok.to(torch.int64))[:2 * nc].reshape(nc, 2)
    accepted = torch.zeros((n,), dtype=torch.bool, device=dev)
    accepted[order] = ok
    return (corner_cnt + added[:, 0], surf_cnt + added[:, 1], cube_coord,
            accepted[:n_c], accepted[n_c:])


def _append(buf, n, pts_w, m):
    """Append the rows of pts_w where m holds after the valid prefix n of
    buf (rows past the capacity are dropped)."""
    cap = buf.shape[0]
    mi = m.to(torch.int64)
    rank = torch.cumsum(mi, 0) - mi
    dest = torch.where(m & (n + rank < cap), n + rank, cap)
    out = torch.cat([buf, buf.new_zeros((1, buf.shape[1]))])
    out.index_put_((dest,), pts_w)
    return out[:cap], torch.clamp(n + mi.sum(), max=cap)


def _refilter_cubes(cube_pts, corner_cnt, surf_cnt, slots, cfg: VloamConfig):
    """Re-voxel-downsample the submap window's cubes (laser_mapping.cpp:793-808),
    both feature types, each cube quantised from its own masked minimum.

    ``cube_pts`` is updated IN PLACE.  Slot ids outside [0, n_cubes) are
    gathered clipped and their results dropped (into the scrap slot).
    Returns (corner_cnt, surf_cnt)."""
    mc = cfg.mapping
    nc = corner_cnt.shape[0]
    capc, caps = mc.corner_cube_cap, mc.surf_cube_cap
    slots_c = torch.clamp(slots, 0, nc - 1)
    sub = cube_pts[slots_c]                                  # (75, capT, 4)

    def part(off, cap, cnt, leaf):
        m = torch.arange(cap, device=sub.device)[None, :] < cnt[slots_c][:, None]
        pts, msk = voxel_downsample_batched(sub[:, off:off + cap], m, leaf, cap, max_grid=256,
                                            presorted=False)
        return pts, msk.sum(dim=1)

    newc, ncnt = part(0, capc, corner_cnt, mc.line_resolution)
    news, scnt = part(capc, caps, surf_cnt, mc.plane_resolution)
    # the window's slots are distinct (it is smaller than the grid on every axis)
    dest = torch.where((slots >= 0) & (slots < nc), slots, nc)
    cube_pts.index_put_((dest,), torch.cat([newc, news], dim=1))   # in place

    def put(cnt, new):
        return torch.cat([cnt, cnt.new_zeros(1)]).index_put_((dest,), new)[:nc]

    return put(corner_cnt, ncnt), put(surf_cnt, scnt)


def mapping_step(state: MapState, corner_in, corner_in_mask, surf_in, surf_in_mask,
                 pose_wodom, cfg: VloamConfig, shard=None):
    """One mapping frame.  Returns (new_state, world pose after mapping).
    ``skip_frame`` is not read here: skipping frames is the caller's job
    (``models/vloam.vloam_step``).

    Host decisions per frame (each a device->host sync): whether the map
    holds enough points to register against, and on the insert-dedup path
    whether the submap cache must be rebuilt.

    With a ``shard`` context (``parallel/mapping_shard.ShardContext``) this
    is one rank of the sharded step: ``state`` is the rank's block, the
    window and the insertion take the slots from ``shard.slot_offset`` on,
    ``shard.centre`` makes the window centre the same on every rank,
    ``shard.total`` sums the map's counts over the ranks,
    ``shard.window_box`` gives the searches the whole window's rebase centre
    and ``shard.merge`` (nbr (M, k, 3), d2 (M, k)) -> the same, merged over
    the ranks, runs after each search."""
    mc = cfg.mapping
    dev = pose_wodom.device
    offset = None if shard is None else shard.slot_offset

    pose0 = geo.pose_compose(state.wmap_wodom, pose_wodom)
    corner_stack, cs_mask = voxel_downsample(
        corner_in, corner_in_mask, mc.line_resolution, mc.corner_stack_cap, max_grid=1024)
    surf_stack, ss_mask = voxel_downsample(
        surf_in, surf_in_mask, mc.plane_resolution, mc.surf_stack_cap, max_grid=512)

    center = cube_coord_of(geo.pose_t(pose0)[None, :], mc.cube_size)[0]
    if shard is not None:
        # every rank takes one window, so the host decisions below are the
        # same on every rank (float atomics may order a rank's sums
        # otherwise, and a pose within rounding of a cube face would split them)
        center = shard.centre(center)
    coords = _submap_coords(center, cfg)

    slots = None
    if not mc.insert_dedup or bool(torch.any(center != state.sub_center)):   # sync (dedup)
        (c_pts, cm), (s_pts, sm), slots, _ = _gather_submap(state, coords, cfg, offset)
        # the tail the dedup path appends frame by frame lies near the
        # current pose and needs no re-sort
        org = (center.to(torch.float32) * mc.cube_size)[None, :]
        c_pts, cm = morton_sort(c_pts, cm, SUBMAP_MORTON_CELL, org)
        s_pts, sm = morton_sort(s_pts, sm, SUBMAP_MORTON_CELL, org)
        c_n, s_n = cm.sum(), sm.sum()
    else:
        c_pts, s_pts = state.sub_c, state.sub_s
        c_n, s_n = state.sub_c_n.reshape(()), state.sub_s_n.reshape(())
    c_mask = torch.arange(c_pts.shape[0], device=dev) < c_n
    s_mask = torch.arange(s_pts.shape[0], device=dev) < s_n

    map_c, map_s = (c_n, s_n) if shard is None else shard.total(torch.stack([c_n, s_n])).unbind()
    cs_n, ss_n = cs_mask.sum(), ss_mask.sum()
    if bool((map_c > mc.min_map_corner) & (map_s > mc.min_map_surf)):  # sync
        # The search radius covers both consumers of these distances: the
        # fits gate at neighbor_dist_sq, the insert gate below at r_dedup^2.
        r_dedup = mc.insert_dedup_factor * max(mc.line_resolution, mc.plane_resolution)
        r_prune = max(float(mc.neighbor_dist_sq) ** 0.5, r_dedup) * 1.001
        # The search takes the stacks in Morton order (ring/azimuth order
        # sweeps the whole scan, so a tile of rows would span the scene; a
        # rigid transform keeps Morton-ordered tiles compact) and its results
        # go back to stack order.
        order_c = morton_order(corner_stack, cs_mask, STACK_MORTON_CELL)
        order_s = morton_order(surf_stack, ss_mask, STACK_MORTON_CELL)
        sorted_c, sorted_s = corner_stack[order_c, :3], surf_stack[order_s, :3]
        back_c, back_s = torch.argsort(order_c), torch.argsort(order_s)
        (c_cand, c_cmask), (s_cand, s_cmask) = (c_pts[:, :3], c_mask), (s_pts[:, :3], s_mask)
        if shard is not None:
            # every rank rebases to the whole window's centre, as the single step does
            (c_cand, c_cmask), (s_cand, s_cmask) = shard.window_box((c_cand, c_cmask),
                                                                    (s_cand, s_cmask))
        pose = pose0
        for _ in range(mc.outer_iters):
            (d2c, idxc), (d2s, idxs) = knn_pair(
                geo.pose_apply(pose, sorted_c), c_cand, c_cmask, mc.n_neighbors,
                geo.pose_apply(pose, sorted_s), s_cand, s_cmask, mc.n_neighbors,
                a_counts=(cs_n, c_n), b_counts=(ss_n, s_n),
                prune_radius=(r_prune, r_prune),
            )
            d2c, idxc, d2s, idxs = d2c[back_c], idxc[back_c], d2s[back_s], idxs[back_s]
            nbr_c, nbr_s = c_pts[idxc, :3], s_pts[idxs, :3]
            if shard is not None:
                (nbr_c, d2c), (nbr_s, d2s) = shard.merge(nbr_c, d2c), shard.merge(nbr_s, d2s)
            p_e, a_e, b_e, v_e = fit_corner_lines(corner_stack, cs_mask, nbr_c, d2c, cfg)
            p_s, n_s, d_s, v_s = fit_surf_planes(surf_stack, ss_mask, nbr_s, d2s, cfg)
            pose = solve_pose_gn_lidar(
                pose, (p_e, a_e, b_e, v_e), (p_s, n_s, d_s, v_s),
                mc.inner_iters, mc.huber_delta, mc.lm_lambda,
            )
        pose_w, nn_c, nn_s = pose, d2c[:, 0], d2s[:, 0]
    else:
        pose_w = pose0
        nn_c = torch.full(corner_stack.shape[:1], torch.inf, device=dev)
        nn_s = torch.full(surf_stack.shape[:1], torch.inf, device=dev)

    wmap_wodom = geo.pose_compose(pose_w, geo.pose_inverse(pose_wodom))

    # Insert the registered features: on the dedup path only those whose
    # nearest map point (from the last association pass) is farther than
    # half a voxel.
    corner_w = torch.cat([geo.pose_apply(pose_w, corner_stack[:, :3]), corner_stack[:, 3:]], 1)
    surf_w = torch.cat([geo.pose_apply(pose_w, surf_stack[:, :3]), surf_stack[:, 3:]], 1)
    ins_c, ins_s = cs_mask, ss_mask
    if mc.insert_dedup:
        ins_c = ins_c & (nn_c > (mc.insert_dedup_factor * mc.line_resolution) ** 2)
        ins_s = ins_s & (nn_s > (mc.insert_dedup_factor * mc.plane_resolution) ** 2)
    c_cnt, s_cnt, cube_coord, acc_c, acc_s = _scatter_insert_pair(
        corner_w, ins_c, surf_w, ins_s,
        state.cube_pts, state.corner_cnt, state.surf_cnt, state.cube_coord, cfg, offset,
    )

    if mc.insert_dedup:
        # Append this frame's accepted in-window points to the submap cache
        # so it stays exactly the set a fresh gather would produce.
        radii = torch.tensor([mc.submap_rx, mc.submap_rx, mc.submap_rz], device=dev)

        def in_window(pts_w):
            cc = cube_coord_of(pts_w[:, :3], mc.cube_size)
            return torch.all(torch.abs(cc - center[None, :]) <= radii[None, :], dim=-1)

        sub_c, sub_c_n = _append(c_pts, c_n, corner_w, acc_c & in_window(corner_w))
        sub_s, sub_s_n = _append(s_pts, s_n, surf_w, acc_s & in_window(surf_w))
        sub_c_n, sub_s_n = sub_c_n.reshape(state.sub_c_n.shape), sub_s_n.reshape(state.sub_s_n.shape)
        sub_center = center
    else:
        # the reference's policy: re-voxelise the window; the cache stays as it was
        c_cnt, s_cnt = _refilter_cubes(state.cube_pts, c_cnt, s_cnt, slots, cfg)
        sub_c, sub_c_n, sub_s, sub_s_n = state.sub_c, state.sub_c_n, state.sub_s, state.sub_s_n
        sub_center = state.sub_center

    return MapState(
        cube_pts=state.cube_pts, corner_cnt=c_cnt, surf_cnt=s_cnt,
        cube_coord=cube_coord, pose_map=pose_w, wmap_wodom=wmap_wodom,
        initialized=True,
        sub_c=sub_c, sub_c_n=sub_c_n, sub_s=sub_s, sub_s_n=sub_s_n,
        sub_center=sub_center,
    ), pose_w
