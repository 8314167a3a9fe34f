"""Host-side ring gridding -- the data-layer half of scan registration.

``grid_cloud`` is a NumPy copy of ``vloam_tpu_torch/data/gridding.py`` at
commit 2b93434, the gridding the program's ``VloamDriver.process`` runs.  It
builds the dense (n_scans, ring_cap) ring grid that
``ops.scan_registration.extract_features_from_grid`` consumes: ring id from
the vertical angle, azimuth relative time, min-range/NaN filter, scan-order
rank within the ring.

``less_flat_voxel_table`` (the less-flat voxel runs pre-reduced on the host)
and ``depth_buckets`` (VO's lidar depth-bucket grid) compute what the
program's driver gets from its host library (``native/vloam_host.cpp``),
written anew in NumPy from that source's arithmetic: float32 throughout,
sums in scan order.  The port's NumPy fallbacks sum in float64 and differ
from the library by rounding; the benchmark's tests hold these two equal to
the library bit for bit.
"""

from __future__ import annotations

import numpy as np

from plainref.config import ScanConfig, VisualConfig


def grid_cloud(
    points: np.ndarray,      # (N, 3) or (N, 4) raw cloud (any padding stripped by caller)
    cfg: ScanConfig,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Raw cloud -> (grid (R, C, 4) xyzw, gmask (R, C), n_per_ring (R,)).

    w = ring + scan_period * rel_time, the reference's intensity encoding
    (scan_registration.cpp:294-297).
    """
    pts = np.asarray(points, np.float32)[:, :3]
    R, C = cfg.n_scans, cfg.ring_cap

    finite = np.isfinite(pts).all(axis=1)
    pts = np.where(finite[:, None], pts, 0.0)
    r = np.linalg.norm(pts, axis=1)
    mask = finite & (r >= cfg.minimum_range)

    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    horiz = np.sqrt(x * x + y * y)
    angle = np.degrees(np.arctan2(z, np.maximum(horiz, 1e-12)))

    if cfg.n_scans == 16:
        sid = ((angle + 15.0) / 2.0 + 0.5).astype(np.int32)
        ok = (sid >= 0) & (sid <= cfg.n_scans - 1)
    elif cfg.n_scans == 32:
        sid = ((angle + 92.0 / 3.0) * 3.0 / 4.0).astype(np.int32)
        ok = (sid >= 0) & (sid <= cfg.n_scans - 1)
    elif cfg.n_scans == 64:
        upper = ((2.0 - angle) * 3.0 + 0.5).astype(np.int32)
        lower = cfg.n_scans // 2 + ((-8.83 - angle) * 2.0 + 0.5).astype(np.int32)
        sid = np.where(angle >= -8.83, upper, lower)
        ok = (angle <= 2.0) & (angle >= -24.33) & (sid >= 0) & (sid <= 50)
    else:
        raise ValueError(f"unsupported n_scans={cfg.n_scans}")
    mask = mask & ok
    ring = np.clip(sid, 0, R - 1)

    # azimuth relative time (device organize_scan / relative_times semantics)
    ori = -np.arctan2(pts[:, 1], pts[:, 0])
    valid_idx = np.flatnonzero(mask)
    if valid_idx.size:
        start = ori[valid_idx[0]]
        end = ori[valid_idx[-1]] + 2.0 * np.pi
        if end - start > 3.0 * np.pi:
            end -= 2.0 * np.pi
        elif end - start < np.pi:
            end += 2.0 * np.pi
        sweep = max(end - start, 1e-6)
    else:
        start, sweep = 0.0, 1.0
    rel = np.clip(np.mod(ori - start, 2.0 * np.pi) / sweep, 0.0, 1.0)
    w = ring.astype(np.float32) + cfg.scan_period * rel.astype(np.float32)

    grid = np.zeros((R, C, 4), np.float32)
    gmask = np.zeros((R, C), bool)
    n_per_ring = np.zeros((R,), np.int32)

    # rank within ring, scan order preserved (vectorised counting sort)
    order = np.argsort(np.where(mask, ring, R), kind="stable")
    ring_s = np.where(mask, ring, R)[order]
    starts = np.searchsorted(ring_s, np.arange(R + 1))
    for rr in range(R):
        idx = order[starts[rr]:starts[rr + 1]][:C]
        n = idx.size
        grid[rr, :n, :3] = pts[idx]
        grid[rr, :n, 3] = w[idx]
        gmask[rr, :n] = True
        n_per_ring[rr] = n
    return grid, gmask, n_per_ring


def less_flat_voxel_table(
    grid: np.ndarray,        # (R, C, 4) ring grid (grid_cloud output)
    gmask: np.ndarray,       # (R, C)
    cfg: ScanConfig,
    max_grid: int = 1024,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Host half of the less-flat voxel reduction (scan_registration.cpp:496-504),
    with the arithmetic of the host library the program's driver calls
    (``vh_lf_voxel_table`` in ``native/vloam_host.cpp``): the voxel index is
    ``floor((x - p_min) * (1 / leaf))`` in float32, runs break where the key
    or the ring changes or a cell is invalid, and each run's sums are float32
    additions in scan order.

    Returns (slot_grid (R, C) int32 -- output slot per cell, -1 where invalid
    or past ``less_flat_cap``; base_sums (cap, 5) f32 -- per-run sums of xyzw
    plus a count column; n_runs).
    """
    R, C = gmask.shape
    cap = cfg.less_flat_cap
    flat = np.ascontiguousarray(grid.reshape(-1, 4), np.float32)
    mask = gmask.reshape(-1).astype(bool)
    xyz = flat[:, :3]

    p_min = np.min(np.where(mask[:, None], xyz, np.float32(1e30)), axis=0).astype(np.float32)
    inv = np.float32(1.0) / np.float32(cfg.less_flat_voxel)
    ijk = np.clip(np.floor((xyz - p_min) * inv).astype(np.int64), 0, max_grid - 1)
    key = ijk[:, 0] + (ijk[:, 1] << 10) + (ijk[:, 2] << 20)
    ring = np.repeat(np.arange(R, dtype=np.int64), C)

    # a run starts at a valid cell whose predecessor is invalid or differs in key or ring
    prev_ok = np.concatenate([[False], mask[:-1]])
    new_seg = mask & (~prev_ok | np.concatenate([[True], (key[1:] != key[:-1])
                                                 | (ring[1:] != ring[:-1])]))
    seg_id = np.cumsum(new_seg) - 1
    n_runs = int(new_seg.sum())
    slot = np.where(mask & (seg_id < cap), seg_id, -1).astype(np.int32)

    ok = slot >= 0
    base = np.zeros((cap, 5), np.float32)
    rows = np.concatenate([flat[ok], np.ones((int(ok.sum()), 1), np.float32)], 1)
    np.add.at(base, slot[ok], rows)            # float32, in scan order
    return slot.reshape(R, C), base, min(n_runs, cap)


def depth_buckets(
    points: np.ndarray,      # (N, 3) velodyne cloud (or (N, >=3); extra cols ignored)
    mask: np.ndarray,        # (N,) bool
    proj: np.ndarray,        # (3, 4) = P_rect0 @ rect0_T_cam @ cam_T_velo
    vc: VisualConfig,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The lidar->camera depth-bucket grid (point_cloud_util.cpp:183-324
    semantics): project the cloud, average hits per 5 px bucket.  Returns
    (u, v, z, count), each (BW, BH) f32, what ``ops.depth_map.DepthBuckets``
    holds.  The arithmetic is the host library's (``vh_depth_buckets`` in
    ``native/vloam_host.cpp``): each projection row summed left to right in
    float32, float32 sums in point order, then one division a bucket."""
    pts = np.asarray(points, np.float32)[:, :3]
    pr = np.asarray(proj, np.float32)
    g = vc.downsample_grid
    bw = -(-vc.img_width // g)
    bh = -(-vc.img_height // g)
    x, y, zc = pts[:, 0], pts[:, 1], pts[:, 2]

    def row(k):
        return pr[k, 0] * x + pr[k, 1] * y + pr[k, 2] * zc + pr[k, 3]

    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        pu, pv, pz = row(0), row(1), row(2)
        ok = np.asarray(mask, bool) & (pz > np.float32(vc.min_projection_depth))
        zs = np.maximum(pz, np.float32(1e-6))
        u, v = pu / zs, pv / zs
        ok &= ~((u < 0) | (v < 0))
        ix = np.where(ok, u / np.float32(g), 0).astype(np.int32)
        iy = np.where(ok, v / np.float32(g), 0).astype(np.int32)
    ok &= (ix >= 0) & (ix < bw) & (iy >= 0) & (iy < bh)

    b = ix[ok] * bh + iy[ok]
    sums = np.zeros((bw * bh, 4), np.float32)
    np.add.at(sums, b, np.stack([u[ok], v[ok], pz[ok], np.ones_like(u[ok])], 1))
    cnt = sums[:, 3]
    c = np.maximum(cnt, np.float32(1.0))
    return tuple(a.reshape(bw, bh) for a in (sums[:, 0] / c, sums[:, 1] / c, sums[:, 2] / c,
                                             cnt))
