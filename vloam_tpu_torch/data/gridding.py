"""Host-side ring gridding — the data-layer half of scan registration.

A NumPy copy of ``vloam_tpu/data/gridding.py`` (``grid_cloud``,
``less_flat_voxel_table`` and ``depth_buckets``): the port cannot import the
reference package, whose ``__init__`` imports jax.  Tests check that the two
give equal arrays.

``grid_cloud`` builds the dense (n_scans, ring_cap) ring grid that
``ops.scan_registration.extract_features_from_grid`` consumes: ring id from
the vertical angle, azimuth relative time, min-range/NaN filter, scan-order
rank within the ring.  ``less_flat_voxel_table`` pre-reduces the less-flat
voxel runs on the host, and ``depth_buckets`` builds VO's lidar depth-bucket
grid.
"""

from __future__ import annotations

import numpy as np

from vloam_tpu_torch.config import ScanConfig, VisualConfig


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
    """Host half of the less-flat voxel reduction (scan_registration.cpp:496-504).

    Replicates ``ops.voxel.voxel_downsample(presorted=True, group_key=ring)``
    quantization and run-merge EXACTLY (p_min rebase, int key, invalid rows
    break runs), but over ALL valid grid cells — edge labels aren't known on
    the host.  The device then subtracts the <= R*S*20 edge-labeled cells
    from their runs (one tiny scatter) instead of segment-summing 131k rows.

    Returns (slot_grid (R, C) int32 — output slot per cell, -1 where invalid
    or past ``less_flat_cap``; base_sums (cap, 5) f32 — per-run sums of xyzw
    plus a count column; n_runs).
    """
    R, C = gmask.shape
    cap = cfg.less_flat_cap
    flat = grid.reshape(-1, 4)
    mask = gmask.reshape(-1)
    xyz = flat[:, :3]

    p_min = np.min(np.where(mask[:, None], xyz, np.float32(1e30)), axis=0)
    ijk = np.clip(
        np.floor((xyz - p_min) / np.float32(cfg.less_flat_voxel)).astype(np.int32),
        0, max_grid - 1,
    )
    key = ijk[:, 0] + max_grid * ijk[:, 1] + max_grid * max_grid * ijk[:, 2]
    key = np.where(mask, key, np.iinfo(np.int32).max)
    ring = np.repeat(np.arange(R, dtype=np.int32), C)

    new_seg = np.empty((R * C,), bool)
    new_seg[0] = True
    new_seg[1:] = (key[1:] != key[:-1]) | (ring[1:] != ring[:-1])
    new_seg &= mask
    seg_id = np.cumsum(new_seg.astype(np.int32)) - 1
    n_runs = int(new_seg.sum())
    slot = np.where(mask & (seg_id >= 0) & (seg_id < cap), seg_id, -1).astype(np.int32)

    ok = slot >= 0
    idx = np.where(ok, slot, cap)
    base = np.empty((cap, 5), np.float32)
    w = ok.astype(np.float32)
    for ch in range(4):
        base[:, ch] = np.bincount(idx, weights=flat[:, ch] * w, minlength=cap + 1)[:cap]
    base[:, 4] = np.bincount(idx, weights=w, minlength=cap + 1)[:cap]
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
    holds."""
    pts = np.asarray(points, np.float32)[:, :3]
    g = vc.downsample_grid
    bw = -(-vc.img_width // g)
    bh = -(-vc.img_height // g)

    uvz = pts @ proj[:, :3].T + proj[:, 3]
    z = uvz[:, 2]
    ok = np.asarray(mask, bool) & (z > vc.min_projection_depth)
    zs = np.maximum(z, 1e-6)
    u = uvz[:, 0] / zs
    v = uvz[:, 1] / zs
    ok &= np.isfinite(u) & np.isfinite(v)
    u = np.where(ok, u, 0.0)
    v = np.where(ok, v, 0.0)
    ix = (u / g).astype(np.int32)
    iy = (v / g).astype(np.int32)
    ok &= (u >= 0) & (v >= 0) & (ix >= 0) & (ix < bw) & (iy >= 0) & (iy < bh)

    flat = np.where(ok, ix * bh + iy, bw * bh)
    nb = bw * bh
    wts = ok.astype(np.float32)
    cnt = np.bincount(flat, weights=wts, minlength=nb + 1)[:nb]
    su = np.bincount(flat, weights=u * wts, minlength=nb + 1)[:nb]
    sv = np.bincount(flat, weights=v * wts, minlength=nb + 1)[:nb]
    sz = np.bincount(flat, weights=z * wts, minlength=nb + 1)[:nb]
    denom = np.maximum(cnt, 1.0)
    return (
        (su / denom).astype(np.float32).reshape(bw, bh),
        (sv / denom).astype(np.float32).reshape(bw, bh),
        (sz / denom).astype(np.float32).reshape(bw, bh),
        cnt.astype(np.float32).reshape(bw, bh),
    )
