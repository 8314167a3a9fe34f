"""LOAM feature extraction (port of ``vloam_tpu/ops/scan_registration.py``).

The cloud lives on a dense (n_scans, ring_cap) grid, points in scan order
within each ring, so the 11-point curvature, the +-5 neighbour suppression
and the unreliable-point marking are shifts along the ring axis.  The grid
comes from the host (``data/gridding.grid_cloud``, the main path) or from
``organize_scan`` on the device (``extract_features``, a raw padded cloud).
The greedy per-(ring, sector) edge/planar selection runs as K masked-argmax
rounds over all sectors at once, on each sector's top-64 candidates.

Feature points are (x, y, z, w) with w = ring + 0.1 * rel_time.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from plainref.config import ScanConfig
from plainref.ops.voxel import voxel_downsample

NCAND = 64   # per-sector candidate pre-reduction width
_RB = 3      # bits per suppression reach packed into the score mantissa
_RMASK = (1 << (2 * _RB)) - 1


class ScanFeatures(NamedTuple):
    """Fixed-shape feature clouds for one lidar frame (all xyzw)."""

    sharp: torch.Tensor          # (R*S*2, 4)
    sharp_mask: torch.Tensor     # (R*S*2,)
    less_sharp: torch.Tensor     # (R*S*20, 4)
    less_sharp_mask: torch.Tensor
    flat: torch.Tensor           # (R*S*4, 4)
    flat_mask: torch.Tensor
    less_flat: torch.Tensor      # (less_flat_cap, 4)
    less_flat_mask: torch.Tensor


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, as ``jnp.linalg.norm`` forms it."""
    return torch.sqrt(torch.sum(x * x, dim=-1))


def assign_rings(points: torch.Tensor, mask: torch.Tensor, cfg: ScanConfig):
    """Vertical angle -> ring id per the reference's sensor formulas
    (scan_registration.cpp:217-254; C truncation toward zero).  Returns
    (ring (N,) int32, valid (N,) bool)."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    horiz = torch.sqrt(x * x + y * y)
    angle = torch.atan2(z, torch.clamp(horiz, min=1e-12)) * (180.0 / math.pi)
    if cfg.n_scans == 16:
        sid = ((angle + 15.0) / 2.0 + 0.5).to(torch.int32)
        ok = (sid >= 0) & (sid <= cfg.n_scans - 1)
    elif cfg.n_scans == 32:
        sid = ((angle + 92.0 / 3.0) * 3.0 / 4.0).to(torch.int32)
        ok = (sid >= 0) & (sid <= cfg.n_scans - 1)
    elif cfg.n_scans == 64:
        upper = ((2.0 - angle) * 3.0 + 0.5).to(torch.int32)
        lower = cfg.n_scans // 2 + ((-8.83 - angle) * 2.0 + 0.5).to(torch.int32)
        sid = torch.where(angle >= -8.83, upper, lower)
        ok = (angle <= 2.0) & (angle >= -24.33) & (sid >= 0) & (sid <= 50)
    else:
        raise ValueError(f"unsupported n_scans={cfg.n_scans}")
    return sid, mask & ok


def relative_times(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Azimuth relative time in [0, 1] (the startOri/endOri unwrap of
    scan_registration.cpp:185-294): ((-atan2(y, x)) - start) mod 2 pi over
    the sweep from the first to the last valid point."""
    ori = -torch.atan2(points[:, 1], points[:, 0])
    n = points.shape[0]
    m8 = mask.to(torch.uint8)
    first = torch.argmax(m8).view(1)                       # first valid index
    last = (n - 1 - torch.argmax(m8.flip(0))).view(1)      # last valid index
    start = ori.index_select(0, first)
    end = ori.index_select(0, last) + 2.0 * math.pi
    end = torch.where(end - start > 3.0 * math.pi, end - 2.0 * math.pi,
                      torch.where(end - start < math.pi, end + 2.0 * math.pi, end))
    sweep = torch.clamp(end - start, min=1e-6)
    # jnp.mod: fmod, then moved into [0, 2 pi)
    rel = torch.fmod(ori - start, 2.0 * math.pi)
    rel = torch.where(rel < 0, rel + 2.0 * math.pi, rel)
    return torch.clamp(rel / sweep, 0.0, 1.0)


def organize_scan(points: torch.Tensor, mask: torch.Tensor, cfg: ScanConfig):
    """Raw padded cloud (N, >=3) + mask (N,) -> (grid (R, C, 4) xyzw, grid
    mask (R, C), n_per_ring (R,) int32).  Points keep their scan order
    within each ring; each ring's valid points fill columns [0, n_r).  The
    device twin of ``data/gridding.grid_cloud``."""
    R, C = cfg.n_scans, cfg.ring_cap
    dev = points.device
    xyz = points[:, :3]
    mask = (mask & (_norm(xyz) >= cfg.minimum_range)
            & torch.all(torch.isfinite(xyz), dim=-1))
    ring, mask = assign_rings(points, mask, cfg)
    rel = relative_times(points, mask)
    pts4 = torch.cat([xyz, (ring.to(torch.float32) + cfg.scan_period * rel)[:, None]], dim=1)

    # rank within the ring = the number of earlier valid points of that ring:
    # a one-hot cumsum keeps scan order without a sort.  The one-hot is (R, N)
    # int32 so the scan runs along the contiguous axis: along the outer axis
    # of an (N, R) one-hot, CUDA's scan runs one thread a column and was most
    # of the raw step's time (chip_smoke.py phase 11).
    oh = ((ring[None, :] == torch.arange(R, dtype=torch.int32, device=dev)[:, None])
          & mask[None, :]).to(torch.int32)
    before = torch.cumsum(oh, dim=1, dtype=torch.int32) - oh
    rank = torch.gather(before, 0, torch.clamp(ring, 0, R - 1).to(torch.int64)[None, :])[0]

    ok = mask & (rank < C)
    # every valid point has its own cell; the rest land on a scrap row
    flat_idx = torch.where(ok, ring.to(torch.int64) * C + rank, R * C)
    grid = torch.zeros((R * C + 1, 4), dtype=torch.float32, device=dev)
    grid.index_put_((flat_idx,), torch.where(ok[:, None], pts4, 0.0))
    gmask = torch.zeros((R * C + 1,), dtype=torch.bool, device=dev)
    gmask.index_put_((flat_idx,), ok)
    gmask = gmask[:-1].reshape(R, C)
    return grid[:-1].reshape(R, C, 4), gmask, gmask.sum(dim=1, dtype=torch.int32)


def ring_curvature(grid, n_per_ring, cfg: ScanConfig):
    """11-point curvature per grid cell + selectability mask (cells without
    ``curvature_window`` neighbours on both sides are unselectable)."""
    xyz = grid[..., :3]
    w = cfg.curvature_window
    acc = -2.0 * w * xyz
    for l in range(1, w + 1):
        acc = acc + torch.roll(xyz, l, dims=1) + torch.roll(xyz, -l, dims=1)
    curv = torch.sum(acc * acc, dim=-1)
    col = torch.arange(grid.shape[1], device=grid.device)[None, :]
    selectable = (col >= w) & (col <= n_per_ring[:, None] - w - 1)
    return curv, selectable


def unreliable_mask(grid: torch.Tensor, gmask: torch.Tensor, cfg: ScanConfig) -> torch.Tensor:
    """Original LOAM's occluded and parallel-beam marking: (R, C) bool, True
    = not selectable as a feature (loam_velodyne scanRegistration.cpp, the
    cloudNeighborPicked pre-pass, which the A-LOAM-derived reference drops).

    * Occlusion: ring neighbours i, i+1 more than 0.1 m^2 apart and on
      nearly the same ray (the farther point scaled to the nearer depth lies
      within 0.1 of that depth) are a silhouette edge; the 6 points on the
      farther side are marked.
    * Parallel beam: a point whose squared gaps to both ring neighbours
      exceed 0.0002 * depth^2 lies on a surface nearly parallel to the beam.
    """
    xyz = grid[..., :3]
    r = _norm(xyz)
    nxt = torch.roll(xyz, -1, dims=1)
    r_nxt = torch.roll(r, -1, dims=1)
    pair_ok = gmask & torch.roll(gmask, -1, dims=1)
    diff_next = torch.sum((nxt - xyz) ** 2, dim=-1)

    # occlusion: i farther -> mark i-5..i; i+1 farther -> mark i+1..i+6; the
    # gate divides by the farther depth (the reference's comment explains why)
    big = pair_ok & (diff_next > 0.1)
    safe_rn = torch.clamp(r_nxt, min=1e-6)
    safe_r = torch.clamp(r, min=1e-6)
    d_far_i = _norm(nxt * (r / safe_rn)[..., None] - xyz)
    d_far_n = _norm(nxt - xyz * (r_nxt / safe_r)[..., None])
    mark_back = big & (r > r_nxt) & (d_far_i / safe_r < 0.1)
    mark_fwd = big & (r <= r_nxt) & (d_far_n / safe_rn < 0.1)
    unrel = torch.zeros_like(gmask)
    for l in range(6):
        unrel = unrel | torch.roll(mark_back, -l, dims=1)       # edge at i+l
        unrel = unrel | torch.roll(mark_fwd, l + 1, dims=1)     # edge at i-1-l

    # parallel beam: both neighbour gaps > 0.0002 * depth^2
    diff_prev = torch.roll(diff_next, 1, dims=1)
    prev_ok = torch.roll(pair_ok, 1, dims=1)
    thresh = 0.0002 * r * r
    return unrel | (pair_ok & prev_ok & (diff_next > thresh) & (diff_prev > thresh))


def _suppression_reach(grid, gmask, cfg: ScanConfig):
    """Forward/backward suppression reach per cell: after picking point i,
    i+1..i+5 are suppressed while consecutive squared gaps stay <=
    ``suppression_gap_sq`` (and symmetrically backwards)."""
    xyz = grid[..., :3]
    nxt = torch.roll(xyz, -1, dims=1)
    gap_ok = torch.sum((nxt - xyz) ** 2, dim=-1) <= cfg.suppression_gap_sq
    gap_ok = gap_ok & gmask & torch.roll(gmask, -1, dims=1)

    w = cfg.neighbor_suppression
    fwd = torch.zeros(gap_ok.shape, dtype=torch.int32, device=grid.device)
    run = torch.ones_like(gap_ok)
    for l in range(w):
        run = run & torch.roll(gap_ok, -l, dims=1)
        fwd = fwd + run.to(torch.int32)
    prv_gap_ok = torch.roll(gap_ok, 1, dims=1)
    bwd = torch.zeros_like(fwd)
    run = torch.ones_like(gap_ok)
    for l in range(w):
        run = run & torch.roll(prv_gap_ok, l, dims=1)
        bwd = bwd + run.to(torch.int32)
    return fwd, bwd


def _top_desc(scores: torch.Tensor, k: int):
    """Row-wise k largest in descending order, ties to the lower column (the
    order ``lax.top_k`` gives and the greedy rounds rely on)."""
    vals, cols = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), cols[:, :k].contiguous()


def _greedy(vals, cols, n_rounds):
    """n_rounds of pick-best + suppress over the candidate axis.  The reach
    of each candidate rides in its score's 6 low mantissa bits."""
    sup = torch.zeros(vals.shape, dtype=torch.bool, device=vals.device)
    sel_col, sel_val, sel_f, sel_b = [], [], [], []
    for _ in range(n_rounds):
        score = torch.where(sup, -torch.inf, vals)
        pick = torch.argmax(score, dim=-1)[:, None]
        v_sel = torch.gather(score, 1, pick)[:, 0]
        has = v_sel > -torch.inf
        col_sel = torch.gather(cols, 1, pick)[:, 0]
        bits = v_sel.view(torch.int32)
        f_sel = (bits >> _RB) & ((1 << _RB) - 1)
        b_sel = bits & ((1 << _RB) - 1)
        within = (cols >= (col_sel - b_sel)[:, None]) & (cols <= (col_sel + f_sel)[:, None])
        within = within | (cols == col_sel[:, None])
        sup = sup | (within & has[:, None])
        sel_col.append(col_sel)
        sel_val.append(has)
        sel_f.append(f_sel)
        sel_b.append(b_sel)
    stack = lambda xs: torch.stack(xs, dim=1)  # noqa: E731
    return stack(sel_col), stack(sel_val), stack(sel_f), stack(sel_b)


def extract_features(points: torch.Tensor, mask: torch.Tensor, cfg: ScanConfig) -> ScanFeatures:
    """Raw padded cloud -> LOAM feature clouds: ``organize_scan``, then the
    device-side less-flat reduction (``lf_table=None``)."""
    grid, gmask, n_per_ring = organize_scan(points, mask, cfg)
    return extract_features_from_grid(grid, gmask, n_per_ring, cfg)


def extract_features_from_grid(
    grid: torch.Tensor,        # (R, C, 4) xyzw ring grid
    gmask: torch.Tensor,       # (R, C) bool
    n_per_ring: torch.Tensor,  # (R,) int
    cfg: ScanConfig,
    lf_table=None,             # (slot_grid (R, C) int, base_sums (cap, 5) f32, n_runs) or None
) -> ScanFeatures:
    """Scan registration from a pre-built ring grid.

    With the host less-flat voxel table (``data/gridding.less_flat_voxel_table``)
    the device only subtracts the edge-labelled cells from their runs, and
    output slots of runs emptied by the subtraction stay masked holes.
    Without it (``lf_table=None``) the less-flat cloud is one run-merge over
    all rings, keyed by ring id, of the valid cells that are not edges: the
    reference's per-ring voxel filter, and what loop closure extracts its
    keyframe features with.  The two give different rows wherever an edge
    sits mid-run.  ``cfg.exclude_unreliable`` removes ``unreliable_mask``'s
    points from the edge and planar candidates."""
    dev = grid.device
    curv, selectable = ring_curvature(grid, n_per_ring, cfg)
    fwd, bwd = _suppression_reach(grid, gmask, cfg)

    R, C = gmask.shape
    S = cfg.n_sectors
    col = torch.arange(C, device=dev)[None, :]

    # Sector id per cell: [start+w, end-w-1] split into S equal index ranges.
    w = cfg.curvature_window
    n_per_ring = n_per_ring.to(torch.int64)
    span = torch.clamp(n_per_ring[:, None] - 2 * w - 1, min=1)
    sector = torch.clamp(((col - w) * S) // span, 0, S - 1)
    ring_ok = (n_per_ring[:, None] - 2 * w - 1) >= 6
    selectable = selectable & gmask & ring_ok
    if cfg.exclude_unreliable:
        selectable = selectable & ~unreliable_mask(grid, gmask, cfg)
    sector_oh = sector[:, None, :] == torch.arange(S, device=dev)[None, :, None]  # (R, S, C)

    RS = R * S
    # Suppression reach rides in the score's 6 low mantissa bits (3 bits each
    # way), exactly as in the reference: the perturbation is < 2^-17
    # relative, and the greedy picks then match the reference's.
    reach_bits = (fwd << _RB) | bwd

    def _pack(v):
        return ((v.contiguous().view(torch.int32) & ~_RMASK) | reach_bits).view(torch.float32)

    score_e = torch.where(
        (selectable & (curv > cfg.edge_threshold))[:, None, :] & sector_oh,
        _pack(curv)[:, None, :], -torch.inf,
    ).reshape(RS, C)
    ce_val, ce_col = _top_desc(score_e, NCAND)          # descending curvature
    score_f = torch.where(
        (selectable & (curv < cfg.surf_threshold))[:, None, :] & sector_oh,
        _pack(-curv)[:, None, :], -torch.inf,
    ).reshape(RS, C)
    cf_val, cf_col = _top_desc(score_f, NCAND)          # ascending curvature

    e_col, e_val, e_fr, e_br = _greedy(ce_val, ce_col, cfg.max_less_sharp)

    # edge picks suppress flat candidates within their reach
    cross = (
        (cf_col[:, :, None] >= (e_col - e_br)[:, None, :])
        & (cf_col[:, :, None] <= (e_col + e_fr)[:, None, :])
        & e_val[:, None, :]
    )
    cf_val = torch.where(torch.any(cross, dim=-1), -torch.inf, cf_val)

    f_col, f_val, _, _ = _greedy(cf_val, cf_col, cfg.max_flat)

    edge_slots = e_col.reshape(R, S, cfg.max_less_sharp)
    edge_valid = e_val.reshape(R, S, cfg.max_less_sharp)
    flat_slots = f_col.reshape(R, S, cfg.max_flat)
    flat_valid = f_val.reshape(R, S, cfg.max_flat)

    def gather_slots(slots, valid, k):
        idx = slots[:, :, :k].reshape(R, -1)
        v = valid[:, :, :k].reshape(R, -1)
        pts = torch.gather(grid, 1, idx[..., None].expand(-1, -1, 4))
        pts = torch.where(v[..., None], pts, 0.0)
        return pts.reshape(-1, 4), v.reshape(-1)

    sharp, sharp_mask = gather_slots(edge_slots, edge_valid, cfg.max_sharp)
    less_sharp, less_sharp_mask = gather_slots(edge_slots, edge_valid, cfg.max_less_sharp)
    flat, flat_mask = gather_slots(flat_slots, flat_valid, cfg.max_flat)

    if lf_table is None:
        # a scatter of the scalar: assigning it through index tensors
        # (edge_lab[rows, cols] = True) synchronised with the card
        edge_lab = torch.zeros((R, C + 1), dtype=torch.bool, device=dev).scatter_(
            1, torch.where(edge_valid, edge_slots, C).reshape(R, -1), True)
        lf_mask = gmask & ~edge_lab[:, :C]
        ring_id = torch.arange(R, device=dev)[:, None].expand(R, C)
        less_flat, less_flat_mask = voxel_downsample(
            grid.reshape(-1, 4), lf_mask.reshape(-1), cfg.less_flat_voxel, cfg.less_flat_cap,
            group_key=ring_id.reshape(-1), max_grid=1024)
        return ScanFeatures(sharp, sharp_mask, less_sharp, less_sharp_mask, flat, flat_mask,
                            less_flat, less_flat_mask)

    # Less-flat: the host runs minus the edge-labelled cells.
    slot_grid, base_sums, n_runs = lf_table
    cap = cfg.less_flat_cap
    e_cols = edge_slots.reshape(R, -1)
    e_ok = edge_valid.reshape(R, -1)
    slot_e = torch.gather(slot_grid.to(torch.int64), 1, e_cols)
    slot_e = torch.where(e_ok & (slot_e >= 0), slot_e, cap).reshape(-1)
    aug_e = torch.cat([less_sharp, less_sharp_mask[:, None].to(torch.float32)], dim=1)
    # rejects land on a scrap row past the end (the reference's mode="drop");
    # float atomics on CUDA: the summation order varies from run to run
    sums = torch.cat([base_sums, base_sums.new_zeros((1, 5))])
    sums = sums.index_add_(0, slot_e, -aug_e)[:cap]
    cnt = sums[:, 4]
    live = (torch.arange(cap, device=dev) < n_runs) & (cnt > 0.5)
    less_flat = torch.where(live[:, None], sums[:, :4] / torch.clamp(cnt, min=1.0)[:, None], 0.0)

    return ScanFeatures(
        sharp, sharp_mask, less_sharp, less_sharp_mask, flat, flat_mask, less_flat, live
    )
