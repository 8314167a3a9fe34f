"""LOAM feature extraction from a host-built ring grid (port of
``vloam_tpu/ops/scan_registration.extract_features_from_grid``).

The cloud lives on a dense (n_scans, ring_cap) grid, points in scan order
within each ring, so the 11-point curvature and the +-5 neighbour
suppression are shifts along the ring axis.  The greedy per-(ring, sector)
edge/planar selection runs as K masked-argmax rounds over all sectors at
once, on each sector's top-64 candidates.

Feature points are (x, y, z, w) with w = ring + 0.1 * rel_time.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vloam_tpu_torch.config import ScanConfig
from vloam_tpu_torch.ops.voxel import voxel_downsample

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
    sits mid-run."""
    if cfg.exclude_unreliable:
        raise NotImplementedError(
            "ScanConfig.exclude_unreliable is not ported yet (ROADMAP A5)")
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
        edge_lab = torch.zeros((R, C + 1), dtype=torch.bool, device=dev)
        edge_lab[torch.arange(R, device=dev)[:, None],
                 torch.where(edge_valid, edge_slots, C).reshape(R, -1)] = True
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
