"""Hashed cell-list nearest-neighbour tables, the radius-bounded kd-tree
(port of ``vloam_tpu/ops/cellhash.py``, plain PyTorch: the reference op is
XLA gathers and scatters, not a TPU kernel, so it has no hand-written one).

The mapping correspondences only ever use neighbours closer than 1 m: every
consumer gates on ``pointSearchSqDis[4] < 1.0`` (reference
laser_mapping.cpp:557,642) and the insert-dedup radius is 0.2/0.4 m, so
almost every candidate distance a brute-force k-NN evaluates is irrelevant.

STATUS (the reference's, kept): measured, and NOT wired into the mapping hot
path; the brute k-NN kernels (``ops/knn``, ``ops/fused_knn``) run there.
The op is kept, and tested against the reference and a NumPy oracle, for
regimes where brute force is infeasible: host-side queries against very
large maps, or candidate counts where O(M N) loses to O(M cap 27).  What it
costs on the card is printed by ``chip_smoke.py`` beside the brute k-NN on
the same points (PERF.md).

The method is the classic cell list, laid out for fixed shapes: candidates
are scattered into an open-hashed table of spatial cells (edge = the 1 m
gate radius), and each query examines only the 27 buckets of its 3x3x3 cell
neighbourhood.  All points within the gate radius lie in that
neighbourhood, so the result equals brute force for every neighbour that can
affect the fits; points beyond the gate may be missed, but they are
discarded by the gate anyway.

Hash collisions are benign by construction:
  * two *far* cells sharing a bucket only add candidates that the distance
    test rejects;
  * two of a query's 27 *neighbour* cells hashing to the same bucket would
    double-count its points, so duplicate bucket ids are masked per query;
  * bucket-capacity overflow drops points (same policy as cube capacity).

Empty slots hold a far-away sentinel coordinate instead of a validity mask,
so the query path needs no mask gather.  Tables are (table_size, cap * 4),
the reference's layout.  The search is exact (the reference's CPU branch;
its TPU branch's ``approx_min_k`` is not ported): ties go to the lower slot,
as ``lax.top_k`` breaks them.
"""

from __future__ import annotations

import torch

from vloam_tpu_torch.ops.voxel import div_exact

_INF = 3.4e38
SENTINEL = 1e6     # empty-slot coordinate; d2 ~ 3e12 << _INF
_P1, _P2, _P3 = 73856093, 19349663, 83492791   # standard spatial-hash primes


def cell_hash(cell: torch.Tensor, table_size: int) -> torch.Tensor:
    """(..., 3) integer cell coords -> int64 bucket id in [0, table_size).

    table_size must be a power of two (masked, not modded).  The products
    are taken in int64: their low bits, all the mask keeps, are those of the
    reference's wrapping int32 arithmetic."""
    if table_size <= 0 or table_size & (table_size - 1):
        raise ValueError(f"cell_hash: table_size {table_size} is not a power of two")
    c = cell.to(torch.int64)
    h = (c[..., 0] * _P1) ^ (c[..., 1] * _P2) ^ (c[..., 2] * _P3)
    return h & (table_size - 1)


def _cells(pts: torch.Tensor, cell_size: float) -> torch.Tensor:
    return torch.floor(div_exact(pts[..., :3], cell_size)).to(torch.int32)


def _bucket_ranks(h_sorted: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its (sorted-key) run."""
    n = h_sorted.shape[0]
    idx = torch.arange(n, device=h_sorted.device)
    is_start = torch.ones(n, dtype=torch.bool, device=h_sorted.device)
    is_start[1:] = h_sorted[1:] != h_sorted[:-1]
    return idx - torch.cummax(torch.where(is_start, idx, 0), dim=0).values


def _sorted_by_bucket(pts, mask, cell_size: float, table_size: int):
    """(bucket ids sorted, the points in that order, each one's rank in its
    bucket); masked-out points carry the id table_size and sort last."""
    h = torch.where(mask, cell_hash(_cells(pts, cell_size), table_size), table_size)
    h_s, order = torch.sort(h, stable=True)
    return h_s, pts[order], _bucket_ranks(h_s)


def _bucket_sums(ok: torch.Tensor, h_s: torch.Tensor, table_size: int) -> torch.Tensor:
    """Per bucket, how many of the sorted points are ``ok`` (int32)."""
    seg = torch.clamp(h_s, max=table_size)
    out = torch.zeros(table_size + 1, dtype=torch.int32, device=ok.device)
    return out.index_add_(0, seg, ok.to(torch.int32))[:table_size]


def empty_cell_table(table_size: int, cap: int, device) -> torch.Tensor:
    """(table_size, cap*4) table with every slot at the sentinel, on
    ``device`` (the rest of the op follows its inputs' device)."""
    return torch.full((table_size, cap * 4), SENTINEL, dtype=torch.float32, device=device)


def build_cell_table(pts: torch.Tensor, mask: torch.Tensor, cell_size: float, table_size: int,
                     cap: int):
    """Scatter points (N, 4) xyzw with mask (N,) into (table_size, cap*4)
    buckets; returns (table, counts (table_size,) int32)."""
    h_s, pts_s, rank = _sorted_by_bucket(pts, mask, cell_size, table_size)
    ok = (h_s < table_size) & (rank < cap)
    dest = torch.where(ok, h_s * cap + rank, table_size * cap)
    tbl = torch.full((table_size * cap + 1, 4), SENTINEL, dtype=torch.float32, device=pts.device)
    tbl[dest] = torch.where(ok[:, None], pts_s.to(torch.float32), SENTINEL)
    return tbl[:-1].reshape(table_size, cap * 4), _bucket_sums(ok, h_s, table_size)


def append_cell_table(tbl: torch.Tensor, cnt: torch.Tensor, pts: torch.Tensor,
                      mask: torch.Tensor, cell_size: float):
    """Append masked points (N, 4) to their buckets (overflow drops);
    returns (table, counts)."""
    table_size, cap = tbl.shape[0], tbl.shape[1] // 4
    h_s, pts_s, rank = _sorted_by_bucket(pts, mask, cell_size, table_size)
    row = cnt[torch.clamp(h_s, max=table_size - 1)] + rank
    ok = (h_s < table_size) & (row < cap)
    dest = torch.where(ok, h_s * cap + row, table_size * cap)
    flat = torch.cat([tbl.reshape(-1, 4), tbl.new_zeros(1, 4)])
    flat[dest] = torch.where(ok[:, None], pts_s.to(torch.float32), SENTINEL)
    return flat[:-1].reshape(table_size, cap * 4), cnt + _bucket_sums(ok, h_s, table_size)


def _offsets(device) -> torch.Tensor:
    """The 3x3x3 neighbourhood offsets (27, 3), in the reference's order."""
    r = torch.arange(-1, 2, device=device)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)


def cell_knn(query: torch.Tensor, tbl: torch.Tensor, cell_size: float, k: int):
    """k nearest of ``query`` (M, 3) within the 3x3x3 cell neighbourhood,
    exactly (the reference's ``exact=True``, its only branch off the TPU).

    Returns (d2 (M, k), nbr (M, k, 3)).  Neighbours farther than cell_size
    may be reported with their true distance or missed entirely (d2 =
    huge); callers must gate at d2 < cell_size**2, as the mapping fits
    already do (laser_mapping.cpp:557,642)."""
    table_size, cap = tbl.shape[0], tbl.shape[1] // 4
    m = query.shape[0]
    hs = cell_hash(_cells(query, cell_size)[:, None, :] + _offsets(query.device)[None],
                   table_size)                                        # (M, 27)
    # Mask buckets already visited by an earlier neighbour offset (a hash
    # collision among the 27) so no candidate is counted twice.
    earlier = torch.triu(torch.ones(27, 27, dtype=torch.bool, device=query.device), diagonal=1)
    dup = torch.any((hs[:, :, None] == hs[:, None, :]) & earlier[None], dim=1)   # (M, 27)
    cand = tbl[hs.reshape(-1)].reshape(m, 27, cap, 4)
    diff = cand[..., :3] - query[:, None, None, :3]
    d2 = (diff * diff).sum(dim=-1)                                    # (M, 27, cap)
    d2 = torch.where(dup[:, :, None], _INF, d2).reshape(m, 27 * cap)
    d2k, idx = torch.sort(d2, dim=1, stable=True)
    d2k, idx = d2k[:, :k], idx[:, :k]
    nbr = torch.take_along_dim(cand.reshape(m, 27 * cap, 4)[..., :3], idx[..., None], dim=1)
    return d2k, nbr
