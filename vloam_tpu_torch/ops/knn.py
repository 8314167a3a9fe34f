"""Exact nearest-neighbour search and its helpers (port of the parts of
``vloam_tpu/ops/knn.py`` the lidar path uses).

``knn`` solves one k-NN problem: for CUDA tensors it launches the CUDA kernel
``csrc/knn.cu`` (the counterpart of ``vloam_tpu/ops/pallas_knn.knn_lanemin``)
and for CPU tensors it uses the plain PyTorch version ``knn_reference``; it
never falls back from one to the other.  ``nn1`` is its k = 1 form.  The
two-problem launch is ``ops/fused_knn.knn_pair``; all of them follow one
contract, which differs from the reference's ``knn`` on purpose, in three
ways:

* distances are in difference form, (qx-cx)^2 + (qy-cy)^2 + (qz-cz)^2, after
  rebasing both sets to the centre of the masked candidates' bounding box
  (rows at or past ``cand_count`` included)
  (the reference's CPU path uses the matmul form q^2 + c^2 - 2 q.c, which at
  +-60 m differs by ~1e-3 m^2 and can swap near-tied neighbours);
* masked candidates and unfilled slots are +inf (the reference: 3.4e38, and
  NaN from its TPU kernel for queries past the count), and an unfilled
  slot's index is 0, so callers may gather with it;
* the dynamic valid counts are honoured: candidates at or past
  ``cand_count`` never enter, and queries at or past ``query_count`` return
  +inf everywhere (the reference's CPU path ignores both counts).

The search is exact (the TPU kernel keeps one neighbour per lane class) and
ties go to the lower candidate index.

``knn_pair`` also takes a search radius per problem (the reference's
``prune_radius``).  The reference leaves open whether a neighbour beyond the
radius is reported; here the rule is fixed (``clamp_radius``): every slot
whose d2 exceeds ``float32(r) ** 2`` is +inf with index 0, whatever the
kernel skipped and whatever the row order.  ``morton_sort`` gives the row
order that makes the kernel's box pruning pay.
"""

from __future__ import annotations

import numpy as np
import torch

from vloam_tpu_torch import kernels
from vloam_tpu_torch.ops.voxel import div_exact

LAUNCHES = 0  # wrapper calls of knn / nn1 that launched (plain-version calls do not count)

MAX_K = 128  # the range of the kernel it replaces (knn_lanemin)
REG_K = (1, 5, 8, 16)  # the k with a register list and a split sweep in knn.cu

# How many candidate splits a sweep gets (csrc/knn_common.cuh).  Without a
# radius: enough (query tile, split) blocks to fill the card's 132 SMs four
# times over, but no more than MAX_SPLITS, since every split warms up a list
# of its own and the merge reads them all.  With a radius most blocks return
# at once and the work sits where the surviving tiles lie, so the splits are
# as fine as MIN_SPLIT_ROWS allows.
TILE_Q = 256            # kTileQ: queries per sweep block
TARGET_BLOCKS = 4 * 132
MIN_SPLIT_ROWS = 512    # two candidate tiles
MAX_SPLITS = 32
MAX_SPLITS_PRUNED = 128
# A search without a radius over PILOT_MIN_ROWS candidates or more first runs
# a pilot over every PILOT_STEP-th row, which bounds each query's k-th
# distance from above: the sweep's lists then start out rejecting all but
# about k * ln(k) * PILOT_STEP candidates instead of warming up from +inf in
# every split.  (On the frame step's LO call, H100: 0.21 ms without it, 0.20, 0.19,
# 0.17 and 0.16 ms with steps 16, 8, 4 and 2; the pilot itself costs 1 / step
# of the sweep's distances.)
PILOT_STEP = 4
PILOT_MIN_ROWS = 4096

_INF = 3.4e38  # masked_argmin sentinel (finite, as in the reference)
_INF_KEY = 0x7F800000 << 32  # sort key of d2 = +inf (f32 bits of inf, index 0)


def center_of(cand: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Centre of the valid candidates' axis-aligned bounding box ((3,); 0 when
    no candidate is valid)."""
    lo = torch.where(mask[:, None], cand, torch.inf).amin(dim=0)
    hi = torch.where(mask[:, None], cand, -torch.inf).amax(dim=0)
    return torch.where(torch.isfinite(lo), 0.5 * (lo + hi), 0.0)


def as_count(count, total: int, device) -> torch.Tensor:
    """A valid-prefix length (None, int or 0-d tensor) as a 0-d int64 tensor
    in [0, total]; None means all ``total`` rows."""
    if count is None:
        return torch.full((), total, dtype=torch.int64, device=device)
    return torch.as_tensor(count, device=device).to(torch.int64).clamp(0, total)


def knn_splits(m: int, n: int, pruned: bool = False) -> int:
    """Candidate splits of an (m queries, n candidates) sweep."""
    by_rows = max(1, n // MIN_SPLIT_ROWS)
    if pruned:
        return min(MAX_SPLITS_PRUNED, by_rows)
    q_tiles = max(-(-m // TILE_Q), 1)
    return min(MAX_SPLITS, -(-TARGET_BLOCKS // q_tiles), by_rows)


def knn_plan(m: int, n: int, pruned: bool = False) -> tuple[int, int, int]:
    """(candidate splits, the pilot's row step or 0, the pilot's splits)."""
    splits = knn_splits(m, n, pruned)
    if pruned or n < PILOT_MIN_ROWS:
        return splits, 0, 0
    return splits, PILOT_STEP, knn_splits(m, -(-n // PILOT_STEP))


def count_arg(count, total: int, device):
    """A valid-prefix length as the kernels take it: (device int64 tensor or
    None, host int used when the tensor is None).  The kernels clamp."""
    if count is None:
        return None, total
    if isinstance(count, torch.Tensor):
        return count.to(device=device, dtype=torch.int64), 0
    return None, min(max(int(count), 0), total)


def problem_args(query, cand, mask, k: int, query_count, cand_count):
    """One problem as the C entries take it.  Returns (the leading arguments
    (q, q_stride, c, c_stride, mask, q_count, q_count_host, c_count,
    c_count_host, m, n, k), the tensors they point into).  The caller holds
    on to the tensors until its launches are enqueued."""
    dev = query.device
    m, n = query.shape[0], cand.shape[0]
    (query, q_stride), (cand, c_stride), mask = rows_arg(query), rows_arg(cand), mask.contiguous()
    q_n, q_host = count_arg(query_count, m, dev)
    c_n, c_host = count_arg(cand_count, n, dev)
    args = (query.data_ptr(), q_stride, cand.data_ptr(), c_stride, mask.data_ptr(),
            None if q_n is None else q_n.data_ptr(), q_host,
            None if c_n is None else c_n.data_ptr(), c_host, m, n, k)
    return args, (query, cand, mask, q_n, c_n)


def rows_arg(x: torch.Tensor):
    """(M, 3) points as the kernels read them: (float32 tensor with unit
    column stride, floats between rows).  A column slice of a wider buffer
    passes as it is."""
    x = x.to(torch.float32)
    if x.stride(1) != 1 or x.stride(0) < 3:
        x = x.contiguous()
    return x, x.stride(0)


def radius_sq(r: float) -> float:
    """float32(r) ** 2, the bound a search radius puts on d2."""
    return float(np.float32(r) * np.float32(r))


def clamp_radius(d2: torch.Tensor, idx: torch.Tensor, r):
    """The radius rule: slots with d2 > float32(r)^2 become +inf, index 0."""
    if r is None:
        return d2, idx
    far = d2 > radius_sq(r)
    return torch.where(far, torch.inf, d2), torch.where(far, 0, idx)


def _part1by2(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so they occupy every third bit."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_keys(pts: torch.Tensor, cell: float, origin=0.0) -> torch.Tensor:
    """(N, 3+) -> (N,) int32 Morton (Z-order) keys at ``cell`` resolution.
    Coordinates are binned relative to ``origin`` with a +512-cell offset and
    clipped to 10 bits an axis; far outliers collapse onto the boundary
    cells, which costs pruning efficiency, never correctness."""
    g = torch.floor(div_exact(pts[:, :3] - origin, cell)).to(torch.int32) + 512
    g = torch.clamp(g, 0, 1023)
    return _part1by2(g[:, 0]) | (_part1by2(g[:, 1]) << 1) | (_part1by2(g[:, 2]) << 2)


def morton_order(pts: torch.Tensor, mask: torch.Tensor, cell: float, origin=0.0) -> torch.Tensor:
    """The permutation that puts a point buffer into Morton order: a stable
    sort of the keys, invalid rows last (a prefix mask stays a prefix mask)."""
    key = torch.where(mask, morton_keys(pts, cell, origin), 2**31 - 1)
    return torch.sort(key, stable=True).indices


def morton_sort(pts: torch.Tensor, mask: torch.Tensor, cell: float, origin=0.0):
    """Sort a point buffer into Morton order: consecutive rows become
    spatial neighbours, so a tile of rows has a small bounding box.
    Returns (points, mask)."""
    order = morton_order(pts, mask, cell, origin)
    return pts[order], mask[order]


def knn_reference(
    query: torch.Tensor,       # (M, 3)
    cand: torch.Tensor,        # (N, 3)
    cand_mask: torch.Tensor,   # (N,) bool
    k: int,
    cand_count=None,           # () valid-prefix length of cand
    query_count=None,          # () valid-prefix length of query
    block: int = 4096,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``knn``: (d2 (M, k) f32, idx (M, k) int64).

    Blocked over the candidate axis with a running top-k merge.  Exact ties
    are broken by index: each distance is keyed as the int64
    ``(float bits << 32) | index`` (non-negative floats order like their
    bits), so one top-k over keys orders by (d2, index)."""
    m, n = query.shape[0], cand.shape[0]
    dev = query.device
    c_n = as_count(cand_count, n, dev)
    q_n = as_count(query_count, m, dev)
    valid = cand_mask & (torch.arange(n, device=dev) < c_n)
    cen = center_of(cand, cand_mask)
    qc = query - cen
    cc = cand - cen

    best = torch.full((m, k), _INF_KEY, dtype=torch.int64, device=dev)
    for s in range(0, n, block):
        e = min(s + block, n)
        dx = qc[:, 0:1] - cc[None, s:e, 0]
        dy = qc[:, 1:2] - cc[None, s:e, 1]
        dz = qc[:, 2:3] - cc[None, s:e, 2]
        d2 = dx * dx + dy * dy + dz * dz
        d2 = torch.where(valid[None, s:e], d2, torch.inf)
        keys = (d2.view(torch.int32).to(torch.int64) << 32) | torch.arange(
            s, e, dtype=torch.int64, device=dev)[None, :]
        kb = min(k, e - s)
        blk = torch.topk(keys, kb, dim=1, largest=False, sorted=True).values
        best = torch.topk(torch.cat([best, blk], dim=1), k, dim=1,
                          largest=False, sorted=True).values

    d2 = (best >> 32).to(torch.int32).view(torch.float32)
    idx = best & 0xFFFFFFFF
    live = (torch.arange(m, device=dev) < q_n)[:, None] & torch.isfinite(d2)
    return torch.where(live, d2, torch.inf), torch.where(live, idx, 0)


def knn(
    query: torch.Tensor,       # (M, 3)
    cand: torch.Tensor,        # (N, 3)
    cand_mask: torch.Tensor,   # (N,) bool
    k: int,
    cand_count=None,           # () valid-prefix length of cand
    query_count=None,          # () valid-prefix length of query
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest candidates per query: (d2 (M, k) f32, idx (M, k) int64).
    The counts are dynamic valid-prefix lengths (0-d tensors, ints or None),
    read on the device."""
    global LAUNCHES
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn: k = {k} outside [1, {MAX_K}]")
    if query.device.type == "cpu":
        return knn_reference(query, cand, cand_mask, k, cand_count, query_count)
    kernels.require_cuda("knn", query, cand, cand_mask)
    if cand_mask.dtype != torch.bool:
        raise ValueError("knn: the mask must be bool")
    if query.shape[1:] != (3,) or cand.shape[1:] != (3,) or cand_mask.shape != cand.shape[:1]:
        raise ValueError(f"knn: shapes {tuple(query.shape)}, {tuple(cand.shape)}, "
                         f"{tuple(cand_mask.shape)}; want (M, 3), (N, 3), (N,)")
    dev = query.device
    m, n = query.shape[0], cand.shape[0]
    args, alive = problem_args(query, cand, cand_mask, k, query_count, cand_count)
    plan = knn_plan(m, n) if k in REG_K else (1, 0, 0)
    lib = kernels.lib()
    scratch = torch.empty((lib.vloam_knn_scratch_bytes(m, n, k, *plan),), dtype=torch.uint8,
                          device=dev)
    d2 = torch.empty((m, k), dtype=torch.float32, device=dev)
    idx = torch.empty((m, k), dtype=torch.int64, device=dev)
    rc = lib.vloam_knn(*args, *plan, d2.data_ptr(), idx.data_ptr(), scratch.data_ptr(),
                       kernels.stream_ptr(dev))
    del alive   # the inputs as the kernels read them, held until here
    kernels.check(rc, "knn")
    LAUNCHES += 1
    return d2, idx


def nn1_reference(query, cand, cand_mask, cand_count=None, query_count=None):
    """Plain PyTorch version of ``nn1``."""
    d2, idx = knn_reference(query, cand, cand_mask, 1, cand_count, query_count)
    return d2[:, 0], idx[:, 0]


def nn1(query, cand, cand_mask, cand_count=None, query_count=None):
    """Single nearest neighbour: (d2 (M,), idx (M,)), column 0 of ``knn``."""
    d2, idx = knn(query, cand, cand_mask, 1, cand_count, query_count)
    return d2[:, 0], idx[:, 0]


def masked_argmin(d2: torch.Tensor, valid: torch.Tensor):
    """Argmin along the last axis under a mask; returns (min, argmin).
    Masked entries count as 3.4e38; ties go to the first index."""
    d2m = torch.where(valid, d2, _INF)
    idx = torch.argmin(d2m, dim=-1)
    return torch.gather(d2m, -1, idx[..., None])[..., 0], idx


def compact_rows(pts: torch.Tensor, counts: torch.Tensor, out_cap: int):
    """Concatenate per-group valid prefixes into one dense (out_cap, D)
    buffer: destination row = exclusive-cumsum offset + rank.

    pts: (C, cap, D); counts: (C,).  Returns (out (out_cap, D), mask)."""
    C, cap, D = pts.shape
    dev = pts.device
    offs = torch.cumsum(counts, 0) - counts
    col = torch.arange(cap, device=dev)[None, :]
    dest = offs[:, None] + col
    ok = (col < counts[:, None]) & (dest < out_cap)
    # rejects land on one scrap row past the end (the reference's mode="drop")
    dest = torch.where(ok, dest, out_cap).reshape(-1)
    out = torch.zeros((out_cap + 1, D), dtype=pts.dtype, device=dev)
    out.index_put_((dest,), torch.where(ok.reshape(-1)[:, None], pts.reshape(-1, D), 0.0))
    total = torch.clamp(counts.sum(), max=out_cap)
    return out[:out_cap], torch.arange(out_cap, device=dev) < total
