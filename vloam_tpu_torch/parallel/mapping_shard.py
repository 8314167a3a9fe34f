"""Scan-to-map registration with the cube map sharded over the ranks of a
map mesh (port of ``vloam_tpu/parallel/mapping_shard.py``).

The reference system never had this (one process, one thread): the cube map
and its submap searches split over S ranks.

* Rank r owns the global cube slots [r * nc_local, (r + 1) * nc_local), a
  contiguous block.  The slot of a world cube is x + W y + W H z (each
  coordinate modulo the grid), so one z layer of cubes fills W H slots:
  at ``kitti_hdl64`` (21 x 21 x 11) a course that stays in one z layer lies
  in rank 0's block at every S <= 11, and the other ranks search empty
  windows.  The work spreads over the ranks only as far as the map spans
  the blocks (the reference lays the slots out the same way).
* Per frame and outer iteration, each rank runs the 5-NN of every query
  against its own slice of the window through the k-NN pair kernel
  (``ops/fused_knn.knn_pair``, B1), with its own dynamic counts, the queries
  in Morton order and the search radius: the code is ``mapping_step``'s,
  run on the rank's block.  Then the ranks merge their candidates into the
  global top 5 (``_merge_topk``), and the line and plane fits and the GN
  solve (``ops/fused_gn.solve_pose_gn_lidar``, B3) run replicated.
* Every rank's search is rebased to the centre of the whole window's box,
  the single-device search's centre (``_window_box``): the k-NN rebases to
  the centre of its masked candidates' box, so a rank that rebased to the
  centre of its own slice would round the differences of a pair otherwise,
  and a near tie between two candidates could then go the other way than
  in the single step.  With the shared centre a pair's d2 is the single
  step's bit for bit.
* The merge is a butterfly for power-of-two S: log2(S) rounds, each
  swapping an (M, k, 4) packet of neighbour [x y z d2] with rank ^ step and
  keeping the k nearest of the 2k.  Other S gather every rank's packet.
  S = 1 merges nothing.
* Insertion and the compacted-submap cache are shard-local: each rank keeps
  the points whose slot it owns and caches its slice of the window,
  rebuilding it only when the window's centre cube changes.

Every rank must take the same host branches, or the ranks wait on each other
at the next collective.  There are two: whether the map holds enough points
to register against (from the counts summed over the ranks) and whether the
cache must be rebuilt (from the window centre, rank 0's broadcast to all).
Both come from values that are the same on every rank.  The merge joins the
packets in rank order, so where the ranks' inputs agree bit for bit (on the
CPU, and on a card whose kernels sum in a fixed order) the merged
neighbours, the fits and the pose do too; the reference's merge puts a
rank's own packet first, which differs from this one only at d2 ties
between shards, +inf slots included.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from vloam_tpu_torch.config import VloamConfig
from vloam_tpu_torch.models.laser_mapping import MapState, _gather_submap, mapping_step
from vloam_tpu_torch.parallel.mesh import (MapMesh, all_gather, axis_index, axis_size, broadcast,
                                           ppermute_xor, psum)

MAP_SHARDED_FIELDS = (
    "cube_pts", "corner_cnt", "surf_cnt", "cube_coord",
    "sub_c", "sub_c_n", "sub_s", "sub_s_n",
)

# bytes the merge's collectives delivered to this rank (ppermute packets, all_gather outputs)
MERGE_BYTES = 0


class ShardContext(NamedTuple):
    """What ``mapping_step`` needs to run as one rank of the sharded step."""
    slot_offset: int                  # the first global slot this rank owns
    centre: Callable                  # (3,) window centre -> rank 0's, on every rank
    total: Callable                   # counts -> their sum over the ranks
    merge: Callable                   # (nbr (M, k, 3), d2 (M, k)) -> the global top k
    window_box: Callable              # (cand, mask) problems -> the same with the window's box


def shard_context(state: MapState, cfg: VloamConfig, mesh: MapMesh) -> ShardContext:
    """The context of this rank of ``mesh``, whose block ``state`` is."""
    k = cfg.mapping.n_neighbors

    def merge(nbr, d2):
        return _merge_topk(torch.cat([nbr, d2[..., None]], dim=-1), k, mesh)

    return ShardContext(slot_offset=axis_index(mesh) * state.corner_cnt.shape[0],
                        centre=lambda c: broadcast(c, mesh), total=lambda x: psum(x, mesh),
                        merge=merge, window_box=lambda *p: _window_box(p, mesh))


def _window_box(problems, mesh: MapMesh):
    """Each k-NN problem's candidates ``(cand (N, 3), mask (N,))`` with two
    rows appended: the lower and upper corners of the box of every rank's
    masked rows (a minimum and a maximum over the ranks, exact), masked in.
    The k-NN rebases to the centre of its masked rows' box, those past the
    candidate count included, and never lets a row past the count enter: so
    with the two rows at N and N + 1 and the count at most N, every rank
    rebases to the whole window's centre and finds what it found before.
    One all-gather for all the problems."""
    lo = torch.stack([torch.where(m[:, None], c, torch.inf).amin(dim=0) for c, m in problems])
    hi = torch.stack([torch.where(m[:, None], c, -torch.inf).amax(dim=0) for c, m in problems])
    box = all_gather(torch.stack([lo, -hi]), mesh).amin(dim=0)        # (2, problems, 3)
    return tuple((torch.cat([c, torch.stack([box[0, p], -box[1, p]]).to(c.dtype)]),
                  torch.cat([m, m.new_ones(2)]))
                 for p, (c, m) in enumerate(problems))


def _local_window(state: MapState, coords, cfg: VloamConfig, mesh: MapMesh):
    """This shard's part of the submap window: ((corner pts, mask), (surf
    pts, mask), local slots), the local slot of a cube another shard owns
    being n_cubes_local (out of range: dropped)."""
    nc_local = state.corner_cnt.shape[0]
    c, s, slots, _ = _gather_submap(state, coords, cfg, slot_offset=axis_index(mesh) * nc_local)
    return c, s, slots


def _topk_rows(both: torch.Tensor, k: int) -> torch.Tensor:
    """The k rows of (M, n, 4) with the least d2 (column 3), ties to the
    lower row, as ``lax.top_k(-d2, k)`` selects them."""
    sel = torch.sort(both[..., 3], dim=1, stable=True).indices[:, :k]
    return torch.take_along_dim(both, sel[..., None], dim=1)


def _merge_topk(packed: torch.Tensor, k: int, mesh: MapMesh):
    """All-reduce the shards' k-NN candidates to the global top k.

    ``packed``: (M, k, 4) local neighbour rows [x y z d2].  Power-of-two S:
    an XOR butterfly, log2(S) rounds, each merging the partner's packet;
    other S: one all-gather of every packet.  Packets are joined in rank
    order, so every rank ends with the same rows in the same order.
    Returns (nbr (M, k, 3), d2 (M, k))."""
    global MERGE_BYTES
    S = axis_size(mesh)
    m = packed.shape[0]
    if S > 1 and (S & (S - 1)) == 0:
        step = 1
        while step < S:
            other = ppermute_xor(packed, step, mesh)
            MERGE_BYTES += other.numel() * other.element_size()
            lower_first = (axis_index(mesh) & step) == 0
            packed = _topk_rows(torch.cat([packed, other] if lower_first else [other, packed],
                                          dim=1), k)
            step *= 2
    elif S > 1:
        allp = all_gather(packed, mesh)                          # (S, M, k, 4)
        MERGE_BYTES += allp.numel() * allp.element_size()
        packed = _topk_rows(allp.permute(1, 0, 2, 3).reshape(m, S * k, 4), k)
    return packed[..., :3], packed[..., 3]


def merge_payload_bytes(S: int, m: int, k: int) -> int:
    """Bytes the collectives of one ``_merge_topk`` call deliver to a rank,
    for the scheme used at shard count S (butterfly or all-gather)."""
    if S <= 1:
        return 0
    pkt = m * k * 4 * 4
    if (S & (S - 1)) == 0:
        return pkt * (S.bit_length() - 1)        # log2(S) rounds of one packet
    return pkt * S                               # the all-gather's S packets


def sharded_mapping_step(state: MapState, corner_in, corner_in_mask, surf_in, surf_in_mask,
                         pose_wodom, cfg: VloamConfig, mesh: MapMesh):
    """The SPMD twin of ``models/laser_mapping.mapping_step``, run on every
    rank of ``mesh``: ``state`` is this rank's block (``mesh.shard_map_state``),
    the feature clouds and the pose are the same on every rank.  It is
    ``mapping_step`` itself with the shard's slot offset, rank 0's window
    centre, the counts summed over the ranks, the searches rebased to the
    whole window's box centre and ``_merge_topk`` after each search.
    Returns (new state block, world pose after mapping), the pose the same
    on every rank up to the rounding of the card's float atomics."""
    return mapping_step(state, corner_in, corner_in_mask, surf_in, surf_in_mask, pose_wodom, cfg,
                        shard=shard_context(state, cfg, mesh))


def map_state_specs() -> MapState:
    """Per field of a MapState, "sharded" (split over the ranks: the cube
    slots and the per-shard submap cache) or "replicated"."""
    return MapState(**{f: "sharded" if f in MAP_SHARDED_FIELDS else "replicated"
                       for f in MapState._fields})


def make_sharded_step(cfg: VloamConfig, mesh: MapMesh):
    """(state block, corner, cmask, surf, smask, pose_wodom) -> (state block,
    pose_w) on this rank of ``mesh`` (the state from ``init_map_state(cfg,
    device, n_shards=S)`` through ``mesh.shard_map_state``)."""

    def step(state, corner_in, cmask, surf_in, smask, pose_wodom):
        return sharded_mapping_step(state, corner_in, cmask, surf_in, smask, pose_wodom, cfg,
                                    mesh)

    return step
