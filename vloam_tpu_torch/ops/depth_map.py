"""Lidar-to-camera depth association, query side (port of
``vloam_tpu/ops/depth_map.py``).

The host data layer (``data/gridding.depth_buckets``) averages the
projected cloud into a 5 px bucket grid; ``query_depth`` answers
per-keypoint depth queries with an inverse-distance-weighted 3-NN over the
5x5 bucket neighbourhood, requiring >= 10 occupied neighbours and a 3-NN
depth spread within ``depth_spread_gate`` (point_cloud_util.cpp:381-487).

The device-side projection and bucket build (``project_cloud``,
``build_buckets``, the raw-cloud path) are not ported (ROADMAP A9).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vloam_tpu_torch.config import VisualConfig
from vloam_tpu_torch.ops.voxel import div_exact

FAR = 3.4e38  # distance of an unoccupied neighbour


class DepthBuckets(NamedTuple):
    u: torch.Tensor       # (BW, BH) mean pixel x per bucket
    v: torch.Tensor       # (BW, BH) mean pixel y
    z: torch.Tensor       # (BW, BH) mean depth
    count: torch.Tensor   # (BW, BH) hits


def bucket_shape(cfg: VisualConfig) -> tuple[int, int]:
    g = cfg.downsample_grid
    return (-(-cfg.img_width // g), -(-cfg.img_height // g))


def query_depth(buckets: DepthBuckets, pts: torch.Tensor, cfg: VisualConfig) -> torch.Tensor:
    """Per-keypoint depth (N,), or -1 where the query fails."""
    bw, bh = buckets.u.shape
    rr = cfg.query_radius
    dev = pts.device
    d = torch.arange(-rr, rr + 1, device=dev)
    oy, ox = torch.meshgrid(d, d, indexing="ij")
    ox, oy = ox.reshape(-1), oy.reshape(-1)                     # (25,) (dx, dy)
    planes = torch.stack([buckets.u, buckets.v, buckets.z, buckets.count], dim=-1)

    # int32 truncation of a true f32 division (CUDA would turn a division by
    # the host scalar g into a reciprocal multiply and move bucket edges)
    ix = div_exact(pts[:, 0], cfg.downsample_grid).to(torch.int32)
    iy = div_exact(pts[:, 1], cfg.downsample_grid).to(torch.int32)
    nx = ix[:, None] + ox
    ny = iy[:, None] + oy
    inside = (nx >= 0) & (nx < bw) & (ny >= 0) & (ny < bh)
    vals = planes[torch.clamp(nx, 0, bw - 1), torch.clamp(ny, 0, bh - 1)]   # (N, 25, 4)
    bu, bv, bz, cnt = vals.unbind(-1)
    occ = inside & (cnt > 0)
    dist = torch.sqrt((pts[:, 0:1] - bu) ** 2 + (pts[:, 1:2] - bv) ** 2)
    dist = torch.where(occ, dist, FAR)
    # k smallest, ties to the lower neighbour index (lax.top_k's order)
    d_sorted, idx = torch.sort(dist, dim=-1, stable=True)
    d0, d1, d2 = d_sorted[:, 0], d_sorted[:, 1], d_sorted[:, 2]
    z3 = torch.gather(bz, 1, idx[:, :cfg.depth_knn])
    # weighted 3-NN: z = sum_i z_i prod_{j != i} d_j / (eps + sum_i prod_{j != i} d_j)
    num = z3[:, 0] * d1 * d2 + z3[:, 1] * d0 * d2 + z3[:, 2] * d0 * d1
    den = 1e-4 + d1 * d2 + d0 * d2 + d0 * d1
    z = num / den
    enough = occ.sum(dim=-1) >= cfg.min_depth_neighbors
    if cfg.depth_spread_gate > 0:
        # drop queries straddling a depth discontinuity
        enough = enough & (torch.amax(z3, dim=-1) - torch.amin(z3, dim=-1) <= cfg.depth_spread_gate)
    return torch.where(enough, z, -1.0)
