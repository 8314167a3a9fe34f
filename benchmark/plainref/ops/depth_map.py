"""Lidar-to-camera depth association (port of ``vloam_tpu/ops/depth_map.py``).

The projected cloud is averaged into a 5 px bucket grid, on the host
(``data/gridding.depth_buckets``, the main path) or on the device
(``project_cloud`` + ``build_buckets``, when VO is given no buckets);
``query_depth`` answers per-keypoint depth queries with an
inverse-distance-weighted 3-NN over the 5x5 bucket neighbourhood, requiring
>= 10 occupied neighbours and a 3-NN depth spread within
``depth_spread_gate`` (point_cloud_util.cpp:381-487).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from plainref.config import VisualConfig
from plainref.ops.voxel import div_exact

FAR = 3.4e38  # distance of an unoccupied neighbour


class DepthBuckets(NamedTuple):
    u: torch.Tensor       # (BW, BH) mean pixel x per bucket
    v: torch.Tensor       # (BW, BH) mean pixel y
    z: torch.Tensor       # (BW, BH) mean depth
    count: torch.Tensor   # (BW, BH) hits


def bucket_shape(cfg: VisualConfig) -> tuple[int, int]:
    g = cfg.downsample_grid
    return (-(-cfg.img_width // g), -(-cfg.img_height // g))


def project_cloud(points: torch.Tensor, mask: torch.Tensor, proj: torch.Tensor,
                  cfg: VisualConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Velodyne cloud (N, 3) -> image-plane (u, v, depth) (N, 3) and its
    validity (in front of the camera), through proj = P_rect0 R_rect0
    cam_T_velo (3, 4)."""
    ph = torch.cat([points, torch.ones_like(points[:, :1])], dim=1)
    uvz = ph @ proj.T
    z = uvz[:, 2]
    ok = mask & (z > cfg.min_projection_depth)
    uv = uvz[:, :2] / torch.clamp(z[:, None], min=1e-6)
    return torch.cat([uv, z[:, None]], dim=1), ok


def build_buckets(uvz: torch.Tensor, mask: torch.Tensor, cfg: VisualConfig) -> DepthBuckets:
    """Average the projected points into the (W/g, H/g) bucket grid (exact
    means; the reference's incremental form forgets a bucket's first hit)."""
    bw, bh = bucket_shape(cfg)
    g = cfg.downsample_grid
    nb = bw * bh
    # int32 truncation of a true f32 division, as in query_depth
    ix = div_exact(uvz[:, 0], g).to(torch.int32)
    iy = div_exact(uvz[:, 1], g).to(torch.int32)
    ok = (mask & (ix >= 0) & (ix < bw) & (iy >= 0) & (iy < bh)
          & (uvz[:, 0] >= 0) & (uvz[:, 1] >= 0))
    flat = torch.where(ok, ix.to(torch.int64) * bh + iy, nb)
    # the rejects land on a scrap row; float atomics on CUDA (the sums' order
    # varies from run to run; the counts are exact)
    aug = torch.where(ok[:, None], torch.cat([uvz, torch.ones_like(uvz[:, :1])], dim=1), 0.0)
    sums = torch.zeros((nb + 1, 4), dtype=uvz.dtype, device=uvz.device).index_add_(0, flat, aug)
    cnt = sums[:nb, 3]
    means = sums[:nb, :3] / torch.clamp(cnt[:, None], min=1.0)
    return DepthBuckets(u=means[:, 0].reshape(bw, bh), v=means[:, 1].reshape(bw, bh),
                        z=means[:, 2].reshape(bw, bh), count=cnt.reshape(bw, bh))


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
